// Fused tower block of the spectral towers (HartleyMHASeg serving, and
// NeuralOperatorSeg with tower_kernel="block"), z read from a tensor.
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/tower_block.py
//   fused_tower_block (pallas_call in _run_tower_kernel, tower_block.py:377,
//   body _tower_kernel).
//
// The block body, its design and its arithmetic are in tower_block.cuh;
// here each block reads its plane's z rows (D, 2, C, KH, KW) from device
// memory, and a second kernel sums the tiles' partial spectra in tile
// order into f (D, 2, C, KH, KW). Hartley and Fourier differ only in the
// stage matrices; Fourier's KW = mw may be odd, and then the z rows are not
// 8-byte aligned and are read one value at a time.
//
// What bounds it on an H100: the operations. At HartleyMHASeg's serving
// size (grid 121 x 121 x 78, C 24, KH = KW = 24, 4 ds rows) a call does
// 47.6 M MACs per plane, 11.5 GFLOP, 0.172 ms at 67 TFLOP/s fp32, against
// 282.6 MB of volume, spectra and ds traffic, 0.084 ms at 3.35 TB/s.
// At 121 KB of shared memory (modes (10, 14, 14), C 24) one block fits an
// SM; at 109 KB (modes (8, 12, 12)) two do (chip_smoke.py prints both).
#include "tower_block.cuh"

namespace {

// Adds one z value pair (a = re, b = im of column j) to the inverse W stage
// of the tile's kTW columns; cwi_j, swi_j: row j of the tile's Cwi, Swi.
__device__ __forceinline__ void w_inverse_add(float a, float b,
                                              const float* cwi_j,
                                              const float* swi_j,
                                              float (&re)[kTW],
                                              float (&im)[kTW]) {
  const float4* cs4 = reinterpret_cast<const float4*>(cwi_j);
  const float4* sn4 = reinterpret_cast<const float4*>(swi_j);
#pragma unroll
  for (int q = 0; q < kTW / 4; ++q) {
    const float4 cs = cs4[q], sn = sn4[q];
    const float cv[4] = {cs.x, cs.y, cs.z, cs.w};
    const float sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      re[4 * q + u] = fmaf(a, cv[u], fmaf(-b, sv[u], re[4 * q + u]));
      im[4 * q + u] = fmaf(a, sv[u], fmaf(b, cv[u], im[4 * q + u]));
    }
  }
}

// Plane d's z, read from the z tensor: one z row (c, k) per thread, all
// kTW columns at once.
struct ZFromTensor {
  const float* zd;  // z[d]: (2, C, KH, KW)
  int C, KH, KW;

  __device__ __forceinline__ void row(int c, int k, const float* cwi_s,
                                      const float* swi_s, float (&re)[kTW],
                                      float (&im)[kTW]) const {
    const float* zr = zd + (size_t)(c * KH + k) * KW;
    const float* zi = zr + (size_t)C * KH * KW;
    if ((KW & 1) == 0) {
#pragma unroll 2
      for (int j2 = 0; j2 < KW; j2 += 2) {
        const float2 a2 = __ldg(reinterpret_cast<const float2*>(zr + j2));
        const float2 b2 = __ldg(reinterpret_cast<const float2*>(zi + j2));
        w_inverse_add(a2.x, b2.x, cwi_s + j2 * kTW, swi_s + j2 * kTW, re,
                      im);
        w_inverse_add(a2.y, b2.y, cwi_s + (j2 + 1) * kTW,
                      swi_s + (j2 + 1) * kTW, re, im);
      }
    } else {  // odd KW: rows start at odd offsets
      for (int j = 0; j < KW; ++j)
        w_inverse_add(__ldg(zr + j), __ldg(zi + j), cwi_s + j * kTW,
                      swi_s + j * kTW, re, im);
    }
  }

  template <int>
  __device__ __forceinline__ void fill_y(float* y_s, int ny,
                                         const float* cwi_s,
                                         const float* swi_s, float*) const {
    for (int e = threadIdx.x; e < C * KH; e += kThreads) {
      const int c = e % C, k = e / C;
      float re[kTW], im[kTW];
#pragma unroll
      for (int w = 0; w < kTW; ++w) re[w] = im[w] = 0.f;
      row(c, k, cwi_s, swi_s, re, im);
#pragma unroll
      for (int w = 0; w < kTW; ++w) {
        y_s[(k * kTW + w) * C + c] = re[w];
        y_s[ny + (k * kTW + w) * C + c] = im[w];
      }
    }
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
tower_block_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ wcat,
                   const float* __restrict__ wcc,
                   const float* __restrict__ bias, Mats m,
                   const float* __restrict__ ds_prev,
                   float* __restrict__ out, float* __restrict__ partial,
                   float* __restrict__ ds_out, int H, int W, int KH, int KW,
                   int nds) {
  const ZFromTensor zsrc{z + (size_t)blockIdx.y * 2 * C * KH * KW, C, KH,
                         KW};
  tower_block_body<C, false>(zsrc, blockIdx.y, blockIdx.x, gridDim.x, true,
                             x, wcat, wcc, bias, m, ds_prev, out, partial,
                             ds_out, H, W, KH, KW, nds);
}

// f[d] = sum over the tiles of partial[d][tile], in tile order.
__global__ void tower_spectrum_sum(const float* __restrict__ partial,
                                   float* __restrict__ f, int n_tiles,
                                   long long per_plane, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long d = i / per_plane, e = i % per_plane;
  const float* p = partial + d * n_tiles * per_plane + e;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += p[t * per_plane];
  f[i] = s;
}

template <int C>
cudaError_t launch(const float* x, const float* z, const float* wcat,
                   const float* wcc, const float* bias, Mats m,
                   const float* ds_prev, float* out, float* f, float* ds,
                   float* partial, int D, int H, int W, int KH, int KW,
                   int nds, cudaStream_t stream) {
  const int n_tiles = (W + kTW - 1) / kTW;
  const size_t smem = sizeof(float) * smem_floats(C, KH, KW, nds);
  cudaError_t err = cudaFuncSetAttribute(
      tower_block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  tower_block_kernel<C><<<dim3(n_tiles, D), kThreads, smem, stream>>>(
      x, z, wcat, wcc, bias, m, ds_prev, out, partial, ds, H, W, KH, KW, nds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_plane = 2LL * C * KH * KW;
  const long long total = per_plane * D;
  const int threads = 256;
  tower_spectrum_sum<<<(unsigned)((total + threads - 1) / threads), threads,
                       0, stream>>>(partial, f, n_tiles, per_plane, total);
  return cudaGetLastError();
}

}  // namespace

// x, out: (D, H, W, c); z, f: (D, 2, c, kh, kw); wcat: (2c + nds, c) and
// wcc: (c, c), rows = outputs; bias: (2c,); mats: the stage matrices in the
// order of unpack_mats; ds_prev, ds: (D, H, W, nds) or null when nds == 0;
// partial: (D, ceil(W / 8), 2, c, kh, kw) scratch. fp32, contiguous.
M3SEG_API int m3seg_tower_block(const float* x, const float* z,
                                const float* wcat, const float* wcc,
                                const float* bias, const float* mats,
                                const float* ds_prev, float* out, float* f,
                                float* ds, float* partial, int D, int H,
                                int W, int c, int kh, int kw, int nds,
                                void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || kh <= 0 || kw <= 0 || nds < 0 ||
      nds > kMaxDs || (nds > 0 && (ds_prev == nullptr || ds == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Mats m = unpack_mats(mats, H, W, kh, kw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 8:
      return (int)launch<8>(x, z, wcat, wcc, bias, m, ds_prev, out, f, ds,
                            partial, D, H, W, kh, kw, nds, s);
    case 24:
      return (int)launch<24>(x, z, wcat, wcc, bias, m, ds_prev, out, f, ds,
                             partial, D, H, W, kh, kw, nds, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM and registers per thread of the c-channel instance
// at (kh, kw, nds); launches nothing.
M3SEG_API int m3seg_tower_block_occupancy(int c, int kh, int kw, int nds,
                                          int* blocks, int* regs) {
  const size_t smem = sizeof(float) * smem_floats(c, kh, kw, nds);
  switch (c) {
    case 8:
      return (int)kernel_occupancy(tower_block_kernel<8>, smem, blocks, regs);
    case 24:
      return (int)kernel_occupancy(tower_block_kernel<24>, smem, blocks, regs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
