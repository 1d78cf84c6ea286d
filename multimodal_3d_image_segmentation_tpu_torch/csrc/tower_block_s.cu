// Fused tower block on the resident packed spectrum: the depth stages run
// inside the kernel (NeuralOperatorSeg serving, HNOSeg and FNOSeg; and
// HartleyMHASeg with tower_kernel="block_s").
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/tower_block_s.py
//   fused_tower_block_s (pallas_call in _run_tower_kernel_s,
//   tower_block_s.py:332, body _tower_kernel_s).
//
// Computes, for every depth plane d of the tower grid (D, H, W), C channels,
// with sy and s_f the resident spectrum (KS, C, KH, KW) (Hartley: KS = KD,
// real; Fourier: KS = 2 KD, [re; im]) and the depth matrices mi, mf
// (D, 2, KS):
//   z[d] = sum_s mi[d, :, s] sy[s]        inverse depth stage, (2, C, KH, KW)
//   out[d], f[d] (, ds[d])                the block body (tower_block.cuh)
//   s_f  = sum_d sum_q mf[d, q, :] f[d, q]           forward depth stage
// so no z or f tensor crosses device memory: each block forms its plane's
// z from sy (read through L2: 1.5 MB at the serving shapes, shared by all
// blocks) in chunks of whole rows, with coalesced loads, into shared memory,
// and applies the inverse W stage to each chunk, one thread per (row,
// column). Two more kernels fold the blocks' partial spectra into s_f
// through the depth forward stage: the first sums a plane's tiles in tile
// order and accumulates the planes of one of kDepthGroups groups in plane
// order, the second sums the groups in group order. No atomics: the same
// bits from run to run. Only the D real planes enter the sums (the TPU
// kernel selects its padded planes away; here there are none).
//
// What bounds it on an H100: the operations. At HNOSeg's serving size
// (grid 121 x 121 x 78, C 24, modes (10, 14, 14): KS 20, KH = KW = 28, no
// ds rows) the block body does 53.4 M MACs per plane, 12.9 GFLOP per call,
// 0.19 ms at 67 TFLOP/s fp32, against 222 MB of volume traffic, 0.066 ms
// at 3.35 TB/s; the depth stages add 2 KS C KH KW MACs per plane each way
// (0.36 GFLOP per call). Every W tile of a plane forms the plane's z again
// (about 14% more MACs per block at that shape, and the whole spectrum read
// from L2 by every block, 1.8 GB per call); sharing z over a plane's tiles
// through a thread-block cluster is later work.
#include "tower_block.cuh"

namespace {

constexpr int kMaxKS = 64;       // spectrum rows a depth-pass thread holds
constexpr int kDepthGroups = 8;  // plane groups of the depth pass

// Inverse W stage of the z rows r0 .. r0 + nr - 1 (row r = c KH + k),
// held in shared memory as zre = zs[(r - r0) KW + j], zim = zs[chunk + ...],
// into the y tile: one thread per (row, column) output.
__device__ __forceinline__ void w_inverse_rows(
    const float* zs, int chunk, int r0, int nr, const float* cwi_s,
    const float* swi_s, float* y_s, int ny, int C, int KH, int KW) {
  for (int o = threadIdx.x; o < nr * kTW; o += kThreads) {
    const int rl = o / kTW, w = o % kTW;
    const int c = (r0 + rl) / KH, k = (r0 + rl) % KH;
    const float* za = zs + rl * KW;
    const float* zb = za + chunk;
    float re = 0.f, im = 0.f;
    for (int j = 0; j < KW; ++j) {
      const float a = za[j], b = zb[j];
      const float cv = cwi_s[j * kTW + w], sv = swi_s[j * kTW + w];
      re = fmaf(a, cv, fmaf(-b, sv, re));
      im = fmaf(a, sv, fmaf(b, cv, im));
    }
    y_s[(k * kTW + w) * C + c] = re;
    y_s[ny + (k * kTW + w) * C + c] = im;
  }
}

// Adds sum_s mi[d, :, s] sy[s] at the N4 x 4 consecutive values src[0..]
// of a chunk to za, zb: one 16-byte load per spectrum row and slot, all
// slots' loads in flight together.
template <int N4>
__device__ __forceinline__ void z_values_vec(const float* src,
                                             const float* mi, int KS, int ng,
                                             float (&za)[N4][4],
                                             float (&zb)[N4][4]) {
#pragma unroll 4
  for (int s = 0; s < KS; ++s) {
    const float* p = src + (size_t)s * ng;
    float4 q[N4];
#pragma unroll
    for (int n = 0; n < N4; ++n)
      q[n] = __ldg(reinterpret_cast<const float4*>(p + n * 4 * kThreads));
    const float m0 = __ldg(mi + s), m1 = __ldg(mi + KS + s);
#pragma unroll
    for (int n = 0; n < N4; ++n) {
      const float v[4] = {q[n].x, q[n].y, q[n].z, q[n].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        za[n][u] = fmaf(m0, v[u], za[n][u]);
        zb[n][u] = fmaf(m1, v[u], zb[n][u]);
      }
    }
  }
}

// The same with scalar loads, for a KW that is not a multiple of 4 (the
// values past ne stay zero).
template <int N4>
__device__ __forceinline__ void z_values_scalar(const float* src,
                                                const float* mi, int KS,
                                                int ng, int left,
                                                float (&za)[N4][4],
                                                float (&zb)[N4][4]) {
#pragma unroll 2
  for (int s = 0; s < KS; ++s) {
    const float* p = src + (size_t)s * ng;
    float v[N4][4];
#pragma unroll
    for (int n = 0; n < N4; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = n * 4 * kThreads + u;
        v[n][u] = i < left ? __ldg(p + i) : 0.f;
      }
    const float m0 = __ldg(mi + s), m1 = __ldg(mi + KS + s);
#pragma unroll
    for (int n = 0; n < N4; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        za[n][u] = fmaf(m0, v[n][u], za[n][u]);
        zb[n][u] = fmaf(m1, v[n][u], zb[n][u]);
      }
  }
}

// Plane d's z, formed from the resident spectrum chunk by chunk: a chunk
// is the whole rows (row r = c KH + k) of at most kTH kTW C / 2 values (the
// scratch holds its two components); each thread forms N4 = C / 8 slots of
// four consecutive values, z = sum_s mi[d, :, s] sy[s].
struct ZFromSpectrum {
  const float* sy;  // (KS, C, KH, KW)
  const float* mi;  // mi[d]: (2, KS)
  int KS, C, KH, KW;

  template <int CC>
  __device__ __forceinline__ void fill_y(float* y_s, int ny,
                                         const float* cwi_s,
                                         const float* swi_s,
                                         float* zs) const {
    constexpr int N4 = CC / 8, chunk = 4 * N4 * kThreads;
    const int ng = CC * KH * KW;  // the stride of a spectrum row
    const int rows = chunk / KW;
    const bool vec = (KW & 3) == 0;
    const int i0 = 4 * threadIdx.x;
    for (int r0 = 0; r0 < CC * KH; r0 += rows) {
      const int nr = min(rows, CC * KH - r0), ne = nr * KW;
      const float* src = sy + (size_t)r0 * KW + i0;
      float za[N4][4] = {}, zb[N4][4] = {};
      if (vec && i0 + 4 * kThreads * (N4 - 1) + 3 < ne)
        z_values_vec<N4>(src, mi, KS, ng, za, zb);
      else if (i0 < ne)
        z_values_scalar<N4>(src, mi, KS, ng, ne - i0, za, zb);
#pragma unroll
      for (int n = 0; n < N4; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + n * 4 * kThreads + u;
          zs[i] = za[n][u];
          zs[chunk + i] = zb[n][u];
        }
      __syncthreads();
      w_inverse_rows(zs, chunk, r0, nr, cwi_s, swi_s, y_s, ny, CC, KH, KW);
      __syncthreads();
    }
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
tower_block_s_kernel(const float* __restrict__ x,
                     const float* __restrict__ sy,
                     const float* __restrict__ mi,
                     const float* __restrict__ wcat,
                     const float* __restrict__ wcc,
                     const float* __restrict__ bias, Mats m,
                     const float* __restrict__ ds_prev,
                     float* __restrict__ out, float* __restrict__ partial,
                     float* __restrict__ ds_out, int H, int W, int KH,
                     int KW, int nds, int KS) {
  const ZFromSpectrum zsrc{sy, mi + (size_t)blockIdx.y * 2 * KS, KS, C, KH,
                           KW};
  tower_block_body<C>(zsrc, x, wcat, wcc, bias, m, ds_prev, out, partial,
                      ds_out, H, W, KH, KW, nds);
}

// groups[g][s][e] = sum over the planes d of group g, in plane order, of
// mf[d][0][s] f0 + mf[d][1][s] f1, f_q = sum over the tiles of
// partial[d][tile][q][e] in tile order; one thread per element e of a
// spectrum row (C KH KW) and group, all KS rows in registers.
__global__ void tower_spectrum_depth(const float* __restrict__ partial,
                                     const float* __restrict__ mf,
                                     float* __restrict__ groups, int D,
                                     int n_tiles, int ng, int KS) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ng) return;
  const int per_group = (D + kDepthGroups - 1) / kDepthGroups;
  const int d0 = blockIdx.y * per_group, d1 = min(D, d0 + per_group);
  float acc[kMaxKS];
#pragma unroll
  for (int s = 0; s < kMaxKS; ++s) acc[s] = 0.f;
  for (int d = d0; d < d1; ++d) {
    const float* p = partial + (size_t)d * n_tiles * 2 * ng + e;
    float f0 = 0.f, f1 = 0.f;
#pragma unroll 4
    for (int t = 0; t < n_tiles; ++t) {
      f0 += p[(size_t)t * 2 * ng];
      f1 += p[(size_t)t * 2 * ng + ng];
    }
    const float* md = mf + (size_t)d * 2 * KS;
#pragma unroll
    for (int s = 0; s < kMaxKS; ++s)
      if (s < KS)
        acc[s] = fmaf(__ldg(md + s), f0, fmaf(__ldg(md + KS + s), f1, acc[s]));
  }
  float* out = groups + (size_t)blockIdx.y * KS * ng + e;
#pragma unroll
  for (int s = 0; s < kMaxKS; ++s)
    if (s < KS) out[(size_t)s * ng] = acc[s];
}

// s_f = the sum of the groups, in group order.
__global__ void tower_spectrum_groups(const float* __restrict__ groups,
                                      float* __restrict__ s_f, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < kDepthGroups; ++g) s += groups[(size_t)g * n + i];
  s_f[i] = s;
}

template <int C>
cudaError_t launch(const float* x, const float* sy, const float* mi,
                   const float* mf, const float* wcat, const float* wcc,
                   const float* bias, Mats m, const float* ds_prev,
                   float* out, float* s_f, float* ds, float* partial, int D,
                   int H, int W, int KH, int KW, int nds, int KS,
                   cudaStream_t stream) {
  const int n_tiles = (W + kTW - 1) / kTW;
  const size_t smem = sizeof(float) * smem_floats(C, KH, KW, nds);
  cudaError_t err = cudaFuncSetAttribute(
      tower_block_s_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  tower_block_s_kernel<C><<<dim3(n_tiles, D), kThreads, smem, stream>>>(
      x, sy, mi, wcat, wcc, bias, m, ds_prev, out, partial, ds, H, W, KH, KW,
      nds, KS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ng = C * KH * KW, threads = 128;
  float* groups = partial + (size_t)D * n_tiles * 2 * ng;
  tower_spectrum_depth<<<dim3((ng + threads - 1) / threads, kDepthGroups),
                         threads, 0, stream>>>(partial, mf, groups, D,
                                               n_tiles, ng, KS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = KS * ng;
  tower_spectrum_groups<<<(n + 255) / 256, 256, 0, stream>>>(groups, s_f, n);
  return cudaGetLastError();
}

}  // namespace

// x, out: (D, H, W, c); sy, s_f: (ks, c, kh, kw); wcat: (2c + nds, c) and
// wcc: (c, c), rows = outputs; bias: (2c,); mats: the stage matrices in the
// order of unpack_mats, then mi and mf (D, 2, ks); ds_prev, ds:
// (D, H, W, nds) or null when nds == 0; partial: scratch of
// D ceil(W / 8) 2 c kh kw + 8 ks c kh kw floats (the partial spectra, then
// the depth pass's groups). fp32, contiguous.
M3SEG_API int m3seg_tower_block_s(const float* x, const float* sy,
                                  const float* wcat, const float* wcc,
                                  const float* bias, const float* mats,
                                  const float* ds_prev, float* out,
                                  float* s_f, float* ds, float* partial,
                                  int D, int H, int W, int c, int kh, int kw,
                                  int nds, int ks, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || kh <= 0 || kw <= 0 || nds < 0 ||
      nds > kMaxDs || ks <= 0 || ks > kMaxKS || kw > 4 * kThreads ||
      (nds > 0 && (ds_prev == nullptr || ds == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Mats m = unpack_mats(mats, H, W, kh, kw);
  const float* mi = mats + mats_floats(H, W, kh, kw);
  const float* mf = mi + (size_t)D * 2 * ks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 8:
      return (int)launch<8>(x, sy, mi, mf, wcat, wcc, bias, m, ds_prev, out,
                            s_f, ds, partial, D, H, W, kh, kw, nds, ks, s);
    case 24:
      return (int)launch<24>(x, sy, mi, mf, wcat, wcc, bias, m, ds_prev, out,
                             s_f, ds, partial, D, H, W, kh, kw, nds, ks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM and registers per thread of the c-channel instance
// at (kh, kw, nds); launches nothing.
M3SEG_API int m3seg_tower_block_s_occupancy(int c, int kh, int kw, int nds,
                                            int* blocks, int* regs) {
  const size_t smem = sizeof(float) * smem_floats(c, kh, kw, nds);
  switch (c) {
    case 8:
      return (int)kernel_occupancy(tower_block_s_kernel<8>, smem, blocks,
                                   regs);
    case 24:
      return (int)kernel_occupancy(tower_block_s_kernel<24>, smem, blocks,
                                   regs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
