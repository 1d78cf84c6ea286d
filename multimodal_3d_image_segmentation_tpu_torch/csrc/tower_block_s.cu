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
#include "tower_spectrum.cuh"

namespace {

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
  const ZFromSpectrum<false> zsrc{sy, mi + (size_t)blockIdx.y * 2 * KS, KS,
                                  C, KH, KW};
  tower_block_body<C, false>(zsrc, blockIdx.y, blockIdx.x, gridDim.x, true,
                             x, wcat, wcc, bias, m, ds_prev, out, partial,
                             ds_out, H, W, KH, KW, nds);
}

// The depth pass: one thread per element e of a spectrum row (C KH KW)
// and plane group (depth_group_element).
__global__ void tower_spectrum_depth(const float* __restrict__ partial,
                                     const float* __restrict__ mf,
                                     float* __restrict__ groups, int D,
                                     int n_tiles, int ng, int KS) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ng) return;
  depth_group_element<false>(partial, mf, groups, D, n_tiles, ng, KS, e,
                             blockIdx.y);
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
