// Fused tower block on the resident packed spectrum: the depth stages run
// on the card around the block body (NeuralOperatorSeg serving with
// tower_kernel="block_s", HNOSeg and FNOSeg; and HartleyMHASeg with
// tower_kernel="block_s").
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
// in four launches (tower_spectrum.cuh): the z pass forms every plane's z
// once into a scratch (D, 2, C, KH, KW); the body reads it as tower_block
// reads its z tensor and writes each (plane, W tile)'s partial spectrum;
// the tile sum folds a plane's tiles in tile order into f, over the z
// scratch, which the body no longer needs; the depth pass contracts f over
// the planes of 8 groups in plane order and sums the groups in group
// order, into s_f. z and f stay in scratch of 18.2 MB each at HNOSeg's
// shape, which L2 (50 MB) holds between the launches; no atomics, so the
// same bits from run to run. Only the D real planes enter the sums (the
// TPU kernel selects its padded planes away; here there are none). z is
// summed over s ascending, f over the tiles in tile order, s_f over the
// planes of each group in plane order and then over the groups: the order
// tower_resident keeps too, so the tower gives the bits of these blocks.
//
// What bounds it on an H100: the operations. At HNOSeg's serving size
// (grid 121 x 121 x 78, C 24, modes (10, 14, 14): KS 20, KH = KW = 28, no
// ds rows) the block body does 53.4 M MACs per plane, 12.9 GFLOP per call,
// 0.19 ms at 67 TFLOP/s fp32, against 222 MB of volume traffic, 0.066 ms
// at 3.35 TB/s; the depth stages add 2 KS C KH KW MACs per plane each way
// (0.36 GFLOP per call). Forming z once per plane, instead of once per W
// tile, spares the body 14% of its MACs at that shape and the whole
// spectrum read from L2 by every block (1.8 GB per call). The passes
// around the body move bytes: the partial spectra, 182 MB in the tile sum
// (0.054 ms at 3.35 TB/s), read with 16-byte loads, four in flight a
// thread; z and f, each 18.2 MB, through L2. The body's own design against
// the operations bound is in tower_block.cuh.
#include "tower_spectrum.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
tower_block_s_kernel(const float* __restrict__ x, const float* __restrict__ z,
                     const float* __restrict__ wcat,
                     const float* __restrict__ wcc,
                     const float* __restrict__ bias, Mats m,
                     const float* __restrict__ ds_prev,
                     float* __restrict__ out, float* __restrict__ partial,
                     float* __restrict__ ds_out, int H, int W, int KH,
                     int KW, int nds) {
  const ZFromTensor<false> zsrc{z + (size_t)blockIdx.y * 2 * C * KH * KW, C,
                                KH, KW};
  tower_block_body<C>(zsrc, blockIdx.y, blockIdx.x, gridDim.x, true, x,
                      wcat, wcc, bias, m, ds_prev, out, partial, ds_out, H,
                      W, KH, KW, nds);
}

// The z pass: one thread per four elements of a spectrum row (C KH KW)
// and plane group (z_group_element).
__global__ void tower_spectrum_z(const float* __restrict__ sy,
                                 const float* __restrict__ mi,
                                 float* __restrict__ z, int D, int ng,
                                 int KS) {
  const int e4 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (e4 < ng) z_group_element<false>(sy, mi, z, D, ng, KS, e4, blockIdx.y);
}

// The depth pass: one thread per element e and kDepthRows spectrum rows
// (blockIdx.y) (depth_rows).
__global__ void tower_spectrum_depth(const float* __restrict__ f,
                                     const float4* __restrict__ mf4,
                                     float* __restrict__ s_f, int D, int ng,
                                     int KS) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < ng)
    depth_rows<false>(f, mf4 + (size_t)blockIdx.y * D * 2, s_f, D, ng, KS,
                      e, blockIdx.y * kDepthRows);
}

template <int C>
cudaError_t launch(const float* x, const float* sy, const float* mi,
                   const float4* mf4, const float* wcat, const float* wcc,
                   const float* bias, Mats m, const float* ds_prev,
                   float* out, float* s_f, float* ds, float* partial, int D,
                   int H, int W, int KH, int KW, int nds, int KS,
                   cudaStream_t stream) {
  const int n_tiles = (W + kTW - 1) / kTW, ng = C * KH * KW;
  const int e_blocks = (ng + kPassThreads - 1) / kPassThreads;
  // z (D, 2, ng), then f over it: after the partial spectra
  float* zf = partial + (size_t)D * n_tiles * 2 * ng;
  tower_spectrum_z<<<dim3((ng / 4 + kPassThreads - 1) / kPassThreads,
                          kZGroups),
                     kPassThreads, 0, stream>>>(sy, mi, zf, D, ng, KS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * smem_floats(C, KH, KW);
  err = cudaFuncSetAttribute(tower_block_s_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  tower_block_s_kernel<C><<<dim3(n_tiles, D), kThreads, smem, stream>>>(
      x, zf, wcat, wcc, bias, m, ds_prev, out, partial, ds, H, W, KH, KW,
      nds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_tile_sum(partial, zf, D, n_tiles, ng, stream);
  if (err != cudaSuccess) return err;
  tower_spectrum_depth<<<dim3(e_blocks, (KS + kDepthRows - 1) / kDepthRows),
                         kPassThreads, 0, stream>>>(zf, mf4, s_f, D, ng, KS);
  return cudaGetLastError();
}

}  // namespace

// x, out: (D, H, W, c); sy, s_f: (ks, c, kh, kw); wcat: (2c + nds, c) and
// wcc: (c, c), rows = outputs; bias: (2c,); mats: the stage matrices in the
// order of unpack_mats, then mi (D, 2, ks) and mf packed (ceil(ks / 4), D,
// 2, 4); ds_prev, ds: (D, H, W, nds) or null when nds == 0; partial:
// scratch of D (ceil(W / 8) + 1) 2 c kh kw floats (the partial spectra,
// then z and f). fp32, contiguous.
M3SEG_API int m3seg_tower_block_s(const float* x, const float* sy,
                                  const float* wcat, const float* wcc,
                                  const float* bias, const float* mats,
                                  const float* ds_prev, float* out,
                                  float* s_f, float* ds, float* partial,
                                  int D, int H, int W, int c, int kh, int kw,
                                  int nds, int ks, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || kh <= 0 || kh > kMaxKH || (kh & 1) ||
      kw <= 0 || nds < 0 || nds > kMaxDs || ks <= 0 || ks > kMaxKS ||
      (nds > 0 && (ds_prev == nullptr || ds == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Mats m = unpack_mats(mats, H, W, kh, kw);
  const float* mi = mats + mats_floats(H, W, kh, kw);
  const float4* mf4 =
      reinterpret_cast<const float4*>(mi + (size_t)D * 2 * ks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 8:
      return (int)launch<8>(x, sy, mi, mf4, wcat, wcc, bias, m, ds_prev, out,
                            s_f, ds, partial, D, H, W, kh, kw, nds, ks, s);
    case 24:
      return (int)launch<24>(x, sy, mi, mf4, wcat, wcc, bias, m, ds_prev, out,
                             s_f, ds, partial, D, H, W, kh, kw, nds, ks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM and registers per thread of the c-channel instance
// at (kh, kw, nds); launches nothing.
M3SEG_API int m3seg_tower_block_s_occupancy(int c, int kh, int kw, int nds,
                                            int* blocks, int* regs) {
  const size_t smem = sizeof(float) * smem_floats(c, kh, kw);
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

// The plane groups of the z pass and of the depth pass (kZGroups,
// kDepthGroups), which tower_resident shares; launches nothing.
M3SEG_API int m3seg_tower_spectrum_groups(int* z_groups, int* depth_groups) {
  *z_groups = kZGroups;
  *depth_groups = kDepthGroups;
  return 0;
}
