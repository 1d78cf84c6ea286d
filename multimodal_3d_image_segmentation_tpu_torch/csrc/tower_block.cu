// Fused tower block of the spectral towers (HartleyMHASeg serving, and
// NeuralOperatorSeg with tower_kernel="block"), z read from a tensor.
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/tower_block.py
//   fused_tower_block (pallas_call in _run_tower_kernel, tower_block.py:377,
//   body _tower_kernel).
//
// The block body, its design and its arithmetic are in tower_block.cuh;
// here each block reads its plane's z rows (D, 2, C, KH, KW) from device
// memory, and a second kernel (tower_spectrum.cuh's tile sum, which
// tower_block_s launches too) sums the tiles' partial spectra in tile
// order into f (D, 2, C, KH, KW). Hartley and Fourier differ only in the
// stage matrices; Fourier's KW = mw may be odd, and then the z rows are not
// 8-byte aligned and are read one value at a time.
//
// What bounds it on an H100: the operations. At HartleyMHASeg's serving
// size (grid D x H x W = 121 x 121 x 78, C 24, KH = KW = 24, 4 ds rows) a
// call does 47.6 M MACs per plane over its 121 planes, 11.5 GFLOP, 0.172
// ms at 67 TFLOP/s fp32, against 282.6 MB of volume, spectra and ds
// traffic, 0.084 ms at 3.35 TB/s; at HNOSeg's (modes (10, 14, 14),
// KH = KW = 28, no ds rows) 12.9 GFLOP, 0.193 ms. The body's design
// against that bound (register tiles, staged stage matrices, F in
// registers, two blocks of 256 threads per SM at both shapes) is in
// tower_block.cuh. The tiles' partial spectra cross device memory once
// each way, 182 MB at HNOSeg's shape, about 0.11 ms at 3.35 TB/s, summed
// by the second kernel.
#include "tower_spectrum.cuh"

namespace {

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
  const ZFromTensor<false> zsrc{z + (size_t)blockIdx.y * 2 * C * KH * KW, C,
                                KH, KW};
  tower_block_body<C>(zsrc, blockIdx.y, blockIdx.x, gridDim.x, true, x,
                      wcat, wcc, bias, m, ds_prev, out, partial, ds_out, H,
                      W, KH, KW, nds);
}

template <int C>
cudaError_t launch(const float* x, const float* z, const float* wcat,
                   const float* wcc, const float* bias, Mats m,
                   const float* ds_prev, float* out, float* f, float* ds,
                   float* partial, int D, int H, int W, int KH, int KW,
                   int nds, cudaStream_t stream) {
  const int n_tiles = (W + kTW - 1) / kTW;
  const size_t smem = sizeof(float) * smem_floats(C, KH, KW);
  cudaError_t err = cudaFuncSetAttribute(
      tower_block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  tower_block_kernel<C><<<dim3(n_tiles, D), kThreads, smem, stream>>>(
      x, z, wcat, wcc, bias, m, ds_prev, out, partial, ds, H, W, KH, KW,
      nds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_tile_sum(partial, f, D, n_tiles, C * KH * KW, stream);
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
  if (D <= 0 || H <= 0 || W <= 0 || kh <= 0 || kh > kMaxKH || (kh & 1) ||
      kw <= 0 || nds < 0 || nds > kMaxDs ||
      (nds > 0 && (ds_prev == nullptr || ds == nullptr)))
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
  const size_t smem = sizeof(float) * smem_floats(c, kh, kw);
  switch (c) {
    case 8:
      return (int)kernel_occupancy(tower_block_kernel<8>, smem, blocks, regs);
    case 24:
      return (int)kernel_occupancy(tower_block_kernel<24>, smem, blocks, regs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of the tower kernels (tower_block,
// tower_block_s and tower_resident share smem_floats) at (c, kh, kw), in
// bytes; launches nothing.
M3SEG_API int m3seg_tower_smem_bytes(int c, int kh, int kw, int* bytes) {
  *bytes = (int)(sizeof(float) * smem_floats(c, kh, kw));
  return 0;
}
