// Fused tower block of the spectral towers (HartleyMHASeg serving, and
// NeuralOperatorSeg with tower_kernel="block"), z read from a tensor.
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/tower_block.py
//   fused_tower_block (pallas_call in _run_tower_kernel, tower_block.py:377,
//   body _tower_kernel).
//
// Two bodies. The fp32 instance runs tower_block.cuh's FMA body: each block
// reads its plane's z rows (D, 2, C, KH, KW) from device memory. The
// 'bfloat16' instance (bf16 volume and weights, f written as bf16, as the
// TPU kernel stores f in the volume's dtype; each product's operands bf16
// values) and the 'mixed' instance (bf16 volume, fp32 weights, matrices and
// f) run tower_block_mma.cuh's tensor-core body, which reads z straight
// into mma.sync fragments. After either body a second kernel
// (tower_spectrum.cuh's tile sum, which tower_block_s launches too) sums
// the tiles' partial spectra in tile order into f (D, 2, C, KH, KW).
// Hartley and Fourier differ only in the stage matrices; Fourier's KW = mw
// may be odd, and then the z rows are not 8-byte aligned and are read one
// value at a time.
//
// What bounds it on an H100: the fp32 instance, the operations. At
// HartleyMHASeg's serving size (grid D x H x W = 121 x 121 x 78, C 24,
// KH = KW = 24, 4 ds rows) a call does 47.6 M MACs per plane over its 121
// planes, 11.5 GFLOP, 0.172 ms at 67 TFLOP/s fp32, against 282.6 MB of
// volume, spectra and ds traffic, 0.084 ms at 3.35 TB/s; at HNOSeg's
// (modes (10, 14, 14), KH = KW = 28, no ds rows) 12.9 GFLOP, 0.193 ms. The
// FMA body's design against that bound (register tiles, staged stage
// matrices, F in registers, two blocks of 256 threads per SM at both
// shapes) is in tower_block.cuh. The tiles' partial spectra cross device
// memory once each way, 182 MB at HNOSeg's shape, about 0.11 ms at
// 3.35 TB/s, summed by the second kernel. The bf16 instances are bound by
// their bytes (tower_block_mma.cuh), and their partial spectra are half
// the fp32 instance's (tiles of 16 columns).
#include "tower_block_mma.cuh"
#include "tower_spectrum.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
tower_block_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ wcat,
                   const float* __restrict__ wcc,
                   const float* __restrict__ bias, Mats m,
                   const float* __restrict__ ds_prev, float* __restrict__ out,
                   float* __restrict__ partial, float* __restrict__ ds_out,
                   int H, int W, int KH, int KW, int nds) {
  const ZFromTensor<false> zsrc{z + (size_t)blockIdx.y * 2 * C * KH * KW, C,
                                KH, KW};
  tower_block_body<C>(zsrc, blockIdx.y, blockIdx.x, gridDim.x, true, x, wcat,
                      wcc, bias, m, ds_prev, out, partial, ds_out, H, W, KH,
                      KW, nds);
}

template <int C>
cudaError_t launch(const void* x, const float* z, const void* wcat,
                   const void* wcc, const float* bias, Mats m,
                   const float* ds_prev, void* out, void* f, float* ds,
                   float* partial, int D, int H, int W, int KH, int KW,
                   int nds, cudaStream_t stream) {
  const int n_tiles = (W + kTW - 1) / kTW;
  const size_t smem = sizeof(float) * smem_floats(C, KH, KW);
  cudaError_t err = cudaFuncSetAttribute(
      tower_block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  tower_block_kernel<C><<<dim3(n_tiles, D), kThreads, smem, stream>>>(
      static_cast<const float*>(x), z, static_cast<const float*>(wcat),
      static_cast<const float*>(wcc), bias, m, ds_prev,
      static_cast<float*>(out), partial, ds, H, W, KH, KW, nds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_tile_sum(partial, static_cast<float*>(f), D, n_tiles,
                         C * KH * KW, stream);
}

// The tensor-core body's kernel: z read from a tensor, straight into B
// fragments; NP the parts of a matrix (1 'bfloat16', 3 'mixed').
template <int C, int NP>
__global__ void __launch_bounds__(kMmaThreads, 1)
tower_block_mma_kernel(const float* __restrict__ z, const MmaArgs a,
                       const MmaIo io) {
  const ZTensorMma<false> zsrc{
      z + (size_t)blockIdx.y * 2 * C * a.KH * a.KW, C, a.KH, a.KW};
  tower_block_mma_body<C, NP, false>(zsrc, blockIdx.y, blockIdx.x, true, a,
                                     io);
}

// wcat, wcc: the packed B fragments (kernels/tower_block.py mma_weights);
// mats: the packed stage matrices (mma_mats); f bf16 (NP 1) or fp32.
template <int C, int NP>
cudaError_t launch_mma(const void* x, const float* z, const void* wcat,
                       const void* wcc, const float* bias, const void* mats,
                       const float* ds_prev, void* out, void* f, float* ds,
                       float* partial, int D, int H, int W, int KH, int KW,
                       int nds, cudaStream_t stream) {
  if (KW > kMmaMaxKW) return cudaErrorInvalidValue;
  const MmaGeom g = mma_geom(C, H, W, KH, KW, NP);
  const size_t smem = (size_t)g.smem;
  if (smem > (size_t)kMmaMaxSmem) return cudaErrorInvalidValue;
  const MmaArgs a{mma_mats(mats, g, NP), ds_prev, partial, ds, H, W, KH, KW,
                  nds, g};
  const MmaIo io{static_cast<const bf16*>(x), static_cast<bf16*>(out),
                 static_cast<const uint2*>(wcat),
                 static_cast<const uint2*>(wcc), bias};
  cudaError_t err = cudaFuncSetAttribute(
      tower_block_mma_kernel<C, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tower_block_mma_kernel<C, NP>
      <<<dim3(g.n_tiles, D), kMmaThreads, smem, stream>>>(z, a, io);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (NP == 1)
    return launch_tile_sum(partial, static_cast<bf16*>(f), D, g.n_tiles,
                           C * KH * KW, stream);
  else
    return launch_tile_sum(partial, static_cast<float*>(f), D, g.n_tiles,
                           C * KH * KW, stream);
}

template <int C>
cudaError_t launch_mode(int mode, const void* x, const float* z,
                        const void* wcat, const void* wcc, const float* bias,
                        const void* mats, const float* ds_prev, void* out,
                        void* f, float* ds, float* partial, int D, int H,
                        int W, int KH, int KW, int nds, cudaStream_t stream) {
  switch (mode) {
    case kFp32:
      return launch<C>(
          x, z, wcat, wcc, bias,
          unpack_mats(static_cast<const float*>(mats), H, W, KH, KW),
          ds_prev, out, f, ds, partial, D, H, W, KH, KW, nds, stream);
    case kBf16:
      return launch_mma<C, 1>(x, z, wcat, wcc, bias, mats, ds_prev, out, f,
                              ds, partial, D, H, W, KH, KW, nds, stream);
    case kMixed:
      return launch_mma<C, 3>(x, z, wcat, wcc, bias, mats, ds_prev, out, f,
                              ds, partial, D, H, W, KH, KW, nds, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t occupancy_mode(int mode, int H, int KH, int KW, int* blocks,
                           int* regs) {
  const size_t smem = sizeof(float) * smem_floats(C, KH, KW);
  switch (mode) {
    case kFp32:
      return kernel_occupancy(tower_block_kernel<C>, smem, blocks, regs);
    case kBf16:
      return kernel_occupancy(tower_block_mma_kernel<C, 1>,
                              mma_smem_bytes(C, H, KH, KW, 1), blocks, regs,
                              kMmaThreads);
    case kMixed:
      return kernel_occupancy(tower_block_mma_kernel<C, 3>,
                              mma_smem_bytes(C, H, KH, KW, 3), blocks, regs,
                              kMmaThreads);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (D, H, W, c); z: (D, 2, c, kh, kw) fp32; f: the same shape, in
// the weights' type; bias: (2c,) fp32; ds_prev, ds: (D, H, W, nds) fp32,
// or null when nds == 0. mode kFp32: x, out, wcat (2c + nds, c) and wcc
// (c, c) fp32, rows = outputs; mats the fp32 stage matrices in the order
// of unpack_mats; partial (D, ceil(W / 8), 2, c, kh, kw) fp32 scratch.
// kBf16 (x, out bf16, f bf16) and kMixed (x, out bf16, f fp32): wcat, wcc
// and mats packed in fragment order (tower_block_mma.cuh; bf16 values, or
// three bf16 parts); partial (D, ceil(W / 16), 2, c, kh, kw) fp32 scratch.
// Contiguous.
M3SEG_API int m3seg_tower_block(const void* x, const float* z,
                                const void* wcat, const void* wcc,
                                const float* bias, const void* mats,
                                const float* ds_prev, void* out, void* f,
                                float* ds, float* partial, int D, int H,
                                int W, int c, int kh, int kw, int nds,
                                int mode, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || kh <= 0 || kh > kMaxKH || (kh & 1) ||
      kw <= 0 || nds < 0 || nds > kMaxDs ||
      (nds > 0 && (ds_prev == nullptr || ds == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 8:
      return (int)launch_mode<8>(mode, x, z, wcat, wcc, bias, mats, ds_prev,
                                 out, f, ds, partial, D, H, W, kh, kw, nds,
                                 s);
    case 24:
      return (int)launch_mode<24>(mode, x, z, wcat, wcc, bias, mats,
                                  ds_prev, out, f, ds, partial, D, H, W, kh,
                                  kw, nds, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM and registers per thread of the c-channel instance
// of `mode` at (h, kh, kw, nds) (h: the tensor-core body's out tile);
// launches nothing.
M3SEG_API int m3seg_tower_block_occupancy(int c, int h, int kh, int kw,
                                          int nds, int mode, int* blocks,
                                          int* regs) {
  switch (c) {
    case 8:
      return (int)occupancy_mode<8>(mode, h, kh, kw, blocks, regs);
    case 24:
      return (int)occupancy_mode<24>(mode, h, kh, kw, blocks, regs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block at (c, h, kh, kw), in bytes: mode
// kFp32 the FMA body's, which the fp32 instances of tower_block,
// tower_block_s and tower_resident share (smem_floats; h unused), kBf16
// and kMixed the tensor-core body's, which their bf16 instances share;
// launches nothing.
M3SEG_API int m3seg_tower_smem_bytes(int c, int h, int kh, int kw, int mode,
                                     int* bytes) {
  if (mode == kFp32)
    *bytes = (int)(sizeof(float) * smem_floats(c, kh, kw));
  else if (mode == kBf16 || mode == kMixed)
    *bytes = (int)mma_smem_bytes(c, h, kh, kw, mode == kBf16 ? 1 : 3);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The tensor-core body's phase clock of the last launch (tower_block_mma.cuh
// phase_clock): n_blocks x 5 global-timer readings, ns, into dst (host);
// launches nothing.
M3SEG_API int m3seg_tower_block_phase_ns(long long* dst, int n_blocks) {
  return (int)read_mma_clock(dst, n_blocks);
}
