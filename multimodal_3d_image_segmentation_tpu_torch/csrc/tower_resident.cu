// The whole NeuralOperatorSeg tower (HNOSeg, FNOSeg: nb shared-weight
// blocks) in one persistent cooperative launch.
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/tower_resident.py
//   resident_tower (pallas_call in _run_resident, tower_resident.py:244,
//   body _resident_kernel).
//
// Computes, from the volume x (D, H, W, C) and s_cur = block 0's operator
// on the entry spectrum of x (built by the wrapper, as the TPU kernel's
// caller builds it in XLA), for each block b = 0 .. nb - 1:
//   phase z  every plane's z = sum_s mi[d, :, s] s_cur[s] (the inverse
//            depth stage), once, into the scratch z (D, 2, C, KH, KW);
//   phase 1  every (plane, W tile) item, strided over the grid: the block
//            body of tower_block with z read from the scratch (the inverse
//            W/H stages, the block tail, out written, the forward H/W
//            stages into the item's partial spectrum; the last block stops
//            at out);
//   phase 2  the forward depth stage of the partials: each plane's tiles
//            summed in tile order into f (over z), then the planes of 8
//            groups in plane order and the groups in group order, into
//            s_f (tower_spectrum.cuh);
//   phase 3  block b + 1's operator on s_f: Hartley a C x C channel mix
//            and SELU, Fourier the complex mix on [re; im]; into s_cur;
// with cooperative_groups::this_grid().sync() between the phases. No
// atomics: a second run gives the same bits. The z phase and the depth
// pass are tower_block_s's own passes (tower_spectrum.cuh), so each value
// is summed in the same order as there, and the tower gives the bits of
// its blocks launched one by one.
//
// What the card cannot keep: the TPU kernel holds the whole volume in VMEM
// (124 MB). Here 121 x 121 x 78 x 24 x 4 B = 109.6 MB fits neither the
// SMs' shared memory (132 x 227 KB) nor the 50 MB L2, so the volume streams
// through device memory, ping-ponging between the output and one scratch
// volume (an in-place update would break the body's promise that x and out
// never alias). What stays resident is the launch and the 1.5 MB spectrum,
// in L2.
//
// Where the next block's operator runs. The TPU kernel mixes each plane of
// the volume inside its plane loop (the mix commutes with the channel-
// independent DFT stages). Here it runs in phase 3 on the folded spectrum:
// KS KH KW = 15,680 points at HNOSeg's shape instead of 1.14 M voxels, about
// 73 times fewer multiply-adds, and Fourier's complex weight needs no
// second forward H/W pass of the volume.
//
// What bounds it on an H100: the operations. At HNOSeg's serving size
// (grid 121 x 121 x 78, C 24, modes (10, 14, 14): KS 20, KH = KW = 28, 24
// blocks) the body does 13.28 GFLOP a block with its depth stages, 0.32
// TFLOP a tower, 4.7 ms at 67 TFLOP/s fp32, against 219 MB of volume in and
// out, 0.065 ms at 3.35 TB/s (the ping-pong adds 23 volumes of traffic each
// way, 1.6 ms at that rate, and the partial spectra 182 MB a block). The
// body's own design is in tower_block.cuh; here the design answers what
// the persistent launch adds: z formed once per plane (phase z, 18.2 MB
// at HNOSeg's shape, kept in L2) instead of each W tile reading the whole
// 1.5 MB spectrum to form it again, and a body of at most 128 registers,
// so that two blocks of 256 threads reside on an SM. Values that live
// across the grid barriers (the phase clock, the loop state, the derived
// sizes) spill at either cap, 128 or 255 registers; their reloads sit at
// the heads of the phases, outside the inner loops.
// Buffers that the launch rewrites (the volumes, s_cur, z and f, the
// partials and s_f) are read through L2 (ld.global.cg, cp.async.cg,
// m3seg::ld_or_cg); only the weights and stage matrices, which it never
// writes, may come through L1. The grid is the
// number of blocks the CUDA runtime lets reside on an SM at this shared
// memory times the SM count; a refused cooperative launch returns its
// error and the wrapper raises. Three instances, as tower_block_s's: fp32,
// 'bfloat16' (bf16 volumes and body weights, each product's operands bf16
// values, the depth stages' too; the spectra and the operator mix stay
// fp32, as the TPU kernel's spectrum scratch) and 'mixed' (bf16 volumes,
// the rest fp32); each gives the bits of its tower_block_s blocks.
//
// The bf16 instances run tower_block_mma.cuh's tensor-core body in phase
// 1 (tower_resident_mma_kernel): items of (plane, kMmaTW = 16 columns),
// blocks of kMmaThreads = 512 threads, one an SM (the body's shared
// memory, 161 KB in 'bfloat16' and 231 KB in 'mixed' at HNOSeg's shape),
// x and z read through L2 (kL2), each block's weights one slice of a
// stack of packed B fragments. Its other phases are the fp32 kernel's,
// over 512 threads a block. What bounds them there: the volume streams
// through device memory, 24 reads and 24 writes of 54.8 MB of bf16 at
// HNOSeg's shape, 0.785 ms at 3.35 TB/s, above the body's operations
// (0.323 ms at 989 TFLOP/s); neither the 50 MB L2 nor the SMs' 30 MB of
// shared memory hold the volume, which the TPU kernel keeps in VMEM.
#include <cooperative_groups.h>

#include "tower_block_mma.cuh"
#include "tower_spectrum.cuh"

namespace {

namespace cg = cooperative_groups;

// Device time of the kernel's phases in ns, summed over its launches: the
// blocks' bodies (all but the last block's), the depth pass, the operator
// mix, the last block's body, and the z phases. Block 0's thread 0 reads
// %globaltimer after each grid barrier; m3seg_tower_resident_phase_ns
// reads (and resets) the sums. Concurrent launches would mix their sums.
constexpr int kPhases = 5;
__device__ unsigned long long g_phase_ns[kPhases];

struct PhaseClock {
  unsigned long long last = 0;

  __device__ __forceinline__ void mark(int phase) {
    if (blockIdx.x != 0 || threadIdx.x != 0) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (phase >= 0) g_phase_ns[phase] += t - last;
    last = t;
  }
};

// v[c] = the folded spectrum s_f's row `row`, channel c, at (x, y) = xy.
template <int C>
__device__ __forceinline__ void spectrum_point(const float* s_f, int row,
                                               int khw, int xy,
                                               float (&v)[C]) {
  const float* p = s_f + (size_t)row * C * khw + xy;
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = __ldcg(p + (size_t)c * khw);
}

// Phase 3 at one spectrum point (k, xy): s_cur = the operator op ((PR, C, C),
// rows = outputs) on s_f. Hartley: selu(W s_f[k]); Fourier (k < KD):
// [re; im] = [Wr re - Wi im; Wi re + Wr im] of rows k and KD + k.
template <int C>
__device__ __forceinline__ void mix_point(const float* s_f,
                                          const float* __restrict__ op,
                                          float* s_cur, int KS, int khw,
                                          int k, int xy, bool fourier) {
  const size_t ng = (size_t)C * khw;
  if (!fourier) {
    float v[C];
    spectrum_point<C>(s_f, k, khw, xy, v);
    for (int o = 0; o < C; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc = fmaf(__ldg(op + o * C + c), v[c], acc);
      s_cur[k * ng + (size_t)o * khw + xy] = m3seg::selu(acc);
    }
    return;
  }
  const int kd = KS / 2;
  float re[C], im[C];
  spectrum_point<C>(s_f, k, khw, xy, re);
  spectrum_point<C>(s_f, kd + k, khw, xy, im);
  const float* wi = op + C * C;
  for (int o = 0; o < C; ++o) {
    float a = 0.f, b = 0.f, e = 0.f, f = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wr_oc = __ldg(op + o * C + c), wi_oc = __ldg(wi + o * C + c);
      a = fmaf(wr_oc, re[c], a);
      b = fmaf(wi_oc, im[c], b);
      e = fmaf(wi_oc, re[c], e);
      f = fmaf(wr_oc, im[c], f);
    }
    s_cur[k * ng + (size_t)o * khw + xy] = a - b;
    s_cur[(kd + k) * ng + (size_t)o * khw + xy] = e + f;
  }
}

// The tower's loop over blocks of kT threads: for each block b, phase z,
// phase 1 (body(b, forward, x, y): the block's (plane, tile) items from x
// into y), phase 2 and phase 3 (the header), with a grid barrier after
// each. partial: the n_tiles tiles' partial spectra, then s_f.
template <int C, int kT, bool kRound, class T, class Body>
__device__ __forceinline__ void tower_loop(const T* x0, float* s_cur,
                                           const float* __restrict__ ops,
                                           const float* __restrict__ mi,
                                           const float4* __restrict__ mf4,
                                           T* out, T* tmp, float* partial,
                                           float* z, int D, int n_tiles,
                                           int KH, int KW, int KS, int nb,
                                           int fourier, Body&& body) {
  cg::grid_group grid = cg::this_grid();
  const int khw = KH * KW, ng = C * khw;
  const int pr = fourier ? 2 : 1;
  const int n_e = (ng + kT - 1) / kT;
  const int n_e4 = (ng / 4 + kT - 1) / kT;
  const int n_rows = (KS + kDepthRows - 1) / kDepthRows;
  const int per4 = 2 * ng / 4;
  float* s_f = partial + (size_t)D * n_tiles * 2 * ng;
  const T* x = x0;
  PhaseClock clock;
  clock.mark(-1);
  for (int b = 0; b < nb; ++b) {
    for (int item = blockIdx.x; item < n_e4 * kZGroups; item += gridDim.x) {
      const int e4 = 4 * ((item % n_e4) * kT + threadIdx.x);
      if (e4 < ng)
        z_group_element<true, kRound>(s_cur, mi, z, D, ng, KS, e4,
                                      item / n_e4);
    }
    grid.sync();
    clock.mark(4);
    // the volumes ping-pong so that the last block writes out
    T* y = ((nb - 1 - b) & 1) ? tmp : out;
    const bool forward = b + 1 < nb;
    body(b, forward, x, y);
    x = y;
    grid.sync();
    clock.mark(forward ? 0 : 3);
    if (!forward) break;
    // f over z, which no thread reads any more
    for (long long i = blockIdx.x * (long long)kT + threadIdx.x;
         i < (long long)D * per4; i += (long long)gridDim.x * kT)
      tile_sum4<true, float, kRound>(partial, z, n_tiles, per4, i);
    grid.sync();
    for (int item = blockIdx.x; item < n_e * n_rows; item += gridDim.x) {
      const int e = (item % n_e) * kT + threadIdx.x, r = item / n_e;
      if (e < ng)
        depth_rows<true>(z, mf4 + (size_t)r * D * 2, s_f, D, ng, KS, e,
                         r * kDepthRows);
    }
    grid.sync();
    clock.mark(1);
    const int points = (fourier ? KS / 2 : KS) * khw;
    const float* op = ops + (size_t)(b + 1) * pr * C * C;
    for (int i = blockIdx.x * kT + threadIdx.x; i < points;
         i += gridDim.x * kT)
      mix_point<C>(s_f, op, s_cur, KS, khw, i / khw, i % khw, fourier);
    grid.sync();
    clock.mark(2);
  }
}

// The fp32 instance's kernel: phase 1 the FMA body.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
tower_resident_kernel(const float* __restrict__ x0, float* s_cur,
                      const float* __restrict__ ops,
                      const float* __restrict__ wcat,
                      const float* __restrict__ wcc,
                      const float* __restrict__ bias, Mats m,
                      const float* __restrict__ mi,
                      const float4* __restrict__ mf4, float* out,
                      float* tmp, float* partial, float* z, int D, int H,
                      int W, int KH, int KW, int KS, int nb, int fourier) {
  const int n_tiles = (W + kTW - 1) / kTW, n_items = D * n_tiles;
  const int ng = C * KH * KW;
  tower_loop<C, kThreads, false>(
      x0, s_cur, ops, mi, mf4, out, tmp, partial, z, D, n_tiles, KH, KW,
      KS, nb, fourier, [&](int b, bool forward, const float* x, float* y) {
        for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
          const int d = item / n_tiles, tile = item % n_tiles;
          const ZFromTensor<true> zsrc{z + (size_t)d * 2 * ng, C, KH, KW};
          tower_block_body<C>(
              zsrc, d, tile, n_tiles, forward, x,
              wcat + (size_t)b * 2 * C * C, wcc + (size_t)b * C * C,
              bias + (size_t)b * 2 * C, m, nullptr, y, partial, nullptr, H,
              W, KH, KW, 0);
          __syncthreads();  // the next item rewrites the shared memory
        }
      });
}

// The bf16 instances' kernel: the same loop over kMmaThreads threads a
// block, phase 1 the tensor-core body (x and z read through L2). a: what
// the body's launches share (partial as above); wcat and wcc: the stacks
// of packed B fragments, block b's at a fixed stride; bias (nb, 2C). Both
// instances spill under the 128-register cap; 'bfloat16''s body spills
// less with a read from a copy of a in local memory (HNOSeg's tower: 6.1
// against 7.1 ms of bodies on an H100), 'mixed''s from the parameters
// themselves (10.6 against 11.7 ms), so each takes its own.
template <int C, int NP>
__global__ void __launch_bounds__(kMmaThreads, 1)
tower_resident_mma_kernel(const bf16* __restrict__ x0, float* s_cur,
                          const float* __restrict__ ops,
                          const uint2* __restrict__ wcat,
                          const uint2* __restrict__ wcc,
                          const float* __restrict__ bias,
                          const float* __restrict__ mi,
                          const float4* __restrict__ mf4, bf16* out,
                          bf16* tmp, float* z, const MmaArgs a, int D,
                          int KS, int nb, int fourier) {
  constexpr int KSC = (C + 15) / 16, NC = C / 8;
  const int n_tiles = a.g.n_tiles, n_items = D * n_tiles;
  const int ng = C * a.KH * a.KW;
  tower_loop<C, kMmaThreads, NP == 1>(
      x0, s_cur, ops, mi, mf4, out, tmp, a.partial, z, D, n_tiles, a.KH,
      a.KW, KS, nb, fourier, [&](int b, bool forward, const bf16* x, bf16* y) {
        const MmaIo io{x, y, wcat + (size_t)b * NP * KSC * 2 * NC * 32,
                       wcc + (size_t)b * NP * KSC * NC * 32,
                       bias + (size_t)b * 2 * C};
        auto items = [&](const MmaArgs& args) {
          for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
            const int d = item / n_tiles, tile = item % n_tiles;
            const ZTensorMma<true> zsrc{z + (size_t)d * 2 * ng, C, a.KH,
                                        a.KW};
            tower_block_mma_body<C, NP, true>(zsrc, d, tile, forward, args,
                                              io);
            __syncthreads();  // the next item rewrites the shared memory
          }
        };
        if constexpr (NP == 1) {
          MmaArgs local = a;
          items(local);
        } else {
          items(a);
        }
      });
}

// Launches `kernel` cooperatively, `threads` a block and `smem` bytes of
// dynamic shared memory (set for the occupancy query and again right
// before the launch: another query may have lowered it), as many blocks
// as reside on an SM times the SM count; a grid that cannot reside
// returns its error.
template <class Kernel>
cudaError_t launch_cooperative(Kernel kernel, size_t smem, int threads,
                               void** args, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, blocks = 0, regs = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = kernel_occupancy(kernel, smem, &blocks, &regs, threads);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks * sms), dim3(threads), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const void* xv, float* s_cur, const float* ops,
                   const void* wcatv, const void* wccv, const float* bias,
                   Mats m, const float* mi, const float4* mf4, void* outv,
                   void* tmpv, float* partial, float* z, int D, int H, int W,
                   int KH, int KW, int KS, int nb, int fourier,
                   cudaStream_t stream) {
  // the kernel's parameters, in its order and types
  const float* x = static_cast<const float*>(xv);
  const float* wcat = static_cast<const float*>(wcatv);
  const float* wcc = static_cast<const float*>(wccv);
  float* out = static_cast<float*>(outv);
  float* tmp = static_cast<float*>(tmpv);
  void* args[] = {&x,  &s_cur, &ops, &wcat,    &wcc, &bias, &m,
                  &mi, &mf4,   &out, &tmp,     &partial, &z, &D,
                  &H,  &W,     &KH,  &KW,      &KS,  &nb,   &fourier};
  return launch_cooperative(tower_resident_kernel<C>,
                            sizeof(float) * smem_floats(C, KH, KW), kThreads,
                            args, stream);
}

// The bf16 instances: wcat (nb, NP, ceil(C/16), 2C/8, 32 lanes) and wcc
// (nb, NP, ceil(C/16), C/8, 32 lanes) packed B fragments (kernels/
// tower_block.py mma_weight_stack), mma the packed stage matrices.
template <int C, int NP>
cudaError_t launch_mma(const void* xv, float* s_cur, const float* ops,
                       const void* wcat, const void* wcc, const float* bias,
                       const void* mma, const float* mi, const float4* mf4,
                       void* outv, void* tmpv, float* partial, float* z,
                       int D, int H, int W, int KH, int KW, int KS, int nb,
                       int fourier, cudaStream_t stream) {
  if (KW > kMmaMaxKW || mma == nullptr) return cudaErrorInvalidValue;
  const MmaGeom g = mma_geom(C, H, W, KH, KW, NP);
  if (g.smem > kMmaMaxSmem) return cudaErrorInvalidValue;
  // the kernel's parameters, in its order and types
  const bf16* x = static_cast<const bf16*>(xv);
  const uint2* wcat2 = static_cast<const uint2*>(wcat);
  const uint2* wcc2 = static_cast<const uint2*>(wcc);
  bf16* out = static_cast<bf16*>(outv);
  bf16* tmp = static_cast<bf16*>(tmpv);
  MmaArgs a{mma_mats(mma, g, NP), nullptr, partial, nullptr, H, W, KH, KW, 0,
            g};
  void* args[] = {&x,   &s_cur, &ops, &wcat2, &wcc2, &bias, &mi, &mf4,
                  &out, &tmp,   &z,   &a,     &D,    &KS,   &nb, &fourier};
  return launch_cooperative(tower_resident_mma_kernel<C, NP>, g.smem,
                            kMmaThreads, args, stream);
}

template <int C>
cudaError_t launch_mode(int mode, const void* x, float* s_cur,
                        const float* ops, const void* wcat, const void* wcc,
                        const float* bias, Mats m, const void* mma,
                        const float* mi, const float4* mf4, void* out,
                        void* tmp, float* partial, float* z, int D, int H,
                        int W, int KH, int KW, int KS, int nb, int fourier,
                        cudaStream_t stream) {
  switch (mode) {
    case kFp32:
      return launch<C>(x, s_cur, ops, wcat, wcc, bias, m, mi, mf4, out, tmp,
                       partial, z, D, H, W, KH, KW, KS, nb, fourier, stream);
    case kBf16:
      return launch_mma<C, 1>(x, s_cur, ops, wcat, wcc, bias, mma, mi, mf4,
                              out, tmp, partial, z, D, H, W, KH, KW, KS, nb,
                              fourier, stream);
    case kMixed:
      return launch_mma<C, 3>(x, s_cur, ops, wcat, wcc, bias, mma, mi, mf4,
                              out, tmp, partial, z, D, H, W, KH, KW, KS, nb,
                              fourier, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t occupancy_mode(int mode, int H, int KH, int KW, int* blocks,
                           int* regs) {
  switch (mode) {
    case kFp32:
      return kernel_occupancy(tower_resident_kernel<C>,
                              sizeof(float) * smem_floats(C, KH, KW), blocks,
                              regs);
    case kBf16:
      return kernel_occupancy(tower_resident_mma_kernel<C, 1>,
                              mma_smem_bytes(C, H, KH, KW, 1), blocks, regs,
                              kMmaThreads);
    case kMixed:
      return kernel_occupancy(tower_resident_mma_kernel<C, 3>,
                              mma_smem_bytes(C, H, KH, KW, 3), blocks, regs,
                              kMmaThreads);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out, tmp: (D, H, W, c) (tmp unused when nb == 1); s_cur: (ks, c, kh,
// kw) fp32, block 0's operator on the entry spectrum of x, overwritten;
// ops: (nb, 1 or 2, c, c) fp32 operator weights, rows = outputs (Fourier:
// real, imaginary); bias: (nb, 2c) fp32; mats: the fp32 stage matrices in
// the order of unpack_mats, then mi (D, 2, ks) and mf packed (ceil(ks /
// 4), D, 2, 4) (bf16-rounded values for mode kBf16); z: fp32 scratch (D,
// 2, c, kh, kw) (z, then f). mode kFp32: x, out, tmp, wcat (nb, 2c, c)
// and wcc (nb, c, c) fp32; mma unused; partial: fp32 scratch of D
// ceil(W / 8) 2 c kh kw + ks c kh kw floats (the partial spectra, then
// s_f). kBf16 and kMixed (the volumes bf16): wcat and wcc the stacks of
// the tensor-core body's packed weights (launch_mma), mma its packed
// stage matrices, 16-byte aligned; partial D ceil(W / 16) 2 c kh kw + ks
// c kh kw floats. Contiguous. fourier: ks = 2 kd, [re; im].
M3SEG_API int m3seg_tower_resident(const void* x, float* s_cur,
                                   const float* ops, const void* wcat,
                                   const void* wcc, const float* bias,
                                   const float* mats, const void* mma,
                                   void* out, void* tmp, float* partial,
                                   float* z, int D, int H, int W, int c,
                                   int kh, int kw, int ks, int nb,
                                   int fourier, int mode, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || kh <= 0 || kh > kMaxKH || (kh & 1) ||
      kw <= 0 || ks <= 0 || ks > kMaxKS || nb <= 0 || z == nullptr ||
      (fourier && (ks & 1)) || (nb > 1 && tmp == nullptr))
    return (int)cudaErrorInvalidValue;
  const Mats m = unpack_mats(mats, H, W, kh, kw);
  const float* mi = mats + mats_floats(H, W, kh, kw);
  const float4* mf4 =
      reinterpret_cast<const float4*>(mi + (size_t)D * 2 * ks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 8:
      return (int)launch_mode<8>(mode, x, s_cur, ops, wcat, wcc, bias, m,
                                 mma, mi, mf4, out, tmp, partial, z, D, H, W,
                                 kh, kw, ks, nb, fourier, s);
    case 24:
      return (int)launch_mode<24>(mode, x, s_cur, ops, wcat, wcc, bias, m,
                                  mma, mi, mf4, out, tmp, partial, z, D, H,
                                  W, kh, kw, ks, nb, fourier, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM and registers per thread of the c-channel
// instance of `mode` at (h, kh, kw) (h: the tensor-core body's out tile);
// launches nothing. The launch's grid is the blocks per SM times the SM
// count.
M3SEG_API int m3seg_tower_resident_occupancy(int c, int h, int kh, int kw,
                                             int mode, int* blocks,
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

// out[0..4] = the phase sums of g_phase_ns (ns); reset: set them to 0.
// Synchronous with the device.
M3SEG_API int m3seg_tower_resident_phase_ns(unsigned long long* out,
                                            int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(g_phase_ns));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(g_phase_ns, zero, sizeof(zero));
  }
  return (int)err;
}

// The tensor-core body's phase clock of this kernel's last bf16 launch
// (tower_block_mma.cuh phase_clock; its last tower block's items write
// their first two phases): n_blocks x 5 readings, ns, into dst (host);
// launches nothing.
M3SEG_API int m3seg_tower_resident_mma_phase_ns(long long* dst,
                                                int n_blocks) {
  return (int)read_mma_clock(dst, n_blocks);
}
