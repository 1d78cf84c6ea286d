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
//   phase 1  every (plane, W tile) item, strided over the grid: the block
//            body of tower_block_s (z formed from s_cur, the inverse W/H
//            stages, the block tail, out written, the forward H/W stages
//            into the item's partial spectrum; the last block stops at out);
//   phase 2  the forward depth stage of the partials, tiles then the planes
//            of 8 groups, in a fixed order (tower_spectrum.cuh);
//   phase 3  the sum of the groups, in group order, then block b + 1's
//            operator on the packed spectrum: Hartley a C x C channel mix
//            and SELU, Fourier the complex mix on [re; im]; into s_cur;
// with cooperative_groups::this_grid().sync() between the phases. No
// atomics: a second run gives the same bits.
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
// way, 1.6 ms at that rate, and the partial spectra 182 MB a block).
// Buffers that the launch rewrites (the volumes, s_cur, the partials and
// groups) are read through L2 (ld.global.cg, m3seg::ld_or_cg); only the
// weights and stage matrices take the read-only path. The grid is the
// number of blocks the CUDA runtime lets reside on an SM at this shared
// memory (one at modes (10, 14, 14)) times the SM count; a refused
// cooperative launch returns its error and the wrapper raises.
#include <cooperative_groups.h>

#include "tower_spectrum.cuh"

namespace {

namespace cg = cooperative_groups;

// Device time of the kernel's phases in ns, summed over its launches: the
// blocks' bodies (all but the last block's), the depth pass, the operator
// mix, and the last block's body. Block 0's thread 0 reads %globaltimer
// after each grid barrier; m3seg_tower_resident_phase_ns reads (and
// resets) the sums. Concurrent launches would mix their sums.
__device__ unsigned long long g_phase_ns[4];

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

// v[c] = sum over the depth pass's groups, in group order, of spectrum row
// `row`, channel c, at (x, y) = xy: the folded spectrum s_f.
template <int C>
__device__ __forceinline__ void group_sums(const float* groups, int row,
                                           int KS, int khw, int xy,
                                           float (&v)[C]) {
  const size_t ng = (size_t)C * khw;
  const float* p = groups + row * ng + xy;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kDepthGroups; ++g)
      s += __ldcg(p + (size_t)g * KS * ng + (size_t)c * khw);
    v[c] = s;
  }
}

// Phase 3 at one spectrum point (k, xy): s_cur = the operator op ((PR, C, C),
// rows = outputs) on s_f. Hartley: selu(W s_f[k]); Fourier (k < KD):
// [re; im] = [Wr re - Wi im; Wi re + Wr im] of rows k and KD + k.
template <int C>
__device__ __forceinline__ void mix_point(const float* groups,
                                          const float* __restrict__ op,
                                          float* s_cur, int KS, int khw,
                                          int k, int xy, bool fourier) {
  const size_t ng = (size_t)C * khw;
  if (!fourier) {
    float v[C];
    group_sums<C>(groups, k, KS, khw, xy, v);
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
  group_sums<C>(groups, k, KS, khw, xy, re);
  group_sums<C>(groups, kd + k, KS, khw, xy, im);
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

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
tower_resident_kernel(const float* __restrict__ x0, float* s_cur,
                      const float* __restrict__ ops,
                      const float* __restrict__ wcat,
                      const float* __restrict__ wcc,
                      const float* __restrict__ bias, Mats m,
                      const float* __restrict__ mi,
                      const float* __restrict__ mf, float* out, float* tmp,
                      float* partial, int D, int H, int W, int KH, int KW,
                      int KS, int nb, int fourier) {
  cg::grid_group grid = cg::this_grid();
  const int n_tiles = (W + kTW - 1) / kTW, n_items = D * n_tiles;
  const int khw = KH * KW, ng = C * khw;
  const int pr = fourier ? 2 : 1;
  float* groups = partial + (size_t)D * n_tiles * 2 * ng;
  const float* x = x0;
  PhaseClock clock;
  clock.mark(-1);
  for (int b = 0; b < nb; ++b) {
    // the volumes ping-pong so that the last block writes out
    float* y = ((nb - 1 - b) & 1) ? tmp : out;
    const bool forward = b + 1 < nb;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int d = item / n_tiles, tile = item % n_tiles;
      const ZFromSpectrum<true> zsrc{s_cur, mi + (size_t)d * 2 * KS, KS, C,
                                     KH, KW};
      tower_block_body<C, true>(zsrc, d, tile, n_tiles, forward, x,
                                wcat + (size_t)b * 2 * C * C,
                                wcc + (size_t)b * C * C,
                                bias + (size_t)b * 2 * C, m, nullptr, y,
                                partial, nullptr, H, W, KH, KW, 0);
      __syncthreads();  // the next item rewrites the shared memory
    }
    x = y;
    grid.sync();
    clock.mark(forward ? 0 : 3);
    if (!forward) break;
    const int n_e = (ng + kThreads - 1) / kThreads;
    for (int item = blockIdx.x; item < n_e * kDepthGroups;
         item += gridDim.x) {
      const int e = (item % n_e) * kThreads + threadIdx.x;
      if (e < ng)
        depth_group_element<true>(partial, mf, groups, D, n_tiles, ng, KS, e,
                                  item / n_e);
    }
    grid.sync();
    clock.mark(1);
    const int points = (fourier ? KS / 2 : KS) * khw;
    const float* op = ops + (size_t)(b + 1) * pr * C * C;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < points;
         i += gridDim.x * kThreads)
      mix_point<C>(groups, op, s_cur, KS, khw, i / khw, i % khw, fourier);
    grid.sync();
    clock.mark(2);
  }
}

// Resident blocks per SM at the kernel's dynamic shared memory (set here),
// and registers per thread.
template <int C>
cudaError_t resident_occupancy(int KH, int KW, size_t* smem, int* blocks,
                               int* regs) {
  *smem = sizeof(float) * smem_floats(C, KH, KW, 0);
  return kernel_occupancy(tower_resident_kernel<C>, *smem, blocks, regs);
}

template <int C>
cudaError_t launch(const float* x, float* s_cur, const float* ops,
                   const float* wcat, const float* wcc, const float* bias,
                   Mats m, const float* mi, const float* mf, float* out,
                   float* tmp, float* partial, int D, int H, int W, int KH,
                   int KW, int KS, int nb, int fourier, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, blocks = 0, regs = 0;
  size_t smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = resident_occupancy<C>(KH, KW, &smem, &blocks, &regs);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&x,  &s_cur,   &ops, &wcat, &wcc, &bias, &m,  &mi,
                  &mf, &out,     &tmp, &partial, &D, &H,   &W,  &KH,
                  &KW, &KS,      &nb,  &fourier};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(tower_resident_kernel<C>),
      dim3(blocks * sms), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x, out, tmp: (D, H, W, c) (tmp unused when nb == 1); s_cur: (ks, c, kh,
// kw), block 0's operator on the entry spectrum of x, overwritten; ops:
// (nb, 1 or 2, c, c) operator weights, rows = outputs (Fourier: real,
// imaginary); wcat: (nb, 2c, c), wcc: (nb, c, c), bias: (nb, 2c); mats:
// the stage matrices in the order of unpack_mats, then mi and mf (D, 2,
// ks); partial: scratch of D ceil(W / 8) 2 c kh kw + 8 ks c kh kw floats.
// fp32, contiguous. fourier: ks = 2 kd, [re; im].
M3SEG_API int m3seg_tower_resident(const float* x, float* s_cur,
                                   const float* ops, const float* wcat,
                                   const float* wcc, const float* bias,
                                   const float* mats, float* out, float* tmp,
                                   float* partial, int D, int H, int W,
                                   int c, int kh, int kw, int ks, int nb,
                                   int fourier, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || kh <= 0 || kw <= 0 || ks <= 0 ||
      ks > kMaxKS || kw > kThreads || nb <= 0 ||
      (fourier && (ks & 1)) || (nb > 1 && tmp == nullptr))
    return (int)cudaErrorInvalidValue;
  const Mats m = unpack_mats(mats, H, W, kh, kw);
  const float* mi = mats + mats_floats(H, W, kh, kw);
  const float* mf = mi + (size_t)D * 2 * ks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 8:
      return (int)launch<8>(x, s_cur, ops, wcat, wcc, bias, m, mi, mf, out,
                            tmp, partial, D, H, W, kh, kw, ks, nb, fourier,
                            s);
    case 24:
      return (int)launch<24>(x, s_cur, ops, wcat, wcc, bias, m, mi, mf, out,
                             tmp, partial, D, H, W, kh, kw, ks, nb, fourier,
                             s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Resident blocks per SM and registers per thread of the c-channel
// instance at (kh, kw); launches nothing. The launch's grid is the blocks
// per SM times the SM count.
M3SEG_API int m3seg_tower_resident_occupancy(int c, int kh, int kw,
                                             int* blocks, int* regs) {
  size_t smem = 0;
  switch (c) {
    case 8:
      return (int)resident_occupancy<8>(kh, kw, &smem, blocks, regs);
    case 24:
      return (int)resident_occupancy<24>(kh, kw, &smem, blocks, regs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out[0..3] = the phase sums of g_phase_ns (ns); reset: set them to 0.
// Synchronous with the device.
M3SEG_API int m3seg_tower_resident_phase_ns(unsigned long long* out,
                                            int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(g_phase_ns));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    err = cudaMemcpyToSymbol(g_phase_ns, zero, sizeof(zero));
  }
  return (int)err;
}
