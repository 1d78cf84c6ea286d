// What conv3's two bodies share: the fp32 FMA body (conv3.cu) and the bf16
// tensor-core body (conv3_mma.cu). The prologue's activations, the cp.async
// copies, the output geometry of each mode, the voxel an input slot reads
// (the halo and dilated-depth mappings), the fixed-order reduce of the
// split-chunk partial sums and the moments' last sum.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int REDUCE_ROWS = 16;    // voxels per block of the split-sum pass
constexpr int NUM_SMS = 132;

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v > 0.f ? v : expm1f(v);
    case 2: return m3seg::selu(v);
    case 3: return fmaxf(v, 0.f);
    default: return v;
  }
}

// cp.async: 4 or 8 bytes (through L1) or 16 bytes (L2 only); with ok false
// the destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The storage voxel that input plane iz, row iy, column iw of the
// iteration's input reads, or -1 where it is zero padding. Depth plane iz
// reads storage plane iz + 1 in halo mode (planes -1 and D are the halos,
// data where kept), iz / 2 of a dilated depth (even planes only).
__device__ __forceinline__ int input_voxel(int iz, int iy, int iw, int D,
                                           int H, int W, int halo,
                                           int keep_lo, int keep_hi,
                                           int dsrc) {
  const int zlo = halo && keep_lo ? -1 : 0;
  const int zhi = halo && keep_hi ? D + 1 : D;
  bool zok = iz >= zlo && iz < zhi;
  int sz = iz + halo;
  if (dsrc > 0) {
    zok = zok && iz % 2 == 0 && iz / 2 < dsrc;
    sz = iz / 2;
  }
  return (zok && iy >= 0 && iy < H && iw >= 0 && iw < W)
             ? (sz * H + iy) * W + iw : -1;
}

// out[m, n] = sum over k of ws[k, m, n] (in order) + bias[n], rounded to
// T, with each block's moment partials over its rows voxels (of the fp32
// values, or of the rounded ones with stats_rounded). A block is 32
// columns x 8 row lanes; the lanes' sums are added in a fixed order.
template <class T>
__global__ void __launch_bounds__(256)
conv3_split_sum(const float* __restrict__ ws, int split, long long M,
                int co, int rows, const float* __restrict__ bias,
                T* __restrict__ out, float* __restrict__ part,
                int stats_rounded) {
  __shared__ float red[2][8][32];
  const int ln = threadIdx.x % 32, lr = threadIdx.x / 32;
  const long long m0 = (long long)blockIdx.x * rows;
  const long long m1 = m0 + rows < M ? m0 + rows : M;
  for (int nb = 0; nb < co; nb += 32) {
    const int n = nb + ln;
    float s = 0.f, s2 = 0.f;
    if (n < co) {
      for (long long m = m0 + lr; m < m1; m += 8) {
        float v = 0.f;
#pragma unroll 4
        for (int k = 0; k < split; ++k)
          v += ws[((long long)k * M + m) * co + n];
        v += bias[n];
        out[m * co + n] = m3seg::from_float<T>(v);
        if constexpr (!std::is_same<T, float>::value)
          if (stats_rounded) v = m3seg::round_to<T>(v);
        s += v;
        s2 += v * v;
      }
    }
    red[0][lr][ln] = s;
    red[1][lr][ln] = s2;
    __syncthreads();
    if (part != nullptr && threadIdx.x < 64 && nb + threadIdx.x % 32 < co) {
      const int q = threadIdx.x / 32, nn = threadIdx.x % 32;
      float sum = 0.f;
      for (int r = 0; r < 8; ++r) sum += red[q][r][nn];
      part[((long long)blockIdx.x * 2 + q) * co + nb + nn] = sum;
    }
    __syncthreads();
  }
}

// The split-sum pass over a (Do, Ho, Wo, co) output: y (and r from the
// residual's half of the workspace) from split partial sums each, rows
// voxels a block.
template <class T>
cudaError_t launch_split_sum(const float* ws, int split, long long m_out,
                             int co, int rows, const float* bias, void* y,
                             float* part, const float* br, void* r,
                             float* rpart, int stats_rounded,
                             cudaStream_t s) {
  const unsigned nb = (unsigned)((m_out + rows - 1) / rows);
  conv3_split_sum<T><<<nb, 256, 0, s>>>(ws, split, m_out, co, rows, bias,
                                        static_cast<T*>(y), part,
                                        stats_rounded);
  if (r != nullptr)
    conv3_split_sum<T><<<nb, 256, 0, s>>>(ws + split * m_out * co, split,
                                          m_out, co, rows, br,
                                          static_cast<T*>(r), rpart,
                                          stats_rounded);
  return cudaGetLastError();
}

// mom[q][n]: the sum of the n_part moment partials part[i][q][n], in
// double in a fixed order (thread t takes i = t, t + 256, ..., then a
// tree), rounded to fp32; a block a (q, n), the residual's (rpart, rmom)
// the blocks past 2 co
__global__ void __launch_bounds__(256)
conv3_moment_sum(const float* __restrict__ ypart,
                 const float* __restrict__ rpart, int n_part, int co,
                 float* __restrict__ ymom, float* __restrict__ rmom) {
  __shared__ double red[256];
  const bool res = blockIdx.x >= 2 * co;
  const float* part = res ? rpart : ypart;
  float* mom = res ? rmom : ymom;
  const int qn = blockIdx.x % (2 * co);
  const int q = qn / co, n = qn % co;
  double s = 0.0;
  for (int i = threadIdx.x; i < n_part; i += 256)
    s += (double)part[((long long)i * 2 + q) * co + n];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) mom[qn] = (float)red[0];
}

// The moments' last sum (both bodies): the (2, co) sums mom (and rmom) of
// the n_part rows of partials part (and rpart); nothing where part is null.
inline cudaError_t launch_moment_sum(const float* part, const float* rpart,
                                     int n_part, int co, float* mom,
                                     float* rmom, cudaStream_t s) {
  if (part == nullptr) return cudaSuccess;
  conv3_moment_sum<<<(rpart != nullptr ? 4 : 2) * co, 256, 0, s>>>(
      part, rpart, n_part, co, mom, rmom);
  return cudaGetLastError();
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The output volume and the iteration grid of a (D, H, W) input, on either
// body's argument struct
template <class A>
A geometry(int D, int H, int W, int ci, int co, int mode) {
  A a{};
  a.D = D; a.H = H; a.W = W; a.ci = ci; a.co = co; a.mode = mode;
  if (mode == 1) {
    a.Do = (D - 1) / 2 + 1; a.Ho = (H - 1) / 2 + 1; a.Wo = (W - 1) / 2 + 1;
  } else if (mode == 2) {
    a.Do = 2 * D; a.Ho = 2 * H; a.Wo = 2 * W;
  } else {
    a.Do = D; a.Ho = H; a.Wo = W;
  }
  if (mode == 2) { a.Gd = D; a.Gh = H; a.Gw = W; }
  else { a.Gd = a.Do; a.Gh = a.Ho; a.Gw = a.Wo; }
  return a;
}

// the input extent of b outputs along an axis
inline int extent(int mode, int b) {
  return mode == 2 ? b + 1 : mode == 1 ? 2 * (b - 1) + 3 : b + 2;
}

// The arguments both C entries check alike; false where the call is
// malformed.
inline bool args_ok(const void* x2, const void* scale, const void* shift,
                    const void* wr, const void* r, const void* part,
                    const void* rpart, int D, int H, int W, int c1, int c2,
                    int co, int mode, int pro_act, const int* plan,
                    int halo_keep, int dsrc) {
  return !(D <= 0 || H <= 0 || W <= 0 || c1 <= 0 || c2 < 0 || co <= 0 ||
           c1 % 4 || c2 % 4 || co % 4 || mode < 0 || mode > 2 ||
           pro_act < 0 || pro_act > 3 || (c2 > 0) != (x2 != nullptr) ||
           plan == nullptr || plan[0] == 0 ||
           (scale == nullptr) != (shift == nullptr) ||
           (r != nullptr && (mode != 0 || scale != nullptr ||
                             wr == nullptr)) ||
           (rpart != nullptr && (r == nullptr || part == nullptr)) ||
           halo_keep < -1 || halo_keep > 3 || dsrc < 0 ||
           (dsrc > 0 && (halo_keep >= 0 || mode != 0 || r != nullptr ||
                         D != 2 * dsrc)));
}

}  // namespace
