// Fused frequency-resident convolution chain of HNOSeg-XS.
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/freq_chain.py
//   fused_freq_chain (pallas_call in _pallas_rows, body _kernel).
//
// Computes, for every row r of the packed spectrum (rows = batch x kept
// modes, C channels each) and k = 0..n-1:
//     x_r <- selu(x_r @ W_k^T + x_r)
// in exact fp32 FMA (no TF32), matching the HIGHEST-precision JAX kernel.
//
// What bounds it on an H100: not the bytes. The serving shape is 15,680
// rows x 24 channels, n = 3: 3 MB read and written and 54 MFLOP a call
// (0.9 us at 3.35 TB/s), 8 calls per volume. What is left is the launch,
// the chain's three dependent steps and the shared-memory reads that feed
// them: each step a lane reads the whole row and its outputs' weights for
// every input (PERF.md, section 6: 1, 2, 4 and 8 lanes a row timed).
//
// Design: two lanes of a warp share a row (12 outputs each at C = 24, 4 at
// C = 8), so a warp holds 16 rows and a 256-thread block 128: at the serving
// shape 123 blocks, one wave. A warp reads its rows as one contiguous span
// in 16-byte loads (4-byte ones where x is not 16-byte aligned) into shared
// memory, where the rows stay through the chain: at each step a lane reads
// the row as 16-byte broadcasts, forms its outputs from 16-byte loads of
// their weights, and writes them back between two __syncwarp, so no
// block-wide barrier follows the weights' one. The n <= 8 weights come in
// their torch layout (out, in), one pointer each in a struct passed by
// value, and are transposed on the way into shared memory, all of a thread's
// loads issued before its stores.
//
// Bits: each output is h = 0, then fmaf over the inputs i in ascending
// order, then selu(h + x_o): the order of the one-thread-per-row kernel it
// replaces, so both give the same bits.
//
// bf16 (the JAX kernel under compute_dtype 'bfloat16', whose rows and
// weights are both bf16): the rows are widened to fp32 as they enter shared
// memory (16-byte loads of 8 values where x is 16-byte aligned, else 2-byte
// ones), the weights as they are transposed; the sums and the SELU run in
// fp32 as above, and each stage's output is rounded to bf16 (nearest even)
// before the next stage reads it, as the JAX kernel's
// ``.astype(acc.dtype)`` rounds after every stage.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxChain = 8;
constexpr int kThreads = 256;
constexpr int kLanes = 2;  // lanes of a row

template <class T>
struct ChainWeights {
  const T* w[kMaxChain];  // W_k, (C, C) row-major (out, in)
};

// T: the type of the rows and weights, float or bf16
template <int C, class T>
__global__ void __launch_bounds__(kThreads)
freq_chain_kernel(const T* __restrict__ x, ChainWeights<T> wts,
                  T* __restrict__ out, long long n_rows, int n_chain) {
  constexpr int OPL = C / kLanes;   // outputs of a lane
  constexpr int RPW = 32 / kLanes;  // rows of a warp
  constexpr int N4 = RPW * C / 4;   // float4 words of a warp's rows
  constexpr int kPer = (C * C + kThreads - 1) / kThreads;
  static_assert(OPL % 4 == 0);
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [k][i][o] = W_k[o][i]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* v = ws + n_chain * C * C + warp * RPW * C;  // [row][C]

  // the warp's rows: one span of RPW * C values, read in 16-byte loads
  // where x is 16-byte aligned, else one value at a time
  const long long row0 = ((long long)blockIdx.x * (kThreads / 32) + warp) *
                         RPW;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    if constexpr (sizeof(T) == 4) {
      for (int q = lane; q < N4; q += 32)
        if (row0 * C + 4 * q < n_rows * C)
          reinterpret_cast<float4*>(v)[q] =
              *reinterpret_cast<const float4*>(x + row0 * C + 4 * q);
    } else {  // 8 values a load; C is a multiple of 8
      for (int q = lane; q < N4 / 2; q += 32)
        if (row0 * C + 8 * q < n_rows * C)
          m3seg::bf16x8_to_float4x2(
              *reinterpret_cast<const uint4*>(x + row0 * C + 8 * q),
              reinterpret_cast<float4*>(v) + 2 * q);
    }
  } else {
    for (int e = lane; e < RPW * C; e += 32)
      if (row0 * C + e < n_rows * C) v[e] = m3seg::to_float(x[row0 * C + e]);
  }
  // the weights transposed, neighbouring threads on neighbouring words of
  // shared memory; all of a thread's loads are issued before its stores
  float wv[kMaxChain][kPer];
#pragma unroll
  for (int k = 0; k < kMaxChain; ++k)
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = tid + m * kThreads;
      if (k < n_chain && e < C * C)
        wv[k][m] = m3seg::to_float(wts.w[k][e % C * C + e / C]);
    }
#pragma unroll
  for (int k = 0; k < kMaxChain; ++k)
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = tid + m * kThreads;
      if (k < n_chain && e < C * C) ws[k * C * C + e] = wv[k][m];
    }
  __syncthreads();

  const int l = lane % kLanes;
  float* vr = v + (lane / kLanes) * C;
  for (int k = 0; k < n_chain; ++k) {
    const float* wk = ws + k * C * C + l * OPL;
    float h[OPL];
#pragma unroll
    for (int o = 0; o < OPL; ++o) h[o] = 0.f;
#pragma unroll
    for (int i4 = 0; i4 < C / 4; ++i4) {
      const float4 xq = reinterpret_cast<const float4*>(vr)[i4];
      const float xi[4] = {xq.x, xq.y, xq.z, xq.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4* w4 = reinterpret_cast<const float4*>(
            wk + (4 * i4 + j) * C);
#pragma unroll
        for (int q = 0; q < OPL / 4; ++q) {
          const float4 wq = w4[q];
          h[4 * q + 0] = fmaf(xi[j], wq.x, h[4 * q + 0]);
          h[4 * q + 1] = fmaf(xi[j], wq.y, h[4 * q + 1]);
          h[4 * q + 2] = fmaf(xi[j], wq.z, h[4 * q + 2]);
          h[4 * q + 3] = fmaf(xi[j], wq.w, h[4 * q + 3]);
        }
      }
    }
    float nv[OPL];
#pragma unroll
    for (int o = 0; o < OPL; ++o)
      nv[o] = m3seg::round_to<T>(m3seg::selu(h[o] + vr[l * OPL + o]));
    __syncwarp();  // both lanes of the row have read it
#pragma unroll
    for (int o = 0; o < OPL; ++o) vr[l * OPL + o] = nv[o];
    __syncwarp();
  }

  const float4* v4 = reinterpret_cast<const float4*>(v);
  if constexpr (sizeof(T) == 4) {
    for (int q = lane; q < N4; q += 32)
      if (row0 * C + 4 * q < n_rows * C)
        *reinterpret_cast<float4*>(out + row0 * C + 4 * q) = v4[q];
  } else {  // exact: every value already holds a bf16
    for (int q = lane; q < N4 / 2; q += 32)
      if (row0 * C + 8 * q < n_rows * C)
        *reinterpret_cast<uint4*>(out + row0 * C + 8 * q) =
            m3seg::float4x2_to_bf16x8(v4[2 * q], v4[2 * q + 1]);
  }
}

template <int C, class T>
cudaError_t launch(const T* x, const ChainWeights<T>& w, T* out,
                   long long n_rows, int n_chain, cudaStream_t stream) {
  constexpr long long rows_per_block = kThreads / kLanes;
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const size_t smem =
      sizeof(float) * ((size_t)n_chain * C * C + rows_per_block * C);
  freq_chain_kernel<C, T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, w, out, n_rows, n_chain);
  return cudaGetLastError();
}

template <class T>
int entry(const void* x, const void* const* weights, void* out,
          long long n_rows, int c, int n_chain, void* stream) {
  if (n_rows <= 0 || n_chain <= 0 || n_chain > kMaxChain ||
      sizeof(float) * n_chain * c * c > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  ChainWeights<T> w{};
  for (int k = 0; k < n_chain; ++k) w.w[k] = static_cast<const T*>(weights[k]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (c) {
    case 8: return (int)launch<8>(xt, w, ot, n_rows, n_chain, s);
    case 24: return (int)launch<24>(xt, w, ot, n_rows, n_chain, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (n_rows, c) fp32, contiguous, at any 4-byte alignment. out: the same,
// 16-byte aligned. weights: a host array of n_chain <= 8 device pointers,
// W_k as (c, c) fp32 contiguous (out, in), the torch layout.
M3SEG_API int m3seg_freq_chain(const float* x, const float* const* weights,
                               float* out, long long n_rows, int c,
                               int n_chain, void* stream) {
  return entry<float>(x, reinterpret_cast<const void* const*>(weights), out,
                      n_rows, c, n_chain, stream);
}

// The bf16 instance: x, out and the weights bf16 (x at any 2-byte
// alignment), as above.
M3SEG_API int m3seg_freq_chain_bf16(const void* x, const void* const* weights,
                                    void* out, long long n_rows, int c,
                                    int n_chain, void* stream) {
  return entry<__nv_bfloat16>(x, weights, out, n_rows, c, n_chain, stream);
}

// Message for a status returned by any entry point of the library.
M3SEG_API const char* m3seg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
