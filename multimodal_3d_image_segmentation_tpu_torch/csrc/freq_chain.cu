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
// What bounds it on an H100: nothing but launch latency and memory. The
// serving shape is 15,680 rows x 24 channels, n = 3: about 1.5 MB read +
// written and 54 MFLOP per call, 8 calls per volume.
//
// Design: one thread per row. The row lives in registers for the whole
// chain (C is a template parameter, so the C x C product unrolls), all n
// weight matrices sit in shared memory (3 x 24 x 24 fp32 = 6.9 KB) and are
// read as warp-wide broadcasts, and each row crosses device memory once in
// and once out, as 16-byte vector loads and stores.
#include "common.cuh"

namespace {

template <int C>
__global__ void freq_chain_kernel(const float* __restrict__ x,
                                  const float* __restrict__ wt,
                                  float* __restrict__ out, long long n_rows,
                                  int n_chain) {
  extern __shared__ float w_s[];  // [k][i][o] = W_k[o][i]
  const int total = n_chain * C * C;
  for (int t = threadIdx.x; t < total; t += blockDim.x) w_s[t] = wt[t];
  __syncthreads();

  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= n_rows) return;

  float v[C];
  const float4* src = reinterpret_cast<const float4*>(x + row * C);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 t = src[q];
    v[4 * q + 0] = t.x;
    v[4 * q + 1] = t.y;
    v[4 * q + 2] = t.z;
    v[4 * q + 3] = t.w;
  }

  for (int k = 0; k < n_chain; ++k) {
    const float* wk = w_s + k * C * C;
    float h[C];
#pragma unroll
    for (int o = 0; o < C; ++o) h[o] = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const float xi = v[i];
#pragma unroll
      for (int o = 0; o < C; ++o) h[o] = fmaf(xi, wk[i * C + o], h[o]);
    }
#pragma unroll
    for (int o = 0; o < C; ++o) v[o] = m3seg::selu(h[o] + v[o]);
  }

  float4* dst = reinterpret_cast<float4*>(out + row * C);
#pragma unroll
  for (int q = 0; q < C / 4; ++q)
    dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int C>
cudaError_t launch(const float* x, const float* wt, float* out,
                   long long n_rows, int n_chain, cudaStream_t stream) {
  const int threads = 64;
  const long long blocks = (n_rows + threads - 1) / threads;
  const size_t smem = sizeof(float) * n_chain * C * C;
  freq_chain_kernel<C><<<(unsigned)blocks, threads, smem, stream>>>(
      x, wt, out, n_rows, n_chain);
  return cudaGetLastError();
}

}  // namespace

// x, out: (n_rows, c) fp32, contiguous, 16-byte aligned.
// wt: (n_chain, c, c) fp32 with wt[k][i][o] = W_k[o][i].
M3SEG_API int m3seg_freq_chain(const float* x, const float* wt, float* out,
                               long long n_rows, int c, int n_chain,
                               void* stream) {
  if (n_rows <= 0 || n_chain <= 0 ||
      sizeof(float) * n_chain * c * c > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 8: return (int)launch<8>(x, wt, out, n_rows, n_chain, s);
    case 24: return (int)launch<24>(x, wt, out, n_rows, n_chain, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Message for a status returned by any entry point of the library.
M3SEG_API const char* m3seg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
