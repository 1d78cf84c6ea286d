// Fused input-downsampling convolution (k=2, s=2, pad=1) + bias (+ SELU).
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/conv_in.py
//   conv_in_s2d, both Pallas variants (_conv_in_impl / _kernel for odd D or
//   H after an XLA pad, and _conv_in_raw_impl / _raw_kernel reading the raw
//   channel-first input). The two differ only in what Mosaic could express;
//   here bounds checks take the place of both.
//
// Each output voxel (z, y, x) of the (B, D/2+1, H/2+1, W/2+1, F)
// channels-last output reads the 2x2x2 window at input (2z-1.., 2y-1..,
// 2x-1..) of all C channels of the channel-first (B, C, D, H, W) input,
// with the pad=1 border realized as skipped taps, and writes its F outputs
// contiguously.
//
// What bounds it on an H100: memory. At the serving shape it reads 143 MB
// (4 x 240 x 240 x 155 fp32) and writes 110 MB (121 x 121 x 78 x 24 fp32);
// 8 x C x F multiply-adds per voxel are far below the FP32 rate.
//
// Design: one thread per output voxel, W fastest across the warp, so the
// input rows are read as contiguous spans (each input element is used by
// exactly one thread and the two W taps share cache lines) and the output
// is written as one contiguous run of F-float records in 16-byte stores.
// The 8 x C x F weights (768 floats for C=4, F=24) and the bias sit in
// shared memory and are read as warp-wide broadcasts; the F accumulators
// live in registers (F is a template parameter).
#include "common.cuh"

namespace {

template <int F>
__global__ void conv_in_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int B, int C, int D,
                               int H, int W, int D2, int H2, int W2,
                               int apply_selu) {
  extern __shared__ float s[];  // w: [((kz*2+ky)*2+kx)*C + c][f], then bias
  const int n_w = 8 * C * F;
  for (int t = threadIdx.x; t < n_w + F; t += blockDim.x)
    s[t] = t < n_w ? w[t] : bias[t - n_w];
  __syncthreads();

  const long long total = (long long)B * D2 * H2 * W2;
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ox = (int)(idx % W2);
  long long t = idx / W2;
  const int oy = (int)(t % H2);
  t /= H2;
  const int oz = (int)(t % D2);
  const int b = (int)(t / D2);

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = s[n_w + f];

  const long long plane = (long long)H * W;
  const long long vol = (long long)D * plane;
  for (int kz = 0; kz < 2; ++kz) {
    const int iz = 2 * oz + kz - 1;
    if (iz < 0 || iz >= D) continue;
    for (int ky = 0; ky < 2; ++ky) {
      const int iy = 2 * oy + ky - 1;
      if (iy < 0 || iy >= H) continue;
      for (int kx = 0; kx < 2; ++kx) {
        const int ix = 2 * ox + kx - 1;
        if (ix < 0 || ix >= W) continue;
        const float* xp = x + (long long)b * C * vol + iz * plane +
                          (long long)iy * W + ix;
        const float* wp = s + ((kz * 2 + ky) * 2 + kx) * C * F;
        for (int c = 0; c < C; ++c) {
          const float v = xp[c * vol];
          const float* wr = wp + c * F;
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] = fmaf(v, wr[f], acc[f]);
        }
      }
    }
  }

  if (apply_selu) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = m3seg::selu(acc[f]);
  }
  float4* dst = reinterpret_cast<float4*>(out + idx * F);
#pragma unroll
  for (int q = 0; q < F / 4; ++q)
    dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                         acc[4 * q + 3]);
}

template <int F>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, int B, int C, int D, int H, int W,
                   int apply_selu, cudaStream_t stream) {
  const int D2 = D / 2 + 1, H2 = H / 2 + 1, W2 = W / 2 + 1;
  const long long total = (long long)B * D2 * H2 * W2;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  const size_t smem = sizeof(float) * (8 * C * F + F);
  conv_in_kernel<F><<<(unsigned)blocks, threads, smem, stream>>>(
      x, w, bias, out, B, C, D, H, W, D2, H2, W2, apply_selu);
  return cudaGetLastError();
}

}  // namespace

// x: (B, C, D, H, W) fp32 contiguous. w: (8*C, F) fp32, row
// ((kz*2+ky)*2+kx)*C + c. bias: (F,). out: (B, D/2+1, H/2+1, W/2+1, F)
// fp32 contiguous, 16-byte aligned.
M3SEG_API int m3seg_conv_in(const float* x, const float* w,
                            const float* bias, float* out, int B, int C,
                            int D, int H, int W, int F, int apply_selu,
                            void* stream) {
  if (B <= 0 || C <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      sizeof(float) * (8 * C * F + F) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 8: return (int)launch<8>(x, w, bias, out, B, C, D, H, W, apply_selu, s);
    case 24: return (int)launch<24>(x, w, bias, out, B, C, D, H, W, apply_selu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
