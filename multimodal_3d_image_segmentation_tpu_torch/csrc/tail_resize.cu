// Fused trilinear upsample (align_corners=False) + channel softmax: the
// output tail of every model family.
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/tail_resize.py
//   fused_tail_softmax (pallas_call in _tail_impl, body _tail_kernel).
//
// For each output voxel (z, y, x) of the (1, C, D, H, W) output and each
// of the C <= 8 channels, interpolate the (1, C, d, h, w) logits along D,
// then H, then W (the order of the plain version's per-axis products),
// then take a fp32 softmax over the C values and store the probabilities.
// The per-axis tap tables (lo, hi, w_hi) come from the host, computed in
// float64 by ops/resize.py::_linear_taps_np, so the kernel and the plain
// interpolation matrices agree on every tap; nothing recomputes source
// coordinates in fp32 here.
//
// What bounds it on an H100: the output write, 143 MB at the serving shape
// (4 x 240 x 240 x 155 fp32). The 18 MB input stays resident in the 50 MB
// L2 cache, so its eight-fold gather costs L2, not device-memory, traffic.
//
// Design: one thread per output voxel with W fastest, so every per-channel
// store of a warp is one contiguous 128-byte run; the intermediate resized
// volume and the logits at full size never touch device memory.
#include "common.cuh"

namespace {

constexpr int kMaxC = 8;

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return fmaf(t, b, (1.f - t) * a);
}

__global__ void tail_kernel(const float* __restrict__ x,
                            float* __restrict__ out,
                            const int* __restrict__ taps,
                            const float* __restrict__ wts, int C, int d,
                            int h, int w, int D, int H, int W) {
  const long long n_out = (long long)D * H * W;
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int ox = (int)(idx % W);
  const long long t = idx / W;
  const int oy = (int)(t % H);
  const int oz = (int)(t / H);

  // taps: lo_d[D] hi_d[D] lo_h[H] hi_h[H] lo_w[W] hi_w[W]; wts: w_d w_h w_w
  const int z0 = taps[oz], z1 = taps[D + oz];
  const int y0 = taps[2 * D + oy], y1 = taps[2 * D + H + oy];
  const int x0 = taps[2 * D + 2 * H + ox], x1 = taps[2 * D + 2 * H + W + ox];
  const float wz = wts[oz], wy = wts[D + oy], wx = wts[D + H + ox];

  const long long in_plane = (long long)h * w;
  const long long in_vol = (long long)d * in_plane;
  const long long r00 = z0 * in_plane + (long long)y0 * w;
  const long long r01 = z0 * in_plane + (long long)y1 * w;
  const long long r10 = z1 * in_plane + (long long)y0 * w;
  const long long r11 = z1 * in_plane + (long long)y1 * w;

  float v[kMaxC];
  float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      const float* xc = x + c * in_vol;
      // D first at the four (y, x) corners, then H, then W
      const float a00 = lerp(xc[r00 + x0], xc[r10 + x0], wz);
      const float a01 = lerp(xc[r00 + x1], xc[r10 + x1], wz);
      const float a10 = lerp(xc[r01 + x0], xc[r11 + x0], wz);
      const float a11 = lerp(xc[r01 + x1], xc[r11 + x1], wz);
      const float b0 = lerp(a00, a10, wy);
      const float b1 = lerp(a01, a11, wy);
      v[c] = lerp(b0, b1, wx);
      m = fmaxf(m, v[c]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      v[c] = expf(v[c] - m);
      sum += v[c];
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) out[c * n_out + idx] = v[c] / sum;
  }
}

}  // namespace

// x: (1, C, d, h, w) fp32 contiguous logits; out: (1, C, D, H, W) fp32
// contiguous. taps: int32 [lo_d, hi_d, lo_h, hi_h, lo_w, hi_w] (lengths
// D, D, H, H, W, W); wts: fp32 [w_d, w_h, w_w] (the hi-tap weights).
M3SEG_API int m3seg_tail_resize_softmax(const float* x, float* out,
                                        const int* taps, const float* wts,
                                        int C, int d, int h, int w, int D,
                                        int H, int W, void* stream) {
  if (C < 1 || C > kMaxC || d < 1 || h < 1 || w < 1 || D < 1 || H < 1 ||
      W < 1)
    return (int)cudaErrorInvalidValue;
  const long long n_out = (long long)D * H * W;
  const int threads = 256;
  const long long blocks = (n_out + threads - 1) / threads;
  tail_kernel<<<(unsigned)blocks, threads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, out, taps, wts, C, d,
                                                     h, w, D, H, W);
  return (int)cudaGetLastError();
}
