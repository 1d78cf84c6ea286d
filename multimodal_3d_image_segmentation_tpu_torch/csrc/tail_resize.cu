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
// What bounds it on an H100: the bytes, above all the output write, 143 MB
// at the serving shape (4 x 240 x 240 x 155 fp32), against 18 MB of logits
// (0.048 ms at 3.35 TB/s). Measured, the kernel takes about 2.7 times
// that: copies without the exp and divide, or without the stores, took as
// long, and one without the input loads, the exp and divide and the stores
// still about 0.09 ms (PERF.md, section 6); what holds that skeleton back
// is not measured yet.
//
// Design: a block per output plane z and band of kBandRows output rows y.
// It reads the band's input rows along D once each (a thread per channel
// and input column, all its rows' loads in flight), then forms in shared
// memory the band's rows along H at every input column x, b[c][y][x], so
// that the D and H lerps of an input value are done once per output row,
// not once for each output voxel that reads it (about twice at the serving
// W ratio 155 / 78). Then each warp takes 128 consecutive voxels of the
// band's flattened rows, lane l the voxels l, l + 32, l + 64 and l + 96
// (neighbouring lanes read neighbouring taps and rows of b), lerps along W,
// takes the softmax and parks the probabilities in shared memory; lane l
// then writes voxels 4 l .. 4 l + 3 of each channel as one 16-byte store:
// a band starts at a multiple of 4 floats wherever H W is a multiple of 4
// (37,200 at the serving shape); other planes store one value at a time.
// Every value goes through the plain version's lerps along D, H and W,
// then expf and one divide, in that order, so a rerun and the design before
// it give the same bits.
//
// bf16 input (the JAX kernel's bf16 logits under compute_dtype 'bfloat16'
// and 'mixed'): each logit is widened to fp32 as it is read, and everything
// after is the fp32 kernel's; the probabilities are stored as fp32 or, for a
// bf16 output, rounded once to nearest even and stored 4 values (8 bytes) at
// a time where the fp32 output stores 16 bytes. The shared memory holds fp32
// rows either way, so its size does not depend on the types.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxC = 8;
constexpr int kBandRows = 16;  // output rows of a block (a multiple of 4)
constexpr int kTailThreads = 256;
constexpr int kWarpVoxels = 128;  // output voxels of a warp per round

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return fmaf(t, b, (1.f - t) * a);
}

// The most input rows a band of R output rows reads, h -> H: the taps of
// half-pixel centres span at most ceil((R - 1) h / H) + 2 rows.
inline int tail_input_rows(int R, int h, int H) {
  return std::min(h, (R - 1) * h / H + 3);
}

// Shared memory of a block of R rows, in floats: first the band's input
// rows along D (C x A x w), whose room each warp's probabilities take
// before they are stored (C x 128 a warp); the W taps (lo, hi, weight),
// the band's H taps (lo, hi, weight) and the rows b.
inline size_t tail_smem_floats(int C, int R, int h, int w, int H, int W) {
  return std::max((size_t)C * tail_input_rows(R, h, H) * w,
                  (size_t)kTailThreads / 32 * kWarpVoxels * C) +
         3 * (size_t)W + 3 * (size_t)R + (size_t)C * R * w;
}

// Tin: the logits' type, Tout: the probabilities', float or bf16
template <int C, class Tin, class Tout>
__global__ void __launch_bounds__(kTailThreads)
tail_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
            const int* __restrict__ taps, const float* __restrict__ wts,
            int d, int h, int w, int D, int H, int W, int R, int A) {
  extern __shared__ float4 smem4[];
  // first the band's input rows along D, then, in the same room, each
  // warp's probabilities before they are stored (16-byte aligned)
  float* a_s = reinterpret_cast<float*>(smem4);   // [C][A][w]
  float* st_s = a_s;                              // [warp][C][128]
  int* lo_s = reinterpret_cast<int*>(  // [W]
      a_s + max(C * A * w, kTailThreads / 32 * kWarpVoxels * C));
  int* hi_s = lo_s + W;                       // [W]
  float* wx_s = reinterpret_cast<float*>(hi_s + W);  // [W]
  int* y0_s = reinterpret_cast<int*>(wx_s + W);      // [R]
  int* y1_s = y0_s + R;                       // [R]
  float* wy_s = reinterpret_cast<float*>(y1_s + R);  // [R]
  float* b_s = wy_s + R;                      // [C][R][w]
  const int oz = blockIdx.y, oy0 = blockIdx.x * R;
  const int rows = min(R, H - oy0);
  const int tid = threadIdx.x;

  // taps: lo_d[D] hi_d[D] lo_h[H] hi_h[H] lo_w[W] hi_w[W]; wts: w_d w_h w_w
  for (int i = tid; i < W; i += kTailThreads) {
    lo_s[i] = __ldg(taps + 2 * D + 2 * H + i);
    hi_s[i] = __ldg(taps + 2 * D + 2 * H + W + i);
    wx_s[i] = __ldg(wts + D + H + i);
  }
  for (int i = tid; i < rows; i += kTailThreads) {
    y0_s[i] = __ldg(taps + 2 * D + oy0 + i);
    y1_s[i] = __ldg(taps + 2 * D + H + oy0 + i);
    wy_s[i] = __ldg(wts + D + oy0 + i);
  }
  __syncthreads();
  // the band's input rows y0 .. y0 + na - 1 along D, each once: a thread
  // per (channel, input column), all its rows' loads in flight together
  const int z0 = __ldg(taps + oz), z1 = __ldg(taps + D + oz);
  const float wz = __ldg(wts + oz);
  const int y0 = y0_s[0], na = y1_s[rows - 1] - y0 + 1;
  const size_t in_plane = (size_t)h * w, in_vol = (size_t)d * in_plane;
  for (int e = tid; e < C * w; e += kTailThreads) {
    const int c = e / w, xi = e - c * w;
    const Tin* p0 = x + c * in_vol + z0 * in_plane + (size_t)y0 * w + xi;
    const Tin* p1 = x + c * in_vol + z1 * in_plane + (size_t)y0 * w + xi;
    float* ac = a_s + c * A * w + xi;
#pragma unroll 8
    for (int y = 0; y < na; ++y)
      ac[y * w] = lerp(m3seg::to_float(__ldg(p0 + (size_t)y * w)),
                       m3seg::to_float(__ldg(p1 + (size_t)y * w)), wz);
  }
  __syncthreads();
  // then along H, into the band's rows
  for (int e = tid; e < C * w; e += kTailThreads) {
    const int c = e / w, xi = e - c * w;
    const float* ac = a_s + c * A * w + xi;
    float* bc = b_s + c * R * w + xi;
    for (int r = 0; r < rows; ++r)
      bc[r * w] = lerp(ac[(y0_s[r] - y0) * w], ac[(y1_s[r] - y0) * w],
                       wy_s[r]);
  }
  __syncthreads();

  // the W lerp and the softmax: a warp takes 128 consecutive voxels of the
  // band, lane l voxels l, l + 32, l + 64, l + 96 (so that neighbouring
  // lanes read neighbouring taps and rows), into its own corner of shared
  // memory; then lane l writes voxels 4 l .. 4 l + 3 of each channel
  const size_t hw = (size_t)H * W, n_out = D * hw;
  const bool vec = (hw & 3) == 0;  // every band 16-byte aligned
  const int np = rows * W, lane = tid % 32;
  Tout* ob = out + oz * hw + (size_t)oy0 * W;
  float* st = st_s + (tid / 32) * kWarpVoxels * C;  // [C][128]
  for (int j0 = tid / 32 * kWarpVoxels; j0 < np;
       j0 += kTailThreads / 32 * kWarpVoxels) {
    int r = (j0 + lane) / W, ox = j0 + lane - r * W;
#pragma unroll
    for (int u = 0; u < kWarpVoxels / 32; ++u) {
      if (j0 + 32 * u + lane < np) {
        const int x0 = lo_s[ox], x1 = hi_s[ox];
        const float wx = wx_s[ox];
        float v[C];
        float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float* row = b_s + (c * R + r) * w;
          v[c] = lerp(row[x0], row[x1], wx);
          m = fmaxf(m, v[c]);
        }
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          v[c] = expf(v[c] - m);
          sum += v[c];
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
          st[c * kWarpVoxels + 32 * u + lane] = v[c] / sum;
      }
      for (ox += 32; ox >= W; ox -= W) ++r;
    }
    __syncwarp();
    const int j = j0 + 4 * lane;
    if (vec && j + 4 <= np) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 p =
            *reinterpret_cast<const float4*>(st + c * kWarpVoxels + 4 * lane);
        if constexpr (sizeof(Tout) == 4)
          *reinterpret_cast<float4*>(ob + c * n_out + j) = p;
        else
          *reinterpret_cast<uint2*>(ob + c * n_out + j) =
              m3seg::float4_to_bf16x4(p);
      }
    } else {
      for (int k = 0; k < 4 && j + k < np; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c)
          ob[c * n_out + j + k] =
              m3seg::from_float<Tout>(st[c * kWarpVoxels + 4 * lane + k]);
    }
    __syncwarp();
  }
}

template <int C, class Tin, class Tout>
cudaError_t launch(const Tin* x, Tout* out, const int* taps,
                   const float* wts, int d, int h, int w, int D, int H,
                   int W, cudaStream_t stream) {
  // the most rows (a multiple of 4, at least 4) whose shared memory needs
  // no opt-in; past 48 KB at 4 rows, opt in
  int R = kBandRows;
  while (R > 4 &&
         tail_smem_floats(C, R, h, w, H, W) * sizeof(float) > 48 * 1024)
    R -= 4;
  const size_t smem = tail_smem_floats(C, R, h, w, H, W) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tail_kernel<C, Tin, Tout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  tail_kernel<C, Tin, Tout>
      <<<dim3((H + R - 1) / R, D), kTailThreads, smem, stream>>>(
          x, out, taps, wts, d, h, w, D, H, W, R, tail_input_rows(R, h, H));
  return cudaGetLastError();
}

template <class Tin, class Tout>
int entry(const void* x_, void* out_, const int* taps, const float* wts,
          int C, int d, int h, int w, int D, int H, int W, void* stream) {
  if (C < 1 || C > kMaxC || d < 1 || h < 1 || w < 1 || D < 1 || H < 1 ||
      W < 1 || D > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tin* x = static_cast<const Tin*>(x_);
  Tout* out = static_cast<Tout*>(out_);
  switch (C) {
    case 1: return (int)launch<1>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 2: return (int)launch<2>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 3: return (int)launch<3>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 4: return (int)launch<4>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 5: return (int)launch<5>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 6: return (int)launch<6>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 7: return (int)launch<7>(x, out, taps, wts, d, h, w, D, H, W, s);
    default: return (int)launch<8>(x, out, taps, wts, d, h, w, D, H, W, s);
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
  return entry<float, float>(x, out, taps, wts, C, d, h, w, D, H, W, stream);
}

// The bf16-input instance: x bf16 logits; out fp32 or, with out_bf16 set,
// bf16; otherwise as above.
M3SEG_API int m3seg_tail_resize_softmax_bf16(const void* x, void* out,
                                             int out_bf16, const int* taps,
                                             const float* wts, int C, int d,
                                             int h, int w, int D, int H,
                                             int W, void* stream) {
  if (out_bf16)
    return entry<__nv_bfloat16, __nv_bfloat16>(x, out, taps, wts, C, d, h,
                                               w, D, H, W, stream);
  return entry<__nv_bfloat16, float>(x, out, taps, wts, C, d, h, w, D, H, W,
                                     stream);
}

// Dynamic shared memory of a block of R output rows (tail_smem_floats), in
// bytes, which kernels/tail_resize.py's routing predicate follows; launches
// nothing.
M3SEG_API int m3seg_tail_smem_bytes(int C, int R, int h, int w, int H, int W,
                                    int* bytes) {
  if (C < 1 || C > kMaxC || R < 1 || h < 1 || w < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  *bytes = (int)(sizeof(float) * tail_smem_floats(C, R, h, w, H, W));
  return 0;
}
