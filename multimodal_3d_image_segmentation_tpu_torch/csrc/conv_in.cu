// Fused input-downsampling convolution (k=2, s=2, pad=1) + bias (+ SELU).
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/conv_in.py
//   conv_in_s2d, both Pallas variants (_conv_in_impl / _kernel for odd D or
//   H after an XLA pad, and _conv_in_raw_impl / _raw_kernel reading the raw
//   channel-first input). The two differ only in what Mosaic could express;
//   here skipped taps take the place of both.
//
// Each output voxel (z, y, x) of the (B, D/2+1, H/2+1, W/2+1, F)
// channels-last output reads the 2x2x2 window at input (2z-1.., 2y-1..,
// 2x-1..) of all C channels of the channel-first (B, C, D, H, W) input,
// with the pad=1 border realized as skipped taps.
//
// What bounds it on an H100: the bytes in principle, the issue slots in
// practice. At the serving shape it reads 143 MB (4 x 240 x 240 x 155
// fp32) and writes 110 MB (121 x 121 x 78 x 24 fp32), 0.075 ms at 3.35
// TB/s; but its 0.88 G FMAs, the shared-memory loads that feed them and 27 M
// SELUs (an expm1f each) take as long again: copies of this kernel without
// the arithmetic, or without the loads, each take about 0.1 ms, the whole
// about 0.155 (PERF.md, section 6).
//
// Design: a block per band, a band being (batch, output plane z, R output
// rows) over the whole width W. For each channel and each of the two input
// planes a band reads, its input rows 2y0-1 .. 2y0+2R-2 are one contiguous
// span of the input; the block copies its spans into shared memory with
// cp.async, 16 bytes a copy over each span's aligned interior and 4 at its
// ends (a span keeps its address's offset modulo 16 bytes in shared memory,
// so the 16-byte copies line up on both sides, and x need only be 4-byte
// aligned). The weights come in their torch layout (F, C, 2, 2, 2) and are
// transposed on the way into shared memory, to rows ((kz*2+ky)*2+kx)*C + c
// of F floats, read as 16-byte broadcasts; at C = 4 the channel loops
// unroll. Thread (r, t) computes the voxels x = t, t + nt, ... of row r, one
// at a time with F accumulators in registers (neighbouring lanes read
// neighbouring taps), and parks them in shared memory. Then the whole block
// applies the SELU while it stores the band: the accumulators are dead by
// then, so many expm1f are in flight at once. The band covers whole rows, so
// its outputs leave as one contiguous span of the output in coalesced
// 16-byte stores. At the serving shape a band is 2 rows, 160 threads; at
// most 64 registers a thread (four 256-thread blocks an SM), so that five or
// six bands share an SM. Block coordinates come from blockIdx; no per-voxel
// division.
//
// Bits: each output is the bias, then fmaf over the taps in (kz, ky, kx, c)
// order, skipping taps outside the volume, then m3seg::selu: the order of
// the one-thread-per-voxel design it replaces, so both give the same bits.
// Padded taps are skipped, not read as zeros, since a 0 * w term can turn
// a -0 into +0 or an infinite weight into NaN.
//
// The bf16 instance (compute_dtype 'bfloat16' and 'mixed') is
// conv_in_mma.cu, on the tensor cores.
//
// Limits: a band's spans and outputs must fit the 227 KB of shared memory a
// block can have at R = 1, about (16 C + 2 F) W bytes (W <= 2,000 at C = 4,
// F = 24); the entry point returns cudaErrorInvalidValue for wider volumes.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTargetThreads = 128;  // the least threads a band aims at
constexpr int kMaxRows = 8;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A band of R output rows: nt threads a row, the block's threads, the
// pitch of an input span in shared memory (floats, a multiple of 4, with
// room for the span's offset modulo 16 bytes) and the shared memory of a
// block.
struct Plan {
  int R, nt, threads, pitch;
  size_t smem;
};

// floats before the spans: weights, bias, then 2 C span offsets (ints),
// rounded up to a multiple of 4
__host__ __device__ inline int head_floats(int C, int F) {
  return (8 * C * F + F + 2 * C + 3) / 4 * 4;
}

inline Plan make_plan(int C, int H2, int W, int W2, int F, int max_shift) {
  Plan p{};
  p.nt = std::min(W2, kMaxThreads);
  int R = std::min(std::min(kMaxRows, H2),
                   std::max(1, std::min(kTargetThreads + p.nt - 1,
                                        kMaxThreads) / p.nt));
  for (; R >= 1; --R) {
    p.R = R;
    p.pitch = (2 * R * W + max_shift + 3) / 4 * 4;
    p.threads = (R * p.nt + 31) / 32 * 32;
    p.smem = sizeof(float) * (head_floats(C, F) + (size_t)2 * C * p.pitch +
                              (size_t)R * W2 * F);
    if (p.smem <= kMaxSmem) return p;
  }
  p.R = 0;
  return p;
}

__device__ __forceinline__ float4 selu4(float4 y) {
  return make_float4(m3seg::selu(y.x), m3seg::selu(y.y), m3seg::selu(y.z),
                     m3seg::selu(y.w));
}

// CT: the channel count where the instance fixes it (the channel loops
// unroll), else 0.
template <int F, int CT>
__global__ void __launch_bounds__(kMaxThreads, 4)
conv_in_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int C_, int D, int H, int W, int D2, int H2, int W2, int R,
               int nt, int pitch, int apply_selu) {
  const int C = CT > 0 ? CT : C_;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [(k*C + c)*F + f]
  float* bs = ws + 8 * C * F;                    // [F]
  int* sbase = reinterpret_cast<int*>(bs + F);   // [c*2 + kz]
  float* s_in = ws + head_floats(C, F);          // [c*2 + kz][pitch]
  float* s_out = s_in + 2 * C * pitch;           // [r][x][f]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int oy0 = blockIdx.x * R, oz = blockIdx.y, b = blockIdx.z;
  const int iy_lo = max(2 * oy0 - 1, 0);
  const int iy_hi = min(2 * (oy0 + R) - 2, H - 1);
  const int n_span = (iy_hi - iy_lo + 1) * W;
  const long long plane = (long long)H * W;

  // input spans: rows iy_lo .. iy_hi of plane iz of each channel. A span
  // keeps its offset modulo 16 bytes (kVec values, from its address) in
  // shared memory, so that its aligned interior moves in 16-byte words;
  // head and tail values go one at a time.
  constexpr int kVec = 4;
  struct Span {
    const float* src;
    int dst, head, nv, tail;  // dst: its first value's place in s_in
  };
  auto span_of = [&](int s, Span& sp) -> bool {
    const int c = s >> 1, iz = 2 * oz + (s & 1) - 1;
    if (iz < 0 || iz >= D) return false;
    sp.src = x + ((long long)(b * C + c) * D + iz) * plane +
             (long long)iy_lo * W;
    const int shift = (int)((reinterpret_cast<uintptr_t>(sp.src) /
                             sizeof(float)) & (kVec - 1));
    sp.head = min((kVec - shift) & (kVec - 1), n_span);
    sp.nv = (n_span - sp.head) / kVec;
    sp.tail = n_span - sp.head - kVec * sp.nv;
    sp.dst = s * pitch + shift;
    return true;
  };
  for (int s = 0; s < 2 * C; ++s) {
    Span sp;
    if (!span_of(s, sp)) continue;
    if (tid == 0) sbase[s] = sp.dst - iy_lo * W;
    float* dst = s_in + sp.dst;
    const float* src = sp.src;
    for (int e = tid; e < sp.nv; e += nthr)
      cp_async16(dst + sp.head + 4 * e, src + sp.head + 4 * e);
    if (tid < sp.head) cp_async4(dst + tid, src + tid);
    if (tid < sp.tail) cp_async4(dst + sp.head + 4 * sp.nv + tid,
                                 src + sp.head + 4 * sp.nv + tid);
  }
  // weights, (F, C, kz, ky, kx) -> [((kz*2+ky)*2+kx)*C + c][f]
  for (int e = tid; e < 8 * C * F; e += nthr) {
    const int f = e / (8 * C), rem = e - f * 8 * C;
    ws[((rem & 7) * C + (rem >> 3)) * F + f] = w[e];
  }
  for (int f = tid; f < F; f += nthr) bs[f] = bias[f];
  cp_async_wait_all();
  __syncthreads();

  const int r = tid / nt, oy = oy0 + r;
  const bool active = r < R && oy < H2;
  for (int ox = tid - r * nt; active && ox < W2; ox += nt) {
    float a[F];
#pragma unroll
    for (int f = 0; f < F; ++f) a[f] = bs[f];
#pragma unroll
    for (int kz = 0; kz < 2; ++kz) {
      const int iz = 2 * oz + kz - 1;
      if (iz < 0 || iz >= D) continue;
#pragma unroll
      for (int ky = 0; ky < 2; ++ky) {
        const int iy = 2 * oy + ky - 1;
        if (iy < 0 || iy >= H) continue;
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
          const int ix = 2 * ox + kx - 1;
          if (ix < 0 || ix >= W) continue;
          const float4* wk = reinterpret_cast<const float4*>(
              ws + ((kz * 2 + ky) * 2 + kx) * C * F);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float v = s_in[sbase[2 * c + kz] + iy * W + ix];
#pragma unroll
            for (int q = 0; q < F / 4; ++q) {
              const float4 wq = wk[c * (F / 4) + q];
              a[4 * q + 0] = fmaf(v, wq.x, a[4 * q + 0]);
              a[4 * q + 1] = fmaf(v, wq.y, a[4 * q + 1]);
              a[4 * q + 2] = fmaf(v, wq.z, a[4 * q + 2]);
              a[4 * q + 3] = fmaf(v, wq.w, a[4 * q + 3]);
            }
          }
        }
      }
    }
    float4* d = reinterpret_cast<float4*>(s_out + (r * W2 + ox) * F);
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      d[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }
  __syncthreads();

  // the band's rows are one contiguous span of the output; the SELU here,
  // on every thread's share of the band
  const int n4 = min(R, H2 - oy0) * W2 * (F / 4);
  float* const band = out + (((long long)b * D2 + oz) * H2 + oy0) * W2 * F;
  const float4* src = reinterpret_cast<const float4*>(s_out);
  float4* dst = reinterpret_cast<float4*>(band);
  if (apply_selu) {
    for (int e = tid; e < n4; e += nthr) dst[e] = selu4(src[e]);
  } else {
    for (int e = tid; e < n4; e += nthr) dst[e] = src[e];
  }
}

template <int F, int CT>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, int B, int C, int D, int H, int W,
                   int apply_selu, cudaStream_t stream) {
  const int D2 = D / 2 + 1, H2 = H / 2 + 1, W2 = W / 2 + 1;
  const Plan p = make_plan(C, H2, W, W2, F, 3);
  if (p.R == 0) return cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_in_kernel<F, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((H2 + p.R - 1) / p.R, D2, B);
  conv_in_kernel<F, CT><<<grid, p.threads, p.smem, stream>>>(
      x, w, bias, out, C, D, H, W, D2, H2, W2, p.R, p.nt, p.pitch,
      apply_selu);
  return cudaGetLastError();
}

}  // namespace

// x: (B, C, D, H, W) fp32 contiguous, at any 4-byte alignment. w:
// (F, C, 2, 2, 2) fp32 contiguous, the torch layout. bias: (F,). out:
// (B, D/2+1, H/2+1, W/2+1, F) fp32 contiguous, 16-byte aligned.
M3SEG_API int m3seg_conv_in(const float* x, const float* w,
                            const float* bias, float* out, int B, int C,
                            int D, int H, int W, int F, int apply_selu,
                            void* stream) {
  if (B <= 0 || C <= 0 || D <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      D / 2 + 1 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // C = 4: the four MRI modalities of every config, channel loops unrolled
  switch (F * (C == 4 ? -1 : 1)) {
    case -8: return (int)launch<8, 4>(x, w, bias, out, B, C, D, H, W, apply_selu, s);
    case 8: return (int)launch<8, 0>(x, w, bias, out, B, C, D, H, W, apply_selu, s);
    case -24: return (int)launch<24, 4>(x, w, bias, out, B, C, D, H, W, apply_selu, s);
    case 24: return (int)launch<24, 0>(x, w, bias, out, B, C, D, H, W, apply_selu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
