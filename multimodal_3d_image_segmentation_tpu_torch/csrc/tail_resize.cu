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
// coordinates in fp32 here. hi is lo + 1, or lo at the last input row.
//
// Two designs, one per logit type, giving the same bits:
//
// fp32 logits (tail_kernel_fp32, namespace band): a block per output plane
// z and band of R output rows (the most rows, a multiple of 4, within 48
// KB of shared memory). It reads the band's input rows along D from device
// memory once each (a thread per channel and input column, all its rows'
// loads in flight), forms the band's rows along H at every input column in
// shared memory, then each warp takes 128 consecutive voxels of the band,
// lane l the voxels l, l + 32, l + 64 and l + 96, lerps along W, takes the
// softmax and parks the probabilities in shared memory; lane l then writes
// voxels 4 l .. 4 l + 3 of each channel as one 16-byte store (a band starts
// at a multiple of 4 floats wherever H W is a multiple of 4; other planes
// store one value at a time). On fp32 logits this design is the faster of
// the two at the serving shape on an H100 (0.101 against 0.117 ms back to
// back, NVIDIA H100 80GB HBM3 at 700 W; PERF.md, section 6).
//
// bf16 logits (tail_kernel, the compute_dtype 'bfloat16' and 'mixed'
// serving paths), fp32 or bf16 probabilities. What bounds it on an H100:
// the bytes, above all the output write: at the serving shape 143 MB of
// fp32 probabilities (4 x 240 x 240 x 155) or 71 MB of bf16 ones, against
// 9 MB of logits: 0.045 / 0.024 ms at 3.35 TB/s. Next, the issue slots:
// the W lerps, expf and the IEEE divides take about 100 instructions a
// voxel, eight of them on the SFU (ex2 and rcp). A block that loads its
// taps and lerps its rows between barriers before its first store stops
// the SM's store stream for each band; persistent blocks that copy the
// next tile's rows while they store keep it going.
//
// Design: a persistent grid (as many blocks as fit on the SMs, four at the
// serving shape) walks a strided list of tiles (output plane z, band of R
// output rows). Each block loads the W taps once. A tile's input is 2C
// spans (channel c, input plane z0 or z1): the rows its band reads, one
// contiguous run of the logits each, copied raw with 16-byte cp.async over
// the 16-byte words that cover it (a span keeps its offset modulo 16
// bytes), with the tile's D and H taps, into the stage. Per tile, between
// barriers:
//   - the D lerp, each input value once: a[c][y][x] = lerp(x[z0][y][x],
//     x[z1][y][x], wz) into the staging room (the span and a share their
//     flattened index); then the spans are free, and the next tile's go
//     out (its H taps after the H lerp), in flight through the rest of
//     this tile;
//   - the H lerp, a thread per (output row r, input column x) for all C
//     channels: b[r][x][c] = lerp(a[c][y0][x], a[c][y1][x], wy) (fp32, C
//     padded to 1, 2, 4 or 8 for vector loads and stores);
//   - the W lerp and the softmax: a warp takes 128 consecutive voxels of
//     the band at a time, lane l the voxels l, l + 32, l + 64, l + 96
//     (neighbouring lanes read neighbouring taps and columns of b), each
//     lane's voxels placed before their arithmetic so that their chains
//     interleave, and parks the fp32 probabilities in its own corner of
//     the staging room; then each lane whose 16 bytes of output (V = 4
//     fp32 or 8 bf16 probabilities, rounded in pairs) lie in those voxels
//     writes them for each channel as one 16-byte store, which nothing
//     waits for. A band starts at a multiple of V voxels wherever H W and
//     R W are multiples of V (the serving shape); other shapes store one
//     value at a time.
// No division per value: a lane's voxel advances incrementally.
//
// Bits: every value goes through the plain version's lerps along D, H and
// W (lerp below), then expf and one divide, in that order, on the same
// operands in both designs, so both give the same bits; a bf16 output is
// rounded once, to nearest even.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxC = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;  // output rows of a tile
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kSmemTarget = 56 * 1024;  // four blocks an SM
constexpr int kStageBytes = 512;  // a warp's probabilities of a channel

// The phase clock: for each block of the last launch (the first
// kClockBlocks), the global timer (ns) at its start and end, the summed ns
// of its tiles' three phases, read by thread 0: waiting for the tile's
// copies, the D and H lerps, the W lerp with the softmax, the stores and
// the next copies; then its tile count. m3seg_tail_phase_ns reads it.
constexpr int kClockBlocks = 4096;
constexpr int kClockFields = 6;
__device__ long long g_tail_clock[kClockBlocks * kClockFields];
int g_last_grid = 0;

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return fmaf(t, b, (1.f - t) * a);
}

// The fp32-logit instance (header): a block per band of output rows.
namespace band {

constexpr int kBandRows = 16;  // output rows of a block (a multiple of 4)
constexpr int kTailThreads = 256;
constexpr int kWarpVoxels = 128;  // output voxels of a warp per round

// The most input rows a band of R output rows reads, h -> H: the taps of
// half-pixel centres span at most ceil((R - 1) h / H) + 2 rows.
inline int band_input_rows(int R, int h, int H) {
  return std::min(h, (R - 1) * h / H + 3);
}

// Shared memory of a block of R rows, in floats: first the band's input
// rows along D (C x A x w), whose room each warp's probabilities take
// before they are stored (C x 128 a warp); the W taps (lo, hi, weight),
// the band's H taps (lo, hi, weight) and the rows b.
inline size_t tail_smem_floats(int C, int R, int h, int w, int H, int W) {
  return std::max((size_t)C * band_input_rows(R, h, H) * w,
                  (size_t)kTailThreads / 32 * kWarpVoxels * C) +
         3 * (size_t)W + 3 * (size_t)R + (size_t)C * R * w;
}

template <int C>
__global__ void __launch_bounds__(kTailThreads)
tail_kernel_fp32(const float* __restrict__ x, float* __restrict__ out,
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
    const float* p0 = x + c * in_vol + z0 * in_plane + (size_t)y0 * w + xi;
    const float* p1 = x + c * in_vol + z1 * in_plane + (size_t)y0 * w + xi;
    float* ac = a_s + c * A * w + xi;
#pragma unroll 8
    for (int y = 0; y < na; ++y)
      ac[y * w] = lerp(__ldg(p0 + (size_t)y * w), __ldg(p1 + (size_t)y * w),
                       wz);
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
  float* ob = out + oz * hw + (size_t)oy0 * W;
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
        *reinterpret_cast<float4*>(ob + c * n_out + j) =
            *reinterpret_cast<const float4*>(st + c * kWarpVoxels + 4 * lane);
      }
    } else {
      for (int k = 0; k < 4 && j + k < np; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c)
          ob[c * n_out + j + k] = st[c * kWarpVoxels + 4 * lane + k];
    }
    __syncwarp();
  }
}

template <int C>
cudaError_t launch(const float* x, float* out, const int* taps,
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
        tail_kernel_fp32<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  tail_kernel_fp32<C>
      <<<dim3((H + R - 1) / R, D), kTailThreads, smem, stream>>>(
          x, out, taps, wts, d, h, w, D, H, W, R, band_input_rows(R, h, H));
  return cudaGetLastError();
}

}  // namespace band

// C padded for the rows b: 1, 2, 4 or 8 floats a column
__host__ __device__ constexpr int padded_c(int c) {
  return c <= 2 ? c : c <= 4 ? 4 : 8;
}

__host__ __device__ inline int up16(int n) { return (n + 15) / 16 * 16; }

// The most input rows a band of R output rows reads, h -> H: its taps
// span at most ceil((R - 1) h / H) + 2 rows.
__host__ __device__ inline int tail_input_rows(int R, int h, int H) {
  const int rows = ((R - 1) * h + H - 1) / H + 2;
  return rows < h ? rows : h;
}

// The stage: the D taps (z0, z1, wz) in 16 bytes, the band's H taps
// (y0[R], y1[R], wy[R]), then the 2C spans of bf16 logits, slot (z * C +
// c), each the covering 16-byte words of its rows
__host__ __device__ inline int slot_bytes(int R, int h, int w, int H) {
  return up16(14 + tail_input_rows(R, h, H) * w * 2);
}
__host__ __device__ inline int stage_bytes(int C, int R, int h, int w,
                                           int H) {
  return 16 + up16(12 * R) + 2 * C * slot_bytes(R, h, w, H);
}
// Each warp's fp32 probabilities before they are stored, or, in the same
// room, the band's input rows along D (C x input rows x w, fp32)
__host__ __device__ inline int staging_bytes(int C, int R, int h, int w,
                                             int H) {
  const int st = kWarps * C * kStageBytes;
  const int rows = 4 * C * tail_input_rows(R, h, H) * w;
  return up16(st > rows ? st : rows);
}

// Shared memory of a block: the W taps (x0 | x1 << 16, wx), the stage,
// the band's rows along H (b, fp32) and the staging room.
// kernels/tail_resize.py tail_smem_bytes mirrors it.
inline size_t tail_smem(int C, int R, int h, int w, int H, int W) {
  return (size_t)up16(8 * W) + stage_bytes(C, R, h, w, H) +
         (size_t)up16(R * w * padded_c(C) * 4) +
         staging_bytes(C, R, h, w, H);
}

struct Args {
  const void* x;     // (1, C, d, h, w) logits
  void* out;         // (1, C, D, H, W) probabilities
  const int* taps;   // lo_d[D] hi_d[D] lo_h[H] hi_h[H] lo_w[W] hi_w[W]
  const float* wts;  // w_d[D] w_h[H] w_w[W]
  int d, h, w, D, H, W;
  int R, nb, n_tiles, stage;  // rows a tile, bands a plane
  int vec;           // every band starts at a multiple of V voxels
  int step_r, step_x;  // a warp's advance between rounds, rows and columns
  int hstep_r, hstep_x;  // a thread's advance in the H lerp, rows, columns
};

// V probabilities of a channel in 16 bytes
template <class Tout>
constexpr int kVec = 16 / (int)sizeof(Tout);

// 16 bytes of V probabilities from V fp32 values
template <class Tout>
__device__ __forceinline__ uint4 pack16(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  if constexpr (sizeof(Tout) == 4) {
    return *reinterpret_cast<const uint4*>(&a);
  } else {
    return m3seg::float4x2_to_bf16x8(a, reinterpret_cast<const float4*>(p)[1]);
  }
}

// b[r][x][0..C) as C floats (its row padded to padded_c(C))
template <int C>
__device__ __forceinline__ void load_col(const float* p, float (&v)[C]) {
  if constexpr (padded_c(C) == 1) {
    v[0] = p[0];
  } else if constexpr (padded_c(C) == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    if constexpr (C > 1) v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < padded_c(C) / 4; ++k) {
      const float4 q = reinterpret_cast<const float4*>(p)[k];
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * k + i < C) v[4 * k + i] = e[i];
    }
  }
}

// b[r][x][0..C) from the band's rows along D: C floats (a row of b is
// padded to padded_c(C))
template <int C>
__device__ __forceinline__ void store_col(float* p, const float (&v)[C]) {
  if constexpr (padded_c(C) == 1) {
    p[0] = v[0];
  } else if constexpr (padded_c(C) == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < padded_c(C) / 4; ++k) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = 4 * k + i < C ? v[4 * k + i] : 0.f;
      reinterpret_cast<float4*>(p)[k] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

// bf16 logits; Tout: the probabilities' type, float or bf16
template <int C, class Tout>
__global__ void __launch_bounds__(kThreads, 4)
tail_kernel(const Args a) {
  using Tin = bf16;
  constexpr int V = kVec<Tout>;
  constexpr int CP = padded_c(C);
  extern __shared__ __align__(16) unsigned char smem[];
  int2* wt_s = reinterpret_cast<int2*>(smem);  // [W] (x0 | x1 << 16, wx)
  unsigned char* stage = smem + up16(8 * a.W);
  float* b_s = reinterpret_cast<float*>(stage + a.stage);  // [R][w][CP]
  // each warp's probabilities [warp][C][128], or the rows along D [C][y][x]
  float* st_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(b_s) + up16(a.R * a.w * CP * 4));
  float* a_s = st_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = (a.stage - 16 - up16(12 * a.R)) / (2 * C);
  const int* lo_d = a.taps;
  const int* hi_d = lo_d + a.D;
  const int* lo_h = hi_d + a.D;
  const int* hi_h = lo_h + a.H;
  const int* lo_w = hi_h + a.H;
  const int* hi_w = lo_w + a.W;
  const float* w_d = a.wts;
  const float* w_h = w_d + a.D;
  const float* w_w = w_h + a.H;
  const Tin* x = static_cast<const Tin*>(a.x);
  const size_t in_plane = (size_t)a.h * a.w, in_vol = (size_t)a.d * in_plane;

  for (int i = tid; i < a.W; i += kThreads)
    wt_s[i] = make_int2(__ldg(lo_w + i) | (__ldg(hi_w + i) << 16),
                        __float_as_int(__ldg(w_w + i)));

  // the input planes and the band's first and last input rows of a tile,
  // loaded a tile ahead of its copies
  struct Pre {
    int z0, z1, ya, yb;
  };
  auto pre = [&](int tile) {
    Pre p{0, 0, 0, 0};
    if (tile < a.n_tiles) {
      const int oz = tile / a.nb, oy0 = (tile - oz * a.nb) * a.R;
      const int rows = min(a.R, a.H - oy0);
      p.z0 = __ldg(lo_d + oz);
      p.z1 = __ldg(hi_d + oz);
      p.ya = __ldg(lo_h + oy0);
      p.yb = __ldg(hi_h + oy0 + rows - 1);
    }
    return p;
  };
  // where span s of a tile starts in its slot, in values: its offset
  // modulo 16 bytes
  auto span_src = [&](const Pre& p, int s) {
    const int z = s < C ? p.z0 : p.z1, c = s < C ? s : s - C;
    return x + c * in_vol + z * in_plane + (size_t)p.ya * a.w;
  };
  // a tile's D taps and spans into the stage (all threads)
  auto issue_spans = [&](int tile, const Pre& p) {
    if (tile >= a.n_tiles) return;
    const int oz = tile / a.nb;
    int* hdr = reinterpret_cast<int*>(stage);
    if (tid < 3)
      cp_async4(hdr + tid, tid == 0 ? (const void*)(lo_d + oz)
                           : tid == 1 ? (const void*)(hi_d + oz)
                                      : (const void*)(w_d + oz));
    const int n = (p.yb - p.ya + 1) * a.w;
    unsigned char* spans = stage + 16 + up16(12 * a.R);
#pragma unroll
    for (int s = 0; s < 2 * C; ++s) {
      const uintptr_t at = reinterpret_cast<uintptr_t>(span_src(p, s));
      const int off = (int)(at & 15);
      const unsigned char* g0 =
          reinterpret_cast<const unsigned char*>(at - off);
      const int words = (off + n * (int)sizeof(Tin) + 15) >> 4;
      unsigned char* dst = spans + s * slot;
      for (int i = tid; i < words; i += kThreads)
        cp_async16(dst + 16 * i, g0 + 16 * i);
    }
  };
  // a tile's H taps (y0[R], y1[R], wy[R]) into the stage
  auto issue_taps = [&](int tile) {
    if (tile >= a.n_tiles) return;
    const int oz = tile / a.nb, oy0 = (tile - oz * a.nb) * a.R;
    const int rows = min(a.R, a.H - oy0);
    int* ytap = reinterpret_cast<int*>(stage + 16);
    for (int r = tid; r < rows; r += kThreads) {
      cp_async4(ytap + r, lo_h + oy0 + r);
      cp_async4(ytap + a.R + r, hi_h + oy0 + r);
      cp_async4(ytap + 2 * a.R + r, w_h + oy0 + r);
    }
  };

  const int G = gridDim.x;
  long long t_start = 0, sums[3] = {0, 0, 0};
  int tiles = 0;
  if (tid == 0) t_start = globaltimer();
  int tile = blockIdx.x;
  Pre pc = pre(tile);
  issue_spans(tile, pc);
  issue_taps(tile);
  const size_t hw = (size_t)a.H * a.W, n_out = (size_t)a.D * hw;
  for (; tile < a.n_tiles; tile += G) {
    const int oz = tile / a.nb, oy0 = (tile - oz * a.nb) * a.R;
    const int rows = min(a.R, a.H - oy0);
    const Pre pn = pre(tile + G);  // the next tile's, for its copies
    long long t0 = 0, t1 = 0, t2 = 0;
    if (tid == 0) t0 = globaltimer();
    cp_async_wait_all();
    __syncthreads();  // the tile's copies; b and the staging room free
    if (tid == 0) t1 = globaltimer();

    const int* hdr = reinterpret_cast<const int*>(stage);
    const float wz = __int_as_float(hdr[2]);
    const int* y0_s = reinterpret_cast<const int*>(stage + 16);
    const int* y1_s = y0_s + a.R;
    const float* wy_s = reinterpret_cast<const float*>(y1_s + a.R);
    const int ya = pc.ya;
    const int nyx = (pc.yb - ya + 1) * a.w;
    const unsigned char* spans = stage + 16 + up16(12 * a.R);
    // the D lerp: a[c][y][x] = lerp(x[z0][y][x], x[z1][y][x], wz), each
    // value of the band's input rows once (span and a share their index)
    const float* ac[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const Tin* r0 = reinterpret_cast<const Tin*>(spans + c * slot) +
                      (int)(reinterpret_cast<uintptr_t>(span_src(pc, c)) &
                            15) / (int)sizeof(Tin);
      const Tin* r1 = reinterpret_cast<const Tin*>(spans + (C + c) * slot) +
                      (int)(reinterpret_cast<uintptr_t>(span_src(pc, C + c)) &
                            15) / (int)sizeof(Tin);
      float* dst = a_s + c * nyx;
      for (int e = tid; e < nyx; e += kThreads)
        dst[e] = lerp(m3seg::to_float(r0[e]), m3seg::to_float(r1[e]), wz);
      ac[c] = dst;
    }
    __syncthreads();  // a whole; the spans free
    issue_spans(tile + G, pn);
    // the H lerp: b[r][x][c] = lerp(a[c][y0 r][x], a[c][y1 r][x], wy r), a
    // thread per (r, x), all C channels
    {
      int r = tid / a.w, xi = tid - r * a.w;
      for (; r < rows; ) {
        const int y0 = (y0_s[r] - ya) * a.w + xi;
        const int y1 = (y1_s[r] - ya) * a.w + xi;
        const float wy = wy_s[r];
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = lerp(ac[c][y0], ac[c][y1], wy);
        store_col<C>(b_s + (r * a.w + xi) * CP, v);
        r += a.hstep_r;
        xi += a.hstep_x;
        if (xi >= a.w) {
          xi -= a.w;
          ++r;
        }
      }
    }
    __syncthreads();  // b whole; the staging room and the H taps free
    issue_taps(tile + G);
    if (tid == 0) t2 = globaltimer();
    pc = pn;

    // the W lerp and the softmax: a warp takes 128 consecutive voxels of
    // the band at a time, lane l voxels l, l + 32, l + 64, l + 96, into its
    // own corner of the staging room (fp32); then each lane whose 16 bytes
    // (voxels V l .. V l + V - 1 of a round of 32 V) lie in those voxels
    // writes them for each channel
    constexpr int kSub = V / 4;  // 128-voxel parts of a round
    const int np = rows * a.W;
    Tout* ob = static_cast<Tout*>(a.out) + oz * hw + (size_t)oy0 * a.W;
    float* pw = st_s + warp * C * 128;  // [C][128]
    int r0 = (warp * 32 * V + lane) / a.W;
    int x0 = warp * 32 * V + lane - r0 * a.W;
    for (int j0 = warp * 32 * V; j0 < np; j0 += kWarps * 32 * V) {
      int rb = r0, xb = x0;  // the lane's voxel j0 + 128 s + lane
      // not unrolled: two parts' registers at once spill under the
      // 64-register cap of four blocks an SM
#pragma unroll 1
      for (int s = 0; s < kSub; ++s) {
        const int js = j0 + 128 * s;
        if (js >= np) break;
        // the lane's 4 voxels, placed before the arithmetic so that their
        // chains interleave
        int ru[4], xu[4];
        ru[0] = rb;
        xu[0] = xb;
#pragma unroll
        for (int u = 1; u < 4; ++u) {
          ru[u] = ru[u - 1];
          xu[u] = xu[u - 1] + 32;
          while (xu[u] >= a.W) {
            xu[u] -= a.W;
            ++ru[u];
          }
        }
        const bool whole = js + 128 <= np;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (whole || js + 32 * u + lane < np) {
            const int2 tw = wt_s[xu[u]];
            const float wx = __int_as_float(tw.y);
            const float* row = b_s + ru[u] * a.w * CP;
            float lo[C], hi[C], v[C];
            load_col<C>(row + (tw.x & 0xffff) * CP, lo);
            load_col<C>(row + (tw.x >> 16) * CP, hi);
            float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
            for (int c = 0; c < C; ++c) {
              v[c] = lerp(lo[c], hi[c], wx);
              m = fmaxf(m, v[c]);
            }
            float sum = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              v[c] = expf(v[c] - m);
              sum += v[c];
            }
#pragma unroll
            for (int c = 0; c < C; ++c) pw[c * 128 + 32 * u + lane] = v[c] / sum;
          }
        }
        __syncwarp();
        const int q = lane - s * (32 / kSub);  // the lane's 16 bytes here
        if (q >= 0 && q < 32 / kSub) {
          const int j = js + V * q;
          if (a.vec && j + V <= np) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              *reinterpret_cast<uint4*>(ob + c * n_out + j) =
                  pack16<Tout>(pw + c * 128 + V * q);
          } else {
            for (int k = 0; k < V && j + k < np; ++k)
#pragma unroll
              for (int c = 0; c < C; ++c)
                ob[c * n_out + j + k] =
                    m3seg::from_float<Tout>(pw[c * 128 + V * q + k]);
          }
        }
        __syncwarp();
        for (xb += 128; xb >= a.W; xb -= a.W) ++rb;
      }
      r0 += a.step_r;
      x0 += a.step_x;
      if (x0 >= a.W) {
        x0 -= a.W;
        ++r0;
      }
    }
    if (tid == 0) {
      const long long t3 = globaltimer();
      sums[0] += t1 - t0;
      sums[1] += t2 - t1;
      sums[2] += t3 - t2;
      ++tiles;
    }
  }
  if (tid == 0 && blockIdx.x < kClockBlocks) {
    long long* ck = g_tail_clock + blockIdx.x * kClockFields;
    ck[0] = t_start;
    ck[1] = globaltimer();
    ck[2] = sums[0];
    ck[3] = sums[1];
    ck[4] = sums[2];
    ck[5] = tiles;
  }
}

struct Plan {
  int R;
  size_t smem;
};

// Rows a tile: 16 or 8 within kSmemTarget (four blocks an SM), else the
// most rows up to 7 that fit a block; R = 0 if one row does not.
inline Plan make_plan(int C, int h, int w, int H, int W) {
  for (int R : {kMaxRows, 8}) {
    const size_t s = tail_smem(C, R, h, w, H, W);
    if ((R == 8 || H > 8) && s <= kSmemTarget) return {R, s};
  }
  for (int R = 7; R >= 1; --R) {
    const size_t s = tail_smem(C, R, h, w, H, W);
    if (s <= kMaxSmem) return {R, s};
  }
  return {0, 0};
}

template <int C, class Tout>
cudaError_t launch(Args a, cudaStream_t stream) {
  const Plan p = make_plan(C, a.h, a.w, a.H, a.W);
  if (p.R == 0) return cudaErrorInvalidValue;
  constexpr int V = kVec<Tout>;
  a.R = p.R;
  a.stage = stage_bytes(C, p.R, a.h, a.w, a.H);
  a.hstep_r = kThreads / a.w;
  a.hstep_x = kThreads - a.hstep_r * a.w;
  a.nb = (a.H + p.R - 1) / p.R;
  a.n_tiles = a.D * a.nb;
  a.vec = ((size_t)a.H * a.W % V == 0) && ((size_t)p.R * a.W % V == 0);
  const int step = kWarps * 32 * V;
  a.step_r = step / a.W;
  a.step_x = step - a.step_r * a.W;
  auto kern = tail_kernel<C, Tout>;
  // set before the occupancy query, which reads it
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, (int)p.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = std::min(a.n_tiles, per_sm * sms);
  kern<<<grid, kThreads, p.smem, stream>>>(a);
  g_last_grid = grid;
  return cudaGetLastError();
}

inline bool takes(int C, int d, int h, int w, int D, int H, int W) {
  return C >= 1 && C <= kMaxC && d >= 1 && h >= 1 && w >= 1 && D >= 1 &&
         H >= 1 && W >= 1 && D <= 65535;
}

template <class Tout>
int entry(const void* x, void* out, const int* taps, const float* wts,
          int C, int d, int h, int w, int D, int H, int W, void* stream) {
  if (!takes(C, d, h, w, D, H, W) || w > 65535 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.out = out;
  a.taps = taps;
  a.wts = wts;
  a.d = d;
  a.h = h;
  a.w = w;
  a.D = D;
  a.H = H;
  a.W = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch<1, Tout>(a, s);
    case 2: return (int)launch<2, Tout>(a, s);
    case 3: return (int)launch<3, Tout>(a, s);
    case 4: return (int)launch<4, Tout>(a, s);
    case 5: return (int)launch<5, Tout>(a, s);
    case 6: return (int)launch<6, Tout>(a, s);
    case 7: return (int)launch<7, Tout>(a, s);
    default: return (int)launch<8, Tout>(a, s);
  }
}

}  // namespace

// x: (1, C, d, h, w) fp32 contiguous logits; out: (1, C, D, H, W) fp32
// contiguous, 16-byte aligned. taps: int32 [lo_d, hi_d, lo_h, hi_h, lo_w,
// hi_w] (lengths D, D, H, H, W, W); wts: fp32 [w_d, w_h, w_w] (the hi-tap
// weights).
M3SEG_API int m3seg_tail_resize_softmax(const float* x, float* out,
                                        const int* taps, const float* wts,
                                        int C, int d, int h, int w, int D,
                                        int H, int W, void* stream) {
  if (!takes(C, d, h, w, D, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)band::launch<1>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 2: return (int)band::launch<2>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 3: return (int)band::launch<3>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 4: return (int)band::launch<4>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 5: return (int)band::launch<5>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 6: return (int)band::launch<6>(x, out, taps, wts, d, h, w, D, H, W, s);
    case 7: return (int)band::launch<7>(x, out, taps, wts, d, h, w, D, H, W, s);
    default: return (int)band::launch<8>(x, out, taps, wts, d, h, w, D, H, W, s);
  }
}

// The bf16-input instance: x bf16 logits; out fp32 or, with out_bf16 set,
// bf16; otherwise as above.
M3SEG_API int m3seg_tail_resize_softmax_bf16(const void* x, void* out,
                                             int out_bf16, const int* taps,
                                             const float* wts, int C, int d,
                                             int h, int w, int D, int H,
                                             int W, void* stream) {
  if (out_bf16)
    return entry<bf16>(x, out, taps, wts, C, d, h, w, D, H, W, stream);
  return entry<float>(x, out, taps, wts, C, d, h, w, D, H, W, stream);
}

// Dynamic shared memory of a block of R output rows, in bytes: of the
// fp32-logit instance (band::tail_smem_floats) with in_bytes 4, of the
// bf16-logit one (tail_smem) with 2; kernels/tail_resize.py's routing
// predicate follows them. Launches nothing.
M3SEG_API int m3seg_tail_smem_bytes(int C, int R, int in_bytes, int h, int w,
                                    int H, int W, int* bytes) {
  if (C < 1 || C > kMaxC || R < 1 || (in_bytes != 2 && in_bytes != 4) ||
      h < 1 || w < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  *bytes = in_bytes == 4
               ? (int)(sizeof(float) * band::tail_smem_floats(C, R, h, w, H, W))
               : (int)tail_smem(C, R, h, w, H, W);
  return 0;
}

// The phase clock of the last launch: up to n_blocks x 6 values (global
// timer at the block's start and end, ns; the summed ns of its tiles'
// waits, D and H lerps, and W lerps with the softmax and stores; its tile
// count) into dst (host), and the launch's grid into grid; launches
// nothing, waits for the device.
M3SEG_API int m3seg_tail_phase_ns(long long* dst, int n_blocks, int* grid) {
  *grid = g_last_grid;
  const int n = std::min(std::min(n_blocks, g_last_grid), kClockBlocks);
  if (n <= 0) return 0;
  return (int)cudaMemcpyFromSymbol(dst, g_tail_clock,
                                   sizeof(long long) * kClockFields * n);
}
