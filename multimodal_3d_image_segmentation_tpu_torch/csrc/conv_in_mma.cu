// conv_in's bf16 instance on the bf16 tensor cores (mma.sync): the fused
// input-downsampling convolution (k=2, s=2, pad=1) + bias (+ SELU) of a
// bf16 volume, a bf16 output written channels-last.
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/conv_in.py
//   conv_in_s2d on a bf16 input (compute_dtype 'bfloat16' and 'mixed'):
//   the Pallas _conv_in_raw_impl / _raw_kernel (and _conv_in_impl / _kernel
//   for odd D or H), which widen x, sum its products with the fp32 weights
//   in fp32, add the bias, apply SELU and round once to the input's type.
//   conv_in.cu keeps the fp32 instance.
//
// What bounds it on an H100: the bytes. At the serving shape it reads 71.4
// MB (4 x 240 x 240 x 155 bf16) and writes 54.8 MB (121 x 121 x 78 x 24
// bf16): 0.0377 ms at 3.35 TB/s, against 1.8 us for its 1.76 GFLOP on the
// tensor cores; as 768 fmaf a voxel on the CUDA cores they would take 26 us
// at 67 TFLOP/s, about as long as the bytes, and a band whose copies,
// products and stores run one after another leaves the card idle between
// them.
//
// Design: a persistent grid (as many blocks as fit on the SMs, four at the
// serving shape) walks the list of bands (batch, output plane z, R output
// rows). Stride 2 equals the kernel, so each input value belongs to one
// output voxel and the bands partition the input. A band reads 2C spans
// (channel c, input plane 2z - 1 + kz): its input rows 2y0 - 1 .. 2y0 + 2R
// - 2, one contiguous run of x each. The block copies each span raw with
// 16-byte cp.async over the 16-byte words that cover it, so a span keeps
// its address's offset modulo 16 bytes in shared memory and x may sit at
// any 2-byte alignment (the covering words lie in x's allocation, which
// starts 16-byte aligned). Two stages: band i + 1's spans are in flight
// while band i computes and stores; no widening pass, no division per
// value.
//
// The product, an implicit GEMM: M the band's voxels in tiles of 16 along
// an output row, K = 8 C in the order (c, kz, ky, kx) padded to a multiple
// of 16, N = F. kx is innermost, so an A register (two neighbouring k) is
// the pair of input columns 2x - 1, 2x of one row of one span: a 32-bit
// word where the pair is aligned, two words and a funnel shift where not
// (W odd). Lane (g, t) of a warp reads voxels g and g + 8 of its tile at
// plane kz = t / 2 and row ky = t % 2 of channels 2q and 2q + 1 in k step
// q. The pad = 1 border (plane, row or column outside the volume) is
// masked to zero in the registers. B is the weight packed once per weight
// version in fragment order (kernels/conv_in.py mma_weight), each fp32
// weight as NP bf16 parts: NP = 1 where the weights are bf16 values
// ('bfloat16'), else 3 (hi, mid, lo, each the rounding of what the parts
// before leave, so a normal fp32 weight is exact: 'mixed'); at C = 4 the
// fragments live in registers for the whole launch. Products of bf16
// values and bf16 parts are exact in fp32. The tensor cores sum a k step
// with truncation, so each k step's sum (the leading part's products; the
// smaller parts' in an accumulator of their own) is folded onto a running
// fp32 total, started at the bias, with an RN add: 6 mma a 16-voxel tile
// at C 4, F 24 in 'bfloat16', 18 in 'mixed'.
//
// Epilogue: SELU (m3seg::selu_fast: its branch-free expm1 within a few fp32
// ulps of expm1f, half the issue slots of m3seg::selu, which at 24 SELUs a
// voxel would rival the products' and the copies' slots together) on the
// accumulator fragments, one rounding
// to bf16, into a staging tile of the band in shared memory (lane (g, t)
// writes channels 8j + 2t, 2t + 1 of voxels g and g + 8: conflict-free at
// 48 bytes a voxel); the band leaves as one contiguous channels-last run of
// the output in 16-byte stores, which nothing waits for: the block goes on
// to the next band's products.
//
// Bits: not the FMA body's. Both sum exact products in fp32, in other
// orders, so an output whose sums straddle a rounding point of bf16 rounds
// the other way (one bf16 ulp, the bar of the bf16 instances). A padded tap
// is a zero operand here where the FMA body skips it; the -0 against +0 and
// the NaN of an infinite weight that this can give are below that bar.
//
// Limits: a band of one output row (2C spans of two input rows, two stages,
// and its staging tile) must fit the 227 KB a block can have: about
// (16 C + 2 F) W bytes, W <= 2,000 at C 4, F 24, as the FMA body; the entry
// point returns cudaErrorInvalidValue for wider volumes.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kSmemTarget = 56 * 1024;  // four blocks an SM
constexpr int kSlack = 16;  // bytes before and after each span's copy

// The phase clock: for each block of the last launch (the first
// kClockBlocks), the global timer (ns) at its start and end and the summed
// ns of its bands' three phases, read by thread 0: waiting for the band's
// spans, the products into the staging tile, the stores and the next
// band's copies; then its band count. m3seg_conv_in_phase_ns reads it.
constexpr int kClockBlocks = 4096;
constexpr int kClockFields = 6;
__device__ long long g_conv_in_clock[kClockBlocks * kClockFields];
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group complete
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 operands, fp32 sums
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc += c, rounded to nearest (the tensor cores' own add truncates)
__device__ __forceinline__ void fold(float (&acc)[4], const float (&c)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], c[e]);
}

// (a, b) rounded to bf16, a in the low half
__device__ __forceinline__ unsigned bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// bytes of shared memory before the stages: each stage's span origins
__host__ __device__ inline int head_bytes(int C) {
  return (2 * 2 * C * 4 + 15) / 16 * 16;
}

// a span's slot: its covering words (at most 2 R W values and 14 bytes of
// offset) with kSlack bytes on either side, which a pair at the row's
// ends may read (masked)
__host__ __device__ inline int slot_bytes(int R, int W) {
  return kSlack + (14 + 4 * R * W + 15) / 16 * 16 + kSlack;
}

struct Args {
  const bf16* x;      // (B, C, D, H, W), at any 2-byte alignment
  const uint2* wp;    // [KS][F/8][NP][32] B fragments
  const float* bias;  // (F,)
  bf16* out;          // (B, D2, H2, W2, F), 16-byte aligned
  int C, D, H, W, D2, H2, W2;
  int R, nb, n_items;  // rows a band, bands a plane, bands in all
  int slot, stage;     // bytes of a span's slot and of a stage
  int apply_selu;
};

// CT: the channel count where the instance fixes it (the B fragments then
// live in registers), else 0. NP: the weights' bf16 parts, 1 or 3.
template <int F, int CT, int NP>
__global__ void __launch_bounds__(kThreads, 4)
conv_in_mma_kernel(const Args a) {
  constexpr int NT = F / 8;
  constexpr int KR = CT > 0 ? (CT + 1) / 2 : 1;  // k steps in registers
  const int C = CT > 0 ? CT : a.C;
  const int KS = (C + 1) / 2;  // k steps of 16: two channels each
  extern __shared__ __align__(16) unsigned char smem[];
  int* sbt = reinterpret_cast<int*>(smem);  // [stage][2C]
  unsigned char* stages = smem + head_bytes(C);
  unsigned* stg = reinterpret_cast<unsigned*>(stages + 2 * a.stage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kz = t >> 1, ky = t & 1;  // this lane's plane and row in a pair
  const long long plane = (long long)a.H * a.W;

  uint2 breg[KR][NT][NP];
  if constexpr (CT > 0) {
#pragma unroll
    for (int q = 0; q < KR; ++q)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          breg[q][j][p] = __ldg(a.wp + ((q * NT + j) * NP + p) * 32 + lane);
  }
  float bias2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    bias2[j][0] = __ldg(a.bias + 8 * j + 2 * t);
    bias2[j][1] = __ldg(a.bias + 8 * j + 2 * t + 1);
  }

  struct Band {
    int b, z, y0, rows;
  };
  auto band_of = [&](int item) {
    Band d;
    const int yb = item % a.nb, bz = item / a.nb;
    d.z = bz % a.D2;
    d.b = bz / a.D2;
    d.y0 = yb * a.R;
    d.rows = min(a.R, a.H2 - d.y0);
    return d;
  };

  // the band's spans into stage st: cp.async over each span's covering
  // 16-byte words; thread 0 notes where row 2 y0 - 1 of each span would
  // start in the stage, in bf16 values
  auto issue = [&](int item, int st) {
    const Band d = band_of(item);
    const int iy_lo = max(2 * d.y0 - 1, 0);
    const int iy_hi = min(2 * (d.y0 + d.rows) - 2, a.H - 1);
    const int n = (iy_hi - iy_lo + 1) * a.W;
    unsigned char* base = stages + st * a.stage;
    for (int s = 0; s < 2 * C; ++s) {
      const int c = s >> 1, iz = 2 * d.z + (s & 1) - 1;
      if (iz < 0 || iz >= a.D) continue;
      const bf16* src = a.x + ((long long)(d.b * C + c) * a.D + iz) * plane +
                        (long long)iy_lo * a.W;
      const uintptr_t at = reinterpret_cast<uintptr_t>(src);
      const int off = (int)(at & 15);
      const unsigned char* g0 = reinterpret_cast<const unsigned char*>(
          at - off);
      const int words = (off + 2 * n + 15) >> 4;
      unsigned char* dst = base + s * a.slot + kSlack;
      for (int i = tid; i < words; i += kThreads)
        cp_async16(dst + 16 * i, g0 + 16 * i);
      if (tid == 0)
        sbt[st * 2 * C + s] = (s * a.slot + kSlack + off) / 2 -
                              (iy_lo - (2 * d.y0 - 1)) * a.W;
    }
  };

  // the band's products from stage st into the staging tile
  auto compute = [&](int item, int st) {
    const Band d = band_of(item);
    const unsigned* sw = reinterpret_cast<const unsigned*>(
        stages + st * a.stage);
    const int* sb = sbt + st * 2 * C;
    // this lane's spans (plane kz) of the fixed channels, read once a band
    int sbc[CT > 0 ? CT : 1];
    if constexpr (CT > 0) {
#pragma unroll
      for (int c = 0; c < CT; ++c) sbc[c] = sb[2 * c + kz];
    }
    const bool zok = (unsigned)(2 * d.z + kz - 1) < (unsigned)a.D;
    const int tpr = (a.W2 + 15) / 16;  // tiles a row
    const int n_tiles = d.rows * tpr;
    int r = 0, xt = warp;
    while (xt >= tpr) {
      xt -= tpr;
      ++r;
    }
    for (int tile = warp; tile < n_tiles; tile += kWarps) {
      const bool rok =
          zok && (unsigned)(2 * (d.y0 + r) + ky - 1) < (unsigned)a.H;
      const int rel = (2 * r + ky) * a.W;  // row 2 (y0 + r) + ky - 1
      int off[2];
      unsigned msk[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int xc = min(16 * xt + g + 8 * v, a.W2 - 1);
        off[v] = rel + 2 * xc - 1;
        msk[v] = rok ? (xc > 0 ? 0xffffu : 0u) |
                           (2 * xc < a.W ? 0xffff0000u : 0u)
                     : 0u;
      }
      float tot[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tot[j][0] = tot[j][2] = bias2[j][0];
        tot[j][1] = tot[j][3] = bias2[j][1];
      }
#pragma unroll
      for (int q = 0; q < (CT > 0 ? KR : 1); ++q) {
        for (int qq = q; qq < (CT > 0 ? q + 1 : KS); ++qq) {
          // a0 (voxel g, channel 2qq), a1 (g + 8, 2qq), a2 (g, 2qq + 1),
          // a3 (g + 8, 2qq + 1)
          unsigned A[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 2 * qq + h;
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              unsigned val = 0u;
              if (c < C && msk[v] != 0u) {
                const int e = (CT > 0 ? sbc[c] : sb[2 * c + kz]) + off[v];
                const unsigned w0 = sw[e >> 1], w1 = sw[(e >> 1) + 1];
                val = __funnelshift_r(w0, w1, (e & 1) * 16) & msk[v];
              }
              A[2 * h + v] = val;
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint2 bb[NP];
#pragma unroll
            for (int p = 0; p < NP; ++p)
              bb[p] = CT > 0 ? breg[q][j][p]
                             : __ldg(a.wp + ((qq * NT + j) * NP + p) * 32 +
                                     lane);
            float c4[4] = {0.f, 0.f, 0.f, 0.f};
            mma16(c4, A, bb[0]);
            fold(tot[j], c4);
            if constexpr (NP > 1) {
              float e4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int p = 1; p < NP; ++p) mma16(e4, A, bb[p]);
              fold(tot[j], e4);
            }
          }
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int x = 16 * xt + g + 8 * v;
        if (x >= a.W2) continue;
        unsigned* row = stg + ((r * a.W2 + x) * F + 2 * t) / 2;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float y0 = tot[j][2 * v], y1 = tot[j][2 * v + 1];
          if (a.apply_selu) {
            y0 = m3seg::selu_fast(y0);
            y1 = m3seg::selu_fast(y1);
          }
          row[4 * j] = bf2(y0, y1);
        }
      }
      xt += kWarps;
      while (xt >= tpr) {
        xt -= tpr;
        ++r;
      }
    }
  };

  const int G = gridDim.x;
  long long t_start = 0, sums[3] = {0, 0, 0};
  int bands = 0;
  if (tid == 0) t_start = globaltimer();
  int item = blockIdx.x;
  if (item < a.n_items) issue(item, 0);
  cp_async_commit();
  if (item + G < a.n_items) issue(item + G, 1);
  cp_async_commit();
  for (int k = 0; item < a.n_items; ++k, item += G) {
    long long t0 = 0, t1 = 0, t2 = 0;
    if (tid == 0) t0 = globaltimer();
    cp_async_wait_but_one();
    __syncthreads();  // the band's spans, and the staging tile free
    if (tid == 0) t1 = globaltimer();
    compute(item, k & 1);
    __syncthreads();  // the staging tile whole, the stage free
    if (tid == 0) t2 = globaltimer();
    if (item + 2 * G < a.n_items) issue(item + 2 * G, k & 1);
    cp_async_commit();
    // the band's rows are one contiguous run of the output
    const Band d = band_of(item);
    const int n16 = d.rows * a.W2 * F / 8;
    uint4* dst = reinterpret_cast<uint4*>(
        a.out + (((long long)d.b * a.D2 + d.z) * a.H2 + d.y0) * a.W2 * F);
    const uint4* src = reinterpret_cast<const uint4*>(stg);
    for (int i = tid; i < n16; i += kThreads) dst[i] = src[i];
    if (tid == 0) {
      const long long t3 = globaltimer();
      sums[0] += t1 - t0;
      sums[1] += t2 - t1;
      sums[2] += t3 - t2;
      ++bands;
    }
  }
  if (tid == 0 && blockIdx.x < kClockBlocks) {
    long long* ck = g_conv_in_clock + blockIdx.x * kClockFields;
    ck[0] = t_start;
    ck[1] = globaltimer();
    ck[2] = sums[0];
    ck[3] = sums[1];
    ck[4] = sums[2];
    ck[5] = bands;
  }
}

// The most rows a band (up to kMaxRows) whose block stays within
// kSmemTarget, else one row if that fits kMaxSmem; R = 0 if nothing fits.
struct Plan {
  int R, slot, stage, smem;
};
inline Plan plan_rows(int C, int W, int W2, int F, int R) {
  Plan p;
  p.R = R;
  p.slot = slot_bytes(R, W);
  p.stage = 2 * C * p.slot;
  const size_t smem = (size_t)head_bytes(C) + 2 * (size_t)p.stage +
                      (size_t)R * W2 * F * 2;
  p.smem = (int)std::min(smem, (size_t)1 << 30);
  return p;
}
inline Plan make_plan(int C, int H2, int W, int W2, int F) {
  for (int R = std::min(kMaxRows, H2); R > 1; --R) {
    const Plan p = plan_rows(C, W, W2, F, R);
    if ((size_t)p.smem <= kSmemTarget) return p;
  }
  Plan p = plan_rows(C, W, W2, F, 1);
  if ((size_t)p.smem > kMaxSmem) p.R = 0;
  return p;
}

template <int F, int CT, int NP>
cudaError_t launch(Args a, int smem, cudaStream_t stream) {
  auto kern = conv_in_mma_kernel<F, CT, NP>;
  // set before the occupancy query, which reads it
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = std::min(a.n_items, per_sm * sms);
  kern<<<grid, kThreads, smem, stream>>>(a);
  g_last_grid = grid;
  return cudaGetLastError();
}

}  // namespace

// x: (B, C, D, H, W) bf16 contiguous, at any 2-byte alignment. wp: the
// weight (F, C, 2, 2, 2) as B fragments, [ceil(C/2)][F/8][parts][32] x 4
// bf16 (kernels/conv_in.py mma_weight); parts 1 or 3. bias: (F,) fp32.
// out: (B, D/2+1, H/2+1, W/2+1, F) bf16 contiguous, 16-byte aligned.
M3SEG_API int m3seg_conv_in_bf16(const void* x, const void* wp, int parts,
                                 const float* bias, void* out, int B, int C,
                                 int D, int H, int W, int F, int apply_selu,
                                 void* stream) {
  if (B <= 0 || C <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      (parts != 1 && parts != 3) ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.wp = static_cast<const uint2*>(wp);
  a.bias = bias;
  a.out = static_cast<bf16*>(out);
  a.C = C;
  a.D = D;
  a.H = H;
  a.W = W;
  a.D2 = D / 2 + 1;
  a.H2 = H / 2 + 1;
  a.W2 = W / 2 + 1;
  a.apply_selu = apply_selu;
  const Plan p = make_plan(C, a.H2, W, a.W2, F);
  if (p.R == 0) return (int)cudaErrorInvalidValue;
  a.R = p.R;
  a.nb = (a.H2 + p.R - 1) / p.R;
  const long long items = (long long)B * a.D2 * a.nb;
  if (items > (1LL << 30)) return (int)cudaErrorInvalidValue;
  a.n_items = (int)items;
  a.slot = p.slot;
  a.stage = p.stage;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c4 = C == 4;
  switch (F * 10 + (c4 ? 1 : 0) + (parts == 3 ? 2 : 0)) {
    case 80: return (int)launch<8, 0, 1>(a, p.smem, s);
    case 81: return (int)launch<8, 4, 1>(a, p.smem, s);
    case 82: return (int)launch<8, 0, 3>(a, p.smem, s);
    case 83: return (int)launch<8, 4, 3>(a, p.smem, s);
    case 240: return (int)launch<24, 0, 1>(a, p.smem, s);
    case 241: return (int)launch<24, 4, 1>(a, p.smem, s);
    case 242: return (int)launch<24, 0, 3>(a, p.smem, s);
    case 243: return (int)launch<24, 4, 3>(a, p.smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The phase clock of the last launch: up to n_blocks x 6 values (global
// timer at the block's start and end, ns; the summed ns of its bands'
// waits, products and stores; its band count) into dst (host), and the
// launch's grid into grid; launches nothing, waits for the device.
M3SEG_API int m3seg_conv_in_phase_ns(long long* dst, int n_blocks,
                                     int* grid) {
  *grid = g_last_grid;
  const int n = std::min(std::min(n_blocks, g_last_grid), kClockBlocks);
  if (n <= 0) return 0;
  return (int)cudaMemcpyFromSymbol(dst, g_conv_in_clock,
                                   sizeof(long long) * kClockFields * n);
}
