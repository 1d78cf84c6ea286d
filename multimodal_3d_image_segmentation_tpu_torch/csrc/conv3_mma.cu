// k=3 convolution + bias with V-Net-DS's fused options on channels-last
// bf16 volumes: conv3's 'bfloat16' and 'mixed' instances, on the bf16
// tensor cores (mma.sync).
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/conv3d_flat.py:305
//   (_conv3_flat_impl) under compute_dtype 'bfloat16', its precision
//   'native' (one bf16 MXU pass of bf16 weights, fp32 sums), and 'mixed'
//   (``_dot_f32('mixed')``: the fp32 weight split into bf16 hi and lo
//   parts, two passes summed in fp32), with every option and mode of the
//   fp32 instance (conv3.cu's header: virtual concat, prologue, residual
//   tap, moment sums, stride 2, dilation 2, halo, dilated depth).
//
// What it computes. x (and x2) are bf16; the prologue act(x * scale +
// shift) runs in fp32 inside the volume only and its output is rounded to
// bf16, the activation operand of the products. The weights come packed
// (kernels/conv3.py::mma_weight): bf16 values in 'bfloat16' (one pass),
// the hi and lo parts of the fp32 weight in 'mixed' (two passes, sharing
// each activation fragment). Products are summed in fp32 accumulators, the
// bias is added in fp32, and y and r are rounded to bf16 once, at the
// store. The moment sums are fp32 sums of the fp32 values before that
// rounding, or, at stride 2, of the rounded outputs (the reference's
// down conv takes its GroupNorm moments from its decimated bf16 volume).
//
// What bounds it on an H100: operations. V-Net-DS's 29 calls at base width
// 24 run 0.305 TFLOP (valid taps) and move about 0.8 GB in bf16: 0.31 ms at
// 989 TFLOP/s bf16 against 0.25 ms at 3.35 TB/s.
//
// Design: an implicit GEMM over conv3.cu's bricks. A block owns an output
// brick of bd x bh x bw voxels of the iteration grid (M, the GEMM's rows,
// W fastest), a tile of cot output channels (N) and a range of the input
// channels (K: the taps times the range), which it contracts in chunks of
// ck channels. Warps split M into tm tiles of 16 rows each and N into
// tiles of 24 channels (three n8 tiles).
//
// The input brick. A chunk's brick with its halo sits in shared memory as
// bf16, copied with 16-byte cp.async (8 channels a copy; 8 bytes where a
// channel count is not a multiple of 8), zero-filled outside the volume,
// the prologue applied in place inside the volume, and rounded. A slot (an
// input voxel) holds the chunk's channels as 16-byte units; ldmatrix.x4
// takes one row address per lane, so each tap's A fragment is an address
// map over the same brick: row slot + tap offset. The stride-2 brick lays
// each row's even columns first, so its windows stay consecutive slots;
// the dilated mode's parity class (one per grid z) picks its 1-8 taps from
// a table the block builds once. A slot's unit count is odd, so 8
// consecutive slots fall in 8 distinct bank groups and the 8 rows of a
// matrix never conflict. A block of several chunks keeps two stages: the
// copies of chunk c + 1 are issued a few a k step while chunk c computes,
// and land in the other stage.
//
// The B fragments come from the packed weights in device memory (fragment
// order, one 8-byte load a lane, co padded to 24 with zeros) through L1,
// each k step's loaded while the step before it computes.
//
// The sums. mma.sync.m16n8k16 (m16n8k8 for a chunk's last 8 channels)
// sums in fp32 accumulators, 'mixed''s lo pass in its own. The tensor
// cores sum with truncation, so a chain of mma into one accumulator is
// bounded (MAX_CK channels): the 4-tile instances contract at most MAX_CK
// channels a block, the 2-tile ones start each chunk in fresh accumulators
// and fold them into a running fp32 total (__fadd_rn), so one block takes
// any ci. A longer K range on the 4-tile body, a call with the residual
// tap, or a grid too small for the card splits K over blocks: their fp32
// partial sums go to a workspace and conv3.cuh's reduce kernel adds them
// in order. The residual tap (no
// prologue there) is a second pass over the block's one chunk after the
// output's epilogue: the centre tap against its own B fragments. The
// epilogue adds the bias to the accumulator fragments (rows g and g + 8,
// columns 2t and 2t + 1 of each m16n8 tile), stores bf16 pairs, and
// reduces the moments in a fixed order: over a thread's rows, a butterfly
// over the 8 row lanes, then over the warps in shared memory, one partial
// a block, summed by conv3.cuh's conv3_moment_sum. No atomics: a second
// run gives the same bits.
#include "conv3.cuh"

namespace {

constexpr int TN = 3;                 // n8 tiles a warp
constexpr int WARP_N = 8 * TN;        // output channels a warp
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;      // bytes a block may use on sm_90
constexpr int SMEM_BUDGET = 100000;   // bytes the planner keeps to: 2 blocks
// channels one accumulator chain may contract: 27 taps x ck / 16 k steps
// (the lo pass of 'mixed' sums into an accumulator of its own); the tensor
// cores sum with truncation, about half an ulp an instruction, and a chain
// of 216 still held the moment sums to 1e-5 on an H100 where 270 did not,
// so 6 k steps a tap: 162
constexpr int MAX_CK = 96;
// 'mixed''s hi + lo carries its fp32 weight to 2^-17, an error the moment
// sums show beside the truncation's: at 96-channel chains they read up to
// 9.8e-6 of their bar's 1e-5 on V-Net-DS's calls, at 48 at most 5.9e-6, so
// its planner keeps its chains to 48
constexpr int MIXED_CK = 48;
constexpr int MIN_BLOCKS = NUM_SMS / 2;  // the planner's least blocks
constexpr int PIECE = 2;              // next-chunk copies a thread a step

// the launch plan, an int array shared with the wrapper: the first seven
// fields choose (0 in P_TM: the planner chooses), the rest follow
enum PlanField {
  P_TM, P_BD, P_BH, P_BW, P_WN, P_CK, P_SPLIT,
  P_NPART, P_THREADS, P_SMEM, P_PW, P_PL, P_BLOCKS, P_CONFLICT, P_CHUNKS,
  P_COUNT
};

struct MmaArgs {
  const __nv_bfloat16* x1;  // (D, H, W, c1)
  const __nv_bfloat16* x2;  // (D, H, W, c2) or null
  const uint2* w;     // (w_pass, 27, nks, nnt, 32) B fragments
  const uint2* wr;    // (r_pass, 1, nks, nnt, 32) or null: the residual tap
  const float* bias;  // (co,)
  const float* scale;  // (ci,) prologue scale, or null (no prologue)
  const float* shift;  // (ci,) prologue shift
  const float* br;    // (co,)
  __nv_bfloat16* y;   // (Do, Ho, Wo, co)
  __nv_bfloat16* r;   // (Do, Ho, Wo, co) or null
  float* part;        // (n_part, 2, co) moment partials or null
  float* rpart;       // the same for r, or null
  float* ws;          // split > 1: ((1 or 2) x split, Do*Ho*Wo, co)
  int D, H, W, c1, c2, ci, co;
  int Do, Ho, Wo;     // output volume
  int Gd, Gh, Gw;     // iteration grid (the source grid in mode 2)
  int mode;           // 0: stride 1; 1: stride 2; 2: input dilation 2
  int halo, keep_lo, keep_hi, dsrc;  // the depth modes (conv3.cu)
  int pro_act;        // 0 none, 1 elu, 2 selu, 3 relu
  int stats_rounded;  // stride 2: the moments of the rounded outputs
  int w_pass, r_pass;  // 1 (bf16 weights) or 2 (hi and lo)
  int res;            // the plan's calls take the residual tap
  int nks, nnt;       // k16 steps of ci, n8 tiles of co padded to 24
  int unit;           // channels a copy: 8 (16 bytes) or 4
  // the plan
  int tm, bd, bh, bw, wn, ck, split;
  int wm, cot, threads;  // warps along M, channels a block, threads
  int nbd, nbh, nbw;  // bricks along each axis
  int ez, ey, ew;     // the input brick's extent
  int pw, pl, nslot;  // slot pitches: row, plane; slots
  int half;           // stride 2: the even columns of a brick row
  int pp;             // 16-byte units a slot: odd, so 8 consecutive slots
                      // fall in 8 distinct bank groups
  int nchunk, cps;    // chunks of ck input channels; chunks a block
  int a_stage;        // bytes of one stage of the input brick
  int taps_off, red_off, smem;  // where the taps' table and the moment
                                // scratch start; bytes in all
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 operands, fp32 sums
__device__ __forceinline__ void mma_k16(float (&c)[4], const unsigned (&a)[4],
                                        uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// c += a (16 x 8) b (8 x 8): a chunk's last 8 channels
__device__ __forceinline__ void mma_k8(float (&c)[4], const unsigned (&a)[4],
                                       unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// The threads a block and blocks an SM each instance is built for:
// 'mixed''s 4-tile instance holds its hi and lo sums in registers, so it
// keeps to 4 warps a block at 3 blocks an SM (168 registers a thread).
constexpr int max_threads(int tm, int np) {
  return tm == 4 && np == 2 ? 128 : MAX_THREADS;
}
constexpr int min_blocks(int tm, int np) { return tm == 4 && np == 2 ? 3 : 1; }

// TM M tiles a warp (2: a running total over the chunks), MODE, NP passes
// of the weights
template <int TM, int MODE, int NP>
__global__ void __launch_bounds__(max_threads(TM, NP), min_blocks(TM, NP))
conv3_mma(const MmaArgs a) {
  constexpr int S = MODE == 1 ? 2 : 1;
  constexpr bool FOLD = TM == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  // the input brick's stages, the taps' table, each slot's voxel, the
  // moment scratch
  int2* tap_tab = reinterpret_cast<int2*>(smem + a.taps_off);
  int* gvox = reinterpret_cast<int*>(tap_tab + 27);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wmi = warp % a.wm, wni = warp / a.wm;
  const int brick = blockIdx.x;
  const int cls = blockIdx.z / a.split, sp = blockIdx.z % a.split;
  // this block's chunks, k0 + it for it < nit
  const int k0 = sp * a.cps, nit = min(a.nchunk, k0 + a.cps) - k0;
  const int nbricks = a.nbd * a.nbh * a.nbw;
  // the dilated mode's parity class: one per grid z, W parity included
  const int pz = MODE == 2 ? cls >> 2 : 0;
  const int py = MODE == 2 ? (cls >> 1) & 1 : 0;
  const int px = MODE == 2 ? cls & 1 : 0;
  const int nb0 = blockIdx.y * a.cot;         // the block's first channel
  const int nt0 = (nb0 + wni * WARP_N) / 8;   // the warp's first n8 tile

  const int gd0 = brick / (a.nbw * a.nbh) * a.bd;
  const int gh0 = brick / a.nbw % a.nbh * a.bh, gw0 = brick % a.nbw * a.bw;
  const int oz = MODE == 2 ? gd0 : S * gd0 - 1;
  const int oy = MODE == 2 ? gh0 : S * gh0 - 1;
  const int ow = MODE == 2 ? gw0 : S * gw0 - 1;

  // the volume voxel of each input slot (input_voxel), -1 outside the
  // volume; at stride 2 a brick row holds its even columns first
  for (int s = tid; s < a.nslot; s += a.threads) {
    const int z = s / a.pl, rem = s % a.pl;
    const int yy = rem / a.pw, ww = rem % a.pw;
    const int lw = MODE == 1 ? (ww < a.half ? 2 * ww : 2 * (ww - a.half) + 1)
                             : ww;
    gvox[s] = input_voxel(oz + z, oy + yy, ow + lw, a.D, a.H, a.W, a.halo,
                          a.keep_lo, a.keep_hi, a.dsrc);
  }
  // the block's taps: the byte offset of each one's window in a stage and
  // the offset of its B fragments (in 8-byte units); the dilated mode's
  // parity class takes 1-8 of the 27
  const int ntap = MODE == 2 ? (pz + 1) * (py + 1) * (px + 1) : 27;
  const int bstep = a.nnt * 32;  // one k16 step of B, 8-byte units
  if (tid < ntap) {
    int wtap, soff;
    if constexpr (MODE == 2) {
      // along an axis parity 0 takes the centre tap at source offset 0,
      // parity 1 the outer taps at offsets 0 and +1
      const int tx = tid % (px + 1), ty = (tid / (px + 1)) % (py + 1),
                tz = tid / ((px + 1) * (py + 1));
      const int kz = pz ? 2 * tz : 1, ky = py ? 2 * ty : 1,
                kx = px ? 2 * tx : 1;
      wtap = (kz * 3 + ky) * 3 + kx;
      soff = tz * a.pl + ty * a.pw + tx;
    } else {
      const int kz = tid / 9, ky = (tid / 3) % 3, kx = tid % 3;
      wtap = tid;
      soff = kz * a.pl + ky * a.pw +
             (MODE == 1 ? (kx == 1 ? a.half : kx >> 1) : kx);
    }
    tap_tab[tid] = make_int2(soff * a.pp * 16, wtap * a.nks * bstep);
  }
  __syncthreads();

  // byte offset of 16-byte unit g of slot s in a stage
  auto unit_off = [&](int s, int g) { return (s * a.pp + g) << 4; };
  // the 8-channel groups chunk k holds (the last one zero-padded)
  auto groups = [&](int k) { return (min(a.ck, a.ci - k * a.ck) + 7) >> 3; };
  // the copies of chunk k a slot
  auto per_slot = [&](int k) { return groups(k) * 8 / a.unit; };

  // this thread's copies j0 <= j < j1 of chunk k0 + it (copy tid + j *
  // threads) into stage it % 2; copies outside the volume or past ci
  // zero-fill
  auto load = [&](int it, int j0, int j1) {
    const int k = k0 + it;
    const int c0 = k * a.ck, per = per_slot(k), n = a.nslot * per;
    unsigned char* base = smem + (it & 1) * a.a_stage;
    for (int j = j0; j < j1; ++j) {
      const int e = tid + j * a.threads;
      if (e >= n) break;
      const int s = e / per, cl = (e % per) * a.unit;
      const int g = gvox[s], cc = c0 + cl;
      const bool ok = g >= 0 && cc < a.ci;
      const __nv_bfloat16* src = a.x1;
      if (ok)
        src = cc < a.c1 ? a.x1 + (long long)g * a.c1 + cc
                        : a.x2 + (long long)g * a.c2 + (cc - a.c1);
      unsigned char* dst = base + unit_off(s, cl >> 3) + (cl & 7) * 2;
      if (a.unit == 8)
        cp_async16(dst, src, ok);
      else
        cp_async8(dst, src, ok);
    }
  };
  // the k steps over which this thread issues chunk k0 + it's copies,
  // PIECE a step
  auto pieces = [&](int it) {
    const int n = a.nslot * per_slot(k0 + it);
    return ((n + a.threads - 1) / a.threads + PIECE - 1) / PIECE;
  };

  // the prologue on chunk k0 + it's copies this thread issued (its own
  // cp.async writes are visible to it after the wait), inside the volume
  // only, its output rounded to bf16
  auto prologue = [&](int it) {
    unsigned char* base = smem + (it & 1) * a.a_stage;
    const int c0 = (k0 + it) * a.ck, per = per_slot(k0 + it);
    for (int e = tid; e < a.nslot * per; e += a.threads) {
      const int s = e / per, cl = (e % per) * a.unit;
      const int cc = c0 + cl;
      if (gvox[s] < 0 || cc >= a.ci) continue;
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(
          base + unit_off(s, cl >> 3) + (cl & 7) * 2);
      for (int j = 0; j < a.unit / 2; ++j) {
        const float2 f = __bfloat1622float2(v[j]);
        const int c = cc + 2 * j;
        v[j] = __floats2bfloat162_rn(
            activate(__fadd_rn(__fmul_rn(f.x, __ldg(a.scale + c)),
                               __ldg(a.shift + c)), a.pro_act),
            activate(__fadd_rn(__fmul_rn(f.y, __ldg(a.scale + c + 1)),
                               __ldg(a.shift + c + 1)), a.pro_act));
      }
    }
  };

  // this lane's ldmatrix row address for each of its M tiles
  // (row lane % 16; lanes 16-31 the tile's second 8 channels), the tap at
  // offset 0, in stage 0
  unsigned arow[TM];
#pragma unroll
  for (int mt = 0; mt < TM; ++mt) {
    const int m = (wmi * TM + mt) * 16 + (lane & 15);
    const int lw = m % a.bw, ly = (m / a.bw) % a.bh, lz = m / (a.bw * a.bh);
    arow[mt] = smem_addr(smem) +
               unit_off(S * lz * a.pl + S * ly * a.pw + lw, lane >> 4);
  }
  // this warp's B fragments (its three n8 tiles, this lane's 8 bytes); a
  // warp wholly past co has nothing to compute
  const uint2* bw = a.w + nt0 * 32 + lane;
  const uint2* brw = a.wr + nt0 * 32 + lane;
  const int bpass = 27 * a.nks * bstep;
  const bool active = nt0 * 8 < a.co;

  // the sums; 'mixed' sums its lo pass apart (lacc), so that each chain of
  // mma into one accumulator stays within MAX_CK's bound; the 2-tile
  // instances fold each chunk's into tot
  float acc[TM][TN][4];
  float lacc[NP == 2 ? TM : 1][TN][4];
  float tot[FOLD ? TM : 1][TN][4];

  auto zero = [&](auto& c) {
#pragma unroll
    for (int mt = 0; mt < TM; ++mt)
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[mt][j][i] = 0.f;
  };

  // c += af x b over this warp's tiles: k16 steps, or K8 the chunk's last
  // 8 channels
  auto mma_tiles = [&](auto k8c, float (&c)[TM][TN][4],
                       const unsigned (&af)[TM][4], const uint2 (&b)[TN]) {
#pragma unroll
    for (int mt = 0; mt < TM; ++mt)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if constexpr (decltype(k8c)::value)
          mma_k8(c[mt][j], af[mt], b[j].x);
        else
          mma_k16(c[mt][j], af[mt], b[j]);
      }
  };
  // the B fragments at bp, each of NP passes (a pass apart)
  auto load_b = [&](uint2 (&b)[NP][TN], const uint2* bp) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < TN; ++j) b[p][j] = __ldg(bp + p * bpass + j * 32);
  };
  // A at byte offset ao + kk * 32 of each row, for this lane's M tiles
  auto load_a = [&](auto k8c, unsigned (&af)[TM][4], unsigned ao, int kk) {
#pragma unroll
    for (int mt = 0; mt < TM; ++mt) {
      if constexpr (decltype(k8c)::value)
        ldsm_x2(arow[mt] + ao + kk * 32, af[mt]);
      else
        ldsm_x4(arow[mt] + ao + kk * 32, af[mt]);
    }
  };
  // one k step: A at ao + kk * 32 against the B fragments b, the lo pass
  // into lacc
  auto kstep = [&](auto k8c, int kk, unsigned ao, const uint2 (&b)[NP][TN]) {
    unsigned af[TM][4];
    load_a(k8c, af, ao, kk);
    mma_tiles(k8c, acc, af, b[0]);
    if constexpr (NP == 2) mma_tiles(k8c, lacc, af, b[1]);
  };

  // acc = the residual tap of the block's one chunk k0: the centre tap's A
  // (the input before any prologue: the residual takes none) against its
  // own B fragments, each of its passes
  auto compute_res = [&]() {
    zero(acc);
    if (!active) return;
    const int k = k0;
    const int ng = groups(k), nk16 = ng >> 1, nkk = (ng + 1) >> 1;
    const unsigned ao = tap_tab[13].x;  // chunk k0's stage
    const uint2* bk = brw + k * a.ck / 16 * bstep;
    for (int kk = 0; kk < nkk; ++kk)
      for (int p = 0; p < a.r_pass; ++p) {
        uint2 b[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          b[j] = __ldg(bk + kk * bstep + p * a.nks * bstep + j * 32);
        unsigned af[TM][4];
        if (kk < nk16) {
          load_a(std::false_type{}, af, ao, kk);
          mma_tiles(std::false_type{}, acc, af, b);
        } else {
          load_a(std::true_type{}, af, ao, kk);
          mma_tiles(std::true_type{}, acc, af, b);
        }
      }
  };

  // the output voxel of row h * 8 + (lane / 4) of M tile mt, or -1 past
  // the grid's ragged edge
  auto out_voxel = [&](int mt, int h) -> long long {
    const int m = (wmi * TM + mt) * 16 + h * 8 + (lane >> 2);
    const int lw = m % a.bw, ly = (m / a.bw) % a.bh, lz = m / (a.bw * a.bh);
    const int gz = gd0 + lz, gy = gh0 + ly, gw = gw0 + lw;
    if (gz >= a.Gd || gy >= a.Gh || gw >= a.Gw) return -1;
    if constexpr (MODE == 2)
      return ((long long)(2 * gz + pz) * a.Ho + 2 * gy + py) * a.Wo +
             2 * gw + px;
    else
      return ((long long)gz * a.Ho + gy) * a.Wo + gw;
  };

  // bias, bf16 store, and the block's moment partials in a fixed order
  auto epilogue = [&](auto& c, const float* b, __nv_bfloat16* out,
                      float* part) {
    float s[TN][2], s2[TN][2], bn[TN][2];
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = (nt0 + j) * 8 + 2 * (lane & 3) + e;
        bn[j][e] = n < a.co ? __ldg(b + n) : 0.f;
        s[j][e] = s2[j][e] = 0.f;
      }
#pragma unroll
    for (int mt = 0; mt < TM; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long vox = out_voxel(mt, h);
        if (vox < 0) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = (nt0 + j) * 8 + 2 * (lane & 3);
          if (n >= a.co) continue;  // co is a multiple of 4: n + 1 too
          float v0 = c[mt][j][2 * h] + bn[j][0];
          float v1 = c[mt][j][2 * h + 1] + bn[j][1];
          const __nv_bfloat162 q = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(out + vox * a.co + n) = q;
          if (a.stats_rounded) {
            v0 = __low2float(q);
            v1 = __high2float(q);
          }
          s[j][0] += v0; s2[j][0] += v0 * v0;
          s[j][1] += v1; s2[j][1] += v1 * v1;
        }
      }
    if (part == nullptr) return;
    // over the 8 row lanes of each column pair, then over the warps along M
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], off);
          s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], off);
        }
    float* red = reinterpret_cast<float*>(smem + a.red_off);  // (2, wm, cot)
    if (lane < 4)
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wni * WARP_N + 8 * j + 2 * lane + e;
          red[wmi * a.cot + col] = s[j][e];
          red[(a.wm + wmi) * a.cot + col] = s2[j][e];
        }
    __syncthreads();
    for (int t = tid; t < 2 * a.cot; t += a.threads) {
      const int q = t / a.cot, n = t % a.cot;
      if (nb0 + n >= a.co) continue;
      float sum = 0.f;
      for (int w = 0; w < a.wm; ++w) sum += red[(q * a.wm + w) * a.cot + n];
      part[((long long)(cls * nbricks + brick) * 2 + q) * a.co + nb0 + n] =
          sum;
    }
    __syncthreads();
  };

  // split K ranges: this block's raw partial sums
  auto store_partial = [&](auto& c, float* dst) {
#pragma unroll
    for (int mt = 0; mt < TM; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long vox = out_voxel(mt, h);
        if (vox < 0) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = (nt0 + j) * 8 + 2 * (lane & 3);
          if (n < a.co)
            *reinterpret_cast<float2*>(dst + vox * a.co + n) =
                make_float2(c[mt][j][2 * h], c[mt][j][2 * h + 1]);
        }
      }
  };

  const long long m_out = (long long)a.Do * a.Ho * a.Wo * a.co;
  auto finish = [&](auto& c) {
    if (a.split == 1)
      epilogue(c, a.bias, a.y, a.part);
    else
      store_partial(c, a.ws + sp * m_out);
  };

  // the chunks: chunk k0's copies before the loop; in the loop each k
  // step's B fragments load one step ahead, and the first steps of a chunk
  // each issue PIECE of this thread's copies of the next chunk into the
  // other stage, waited for at the chunk's end
  zero(acc);
  if constexpr (NP == 2) zero(lacc);
  if constexpr (FOLD) zero(tot);
  load(0, 0, 1 << 30);
  cp_async_wait_all();
  if (a.scale != nullptr) prologue(0);
  __syncthreads();

  for (int it = 0; it < nit; ++it) {
    const int k = k0 + it;
    const int ng = groups(k), nk16 = ng >> 1, nkk = (ng + 1) >> 1;
    const bool next = it + 1 < nit;
    const int npiece = next ? pieces(it + 1) : 0;
    int q = 0;  // the chunk's k steps so far
    if (active) {
      const unsigned sbase = (it & 1) * a.a_stage;
      const uint2* bk = bw + k * a.ck / 16 * bstep;  // chunks start at 16n
      uint2 b[NP][TN], bn[NP][TN];
      load_b(b, bk + tap_tab[0].y);
      for (int t = 0; t < ntap; ++t) {
        const unsigned ao = sbase + tap_tab[t].x;
        const uint2* bp = bk + tap_tab[t].y;
        for (int kk = 0; kk < nkk; ++kk, ++q) {
          // the next step's fragments: this tap's next k step, or the next
          // tap's first
          if (kk + 1 < nkk)
            load_b(bn, bp + (kk + 1) * bstep);
          else if (t + 1 < ntap)
            load_b(bn, bk + tap_tab[t + 1].y);
          if (q < npiece) load(it + 1, q * PIECE, (q + 1) * PIECE);
          if (kk < nk16)
            kstep(std::false_type{}, kk, ao, b);
          else
            kstep(std::true_type{}, kk, ao, b);
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int j = 0; j < TN; ++j) b[p][j] = bn[p][j];
        }
      }
    }
    if (next) {  // the rest of the next chunk's copies, then its prologue
      load(it + 1, (q < npiece ? q : npiece) * PIECE, 1 << 30);
      cp_async_wait_all();
      if (a.scale != nullptr) prologue(it + 1);
    }
    if constexpr (FOLD) {
#pragma unroll
      for (int mt = 0; mt < TM; ++mt)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float c = acc[mt][j][i];
            if constexpr (NP == 2) c = __fadd_rn(c, lacc[mt][j][i]);
            tot[mt][j][i] = __fadd_rn(tot[mt][j][i], c);
          }
      zero(acc);
      if constexpr (NP == 2) zero(lacc);
    }
    __syncthreads();  // chunk it's stage is free, chunk it + 1's ready
  }
  if constexpr (FOLD) {
    finish(tot);
  } else {
    if constexpr (NP == 2)
#pragma unroll
      for (int mt = 0; mt < TM; ++mt)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][j][i] = __fadd_rn(acc[mt][j][i], lacc[mt][j][i]);
    finish(acc);
  }
  if (a.r != nullptr) {  // the planner gives a residual call one chunk a
                         // block
    compute_res();
    if (a.split == 1)
      epilogue(acc, a.br, a.r, a.rpart);
    else
      store_partial(acc, a.ws + (a.split + sp) * m_out);
  }
}

// The 16-byte units a slot for a chunk of ck channels: odd, so that 8
// consecutive slots fall in 8 distinct 16-byte bank groups.
int slot_units(int ck) { return ck / 8 | 1; }

int n_classes(const MmaArgs& a) { return a.mode == 2 ? 8 : 1; }

long long n_blocks(const MmaArgs& a) {
  return (long long)a.nbd * a.nbh * a.nbw * ceil_div(a.co, a.cot) *
         n_classes(a) * a.split;
}

// The brick, grid, chunk and shared-memory layout the chosen fields
// imply; false where the plan cannot run.
bool shape(MmaArgs& a) {
  const int ci8 = ceil_div(a.ci, 8) * 8;
  if ((a.tm != 2 && a.tm != 4) || a.bd < 1 || a.bh < 1 || a.bw < 8 ||
      a.bw % 8 || a.wn < 1 || a.split < 1 || a.ck < 8 || a.ck % 8 ||
      a.ck > MAX_CK || (a.ck % 16 && a.ck < ci8))
    return false;
  const int m = a.bd * a.bh * a.bw;
  if (m % (16 * a.tm)) return false;
  a.wm = m / (16 * a.tm);
  a.cot = WARP_N * a.wn;
  a.threads = 32 * a.wm * a.wn;
  if (a.threads > max_threads(a.tm, a.w_pass)) return false;
  a.nbd = ceil_div(a.Gd, a.bd);
  a.nbh = ceil_div(a.Gh, a.bh);
  a.nbw = ceil_div(a.Gw, a.bw);
  a.ez = extent(a.mode, a.bd);
  a.ey = extent(a.mode, a.bh);
  a.ew = extent(a.mode, a.bw);
  a.half = a.bw + 1;
  a.pw = a.ew;
  a.pl = a.ey * a.ew;
  a.nslot = a.ez * a.pl;
  a.nchunk = ceil_div(a.ci, a.ck);
  if (a.split > a.nchunk) return false;
  a.cps = ceil_div(a.nchunk, a.split);
  if (ceil_div(a.nchunk, a.cps) != a.split) return false;  // a split empty
  // without a running total a block's chunks are one accumulator chain;
  // the residual pass reads the block's one chunk
  if ((a.tm == 4 && a.cps * a.ck > MAX_CK) || (a.res && a.cps > 1))
    return false;
  a.pp = slot_units(a.ck);
  a.a_stage = a.nslot * a.pp * 16;
  // the stages (two where a block takes several chunks), then the taps,
  // the slots' voxels, and the epilogue's (2, wm, cot) moment scratch
  a.taps_off = (a.cps > 1 ? 2 : 1) * a.a_stage;
  a.red_off = (a.taps_off + 8 * 27 + 4 * a.nslot + 15) / 16 * 16;
  a.smem = a.red_off + 2 * a.wm * a.cot * 4;
  return a.smem <= MAX_SMEM;
}


// The largest number of distinct 16-byte units that one bank group serves
// in one 8-row matrix of an ldmatrix, over every tap, M tile and unit pair
// (1: no conflict).
int conflict_degree(const MmaArgs& a) {
  const int s_ = a.mode == 1 ? 2 : 1;
  int worst = 1;
  for (int t = 0; t < 27; ++t) {
    const int kz = t / 9, ky = (t / 3) % 3, kx = t % 3;
    if (a.mode == 2 && (kz > 1 || ky > 1 || kx > 1)) continue;
    const int soff = kz * a.pl + ky * a.pw +
                     (a.mode == 1 ? (kx == 1 ? a.half : kx >> 1) : kx);
    for (int tile = 0; tile < a.wm * a.tm; ++tile)
      for (int mat = 0; mat < 4; ++mat) {
        const int g = mat >> 1;
        if (g >= a.ck / 8) continue;
        int count[8] = {0};
        for (int row = 0; row < 8; ++row) {
          const int m = tile * 16 + (mat & 1) * 8 + row;
          const int lw = m % a.bw, ly = (m / a.bw) % a.bh,
                    lz = m / (a.bw * a.bh);
          const int s = s_ * lz * a.pl + s_ * ly * a.pw + lw + soff;
          const int c = ++count[(s * a.pp + g) % 8];
          worst = c > worst ? c : worst;
        }
      }
  }
  return worst;
}

// The brick of a block of `warps` warps, wn of them along N: their M tiles
// as bricks bw wide along W with the (z, y) rows shared out as conv3.cu's
// planner does (H the larger share).
void bricks(MmaArgs& a, int warps) {
  const int rows = (warps / a.wn > 0 ? warps / a.wn : 1) * a.tm * 16 / a.bw;
  a.bd = 1;
  a.bh = 1;
  while (a.bd * a.bh < rows) {
    if (a.bh <= a.bd && a.bh < a.Gh) a.bh *= 2;
    else if (a.bd < a.Gd) a.bd *= 2;
    else if (a.bh < a.Gh) a.bh *= 2;
    else a.bd *= 2;
  }
}

// The least split of K ranges, from `least` up, that gives the grid at
// least MIN_BLOCKS blocks, or the most the chunks allow.
void fill_card(MmaArgs& a, int least) {
  a.split = least;
  shape(a);
  for (int s = least + 1; s <= a.nchunk && n_blocks(a) < MIN_BLOCKS; ++s) {
    const int cps = ceil_div(a.nchunk, s);
    if (ceil_div(a.nchunk, cps) != s) continue;
    a.split = s;
    shape(a);
  }
}

// The K ranges of chunk ck: all of ci on one block where the body keeps a
// running total (2 M tiles a warp), else as many chunks a block as one
// accumulator chain holds (with the residual tap one).
int least_split(const MmaArgs& a, int chain) {
  const int nchunk = ceil_div(a.ci, a.ck);
  if (a.res) return nchunk;
  if (a.tm == 2) return 1;
  const int cps = chain / a.ck > 0 ? chain / a.ck : 1;
  return ceil_div(nchunk, cps);
}

// The planner. M tiles a warp: 4, or 2 at stride 2 (whose bricks read
// about 8x their outputs), where the 2-tile body folds each chunk into a
// running total; the whole co up to 96 a block in warps of 24 channels
// (fewer where nothing fits); 8 warps a block in 'bfloat16', 4 in 'mixed'
// (whose lo pass takes registers), bricks as above, 16 wide where a row of
// 9 to 16 then fits in one; all of ci in one chunk where one accumulator
// chain holds it (MAX_CK, MIXED_CK in 'mixed'), else the deepest of 96,
// 64, 48, 32, 16 within that chain; the first of these that keeps the
// block within SMEM_BUDGET. A block takes the chunks least_split gives
// it; a grid of fewer than MIN_BLOCKS blocks splits its K ranges further,
// then takes smaller chunks, until it has them.
void choose(MmaArgs& a) {
  const int chain = a.w_pass == 2 ? MIXED_CK : MAX_CK;
  const int ci8 = ceil_div(a.ci, 8) * 8;
  a.tm = a.mode == 1 ? 2 : 4;
  a.bw = a.Gw > 8 && a.Gw <= 16 ? 16 : 8;  // a row of up to 16 in one brick
  const int chunks[6] = {ci8, 96, 64, 48, 32, 16};
  const int most = a.w_pass == 2 ? 4 : 8;  // warps a block
  bool found = false;
  for (int wn = ceil_div(a.co, WARP_N) < 4 ? ceil_div(a.co, WARP_N) : 4;
       wn >= 1 && !found; --wn)
    for (int ck : chunks) {  // whole ci first, at each block size
      if (ck > chain || (ck != ci8 && ck >= ci8) || found) continue;
      for (int warps = most; warps >= 4 && !found; warps /= 2) {
        a.wn = wn;
        bricks(a, warps);
        a.ck = ck;
        a.split = least_split(a, chain);
        found = shape(a) && a.smem <= SMEM_BUDGET;
      }
    }
  if (!found) {  // the least memory: one warp along N, the smallest chunk
    a.wn = 1;
    bricks(a, 4);
    a.ck = ci8 < 16 ? ci8 : 16;
    a.split = least_split(a, chain);
  }
  fill_card(a, a.split);
  while (n_blocks(a) < MIN_BLOCKS && a.ck > 16 && a.ck % 16 == 0) {
    a.ck = a.ck > 32 ? a.ck - 16 * (a.ck / 48) : 16;
    fill_card(a, least_split(a, chain));
  }
}

// voxels a block of the reduce kernel: 16, or 2 on grids too small to
// fill the card with blocks of 16
int reduce_rows(const MmaArgs& a) {
  const long long m_out = (long long)a.Do * a.Ho * a.Wo;
  return m_out < 16LL * 8 * NUM_SMS ? 2 : REDUCE_ROWS;
}

// rows of moment partials: the reduce kernel's blocks, or the bricks of
// each class
int n_part(const MmaArgs& a) {
  const long long m_out = (long long)a.Do * a.Ho * a.Wo;
  const int rows = reduce_rows(a);
  return a.split > 1 ? (int)((m_out + rows - 1) / rows)
                     : a.nbd * a.nbh * a.nbw * n_classes(a);
}

void fill_plan(const MmaArgs& a, int* plan) {
  plan[P_TM] = a.tm; plan[P_BD] = a.bd; plan[P_BH] = a.bh;
  plan[P_BW] = a.bw; plan[P_WN] = a.wn; plan[P_CK] = a.ck;
  plan[P_SPLIT] = a.split;
  plan[P_NPART] = n_part(a);
  plan[P_THREADS] = a.threads;
  plan[P_SMEM] = a.smem;
  plan[P_PW] = a.pw;
  plan[P_PL] = a.pl;
  plan[P_BLOCKS] = (int)n_blocks(a);
  plan[P_CONFLICT] = conflict_degree(a);
  plan[P_CHUNKS] = a.cps;
}

// Take the plan's chosen fields, or choose them all where P_TM is 0.
bool planned(MmaArgs& a, const int* plan) {
  if (plan[P_TM] == 0) {
    choose(a);
  } else {
    a.tm = plan[P_TM]; a.bd = plan[P_BD]; a.bh = plan[P_BH];
    a.bw = plan[P_BW]; a.wn = plan[P_WN]; a.ck = plan[P_CK];
    a.split = plan[P_SPLIT];
  }
  return shape(a);
}

template <int TM, int MODE, int NP>
cudaError_t launch(const MmaArgs& a, cudaStream_t stream) {
  static bool attr = false;  // raise the dynamic shared memory cap once
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3_mma<TM, MODE, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((unsigned)(a.nbd * a.nbh * a.nbw),
                  (unsigned)ceil_div(a.co, a.cot),
                  (unsigned)(n_classes(a) * a.split));
  conv3_mma<TM, MODE, NP><<<grid, a.threads, a.smem, stream>>>(a);
  return cudaGetLastError();
}

template <int TM, int NP>
cudaError_t launch_mode(const MmaArgs& a, cudaStream_t stream) {
  if (a.mode == 1) return launch<TM, 1, NP>(a, stream);
  if (a.mode == 2) return launch<TM, 2, NP>(a, stream);
  return launch<TM, 0, NP>(a, stream);
}

template <int TM>
cudaError_t launch_tm(const MmaArgs& a, cudaStream_t stream) {
  return a.w_pass == 2 ? launch_mode<TM, 2>(a, stream)
                       : launch_mode<TM, 1>(a, stream);
}

}  // namespace

// The launch plan of the tensor-core body for a (D, H, W) input with ci
// channels, co outputs, a mode, the weight's passes (1 bf16, 2 hi and lo;
// the planner sizes blocks by them) and res (1: the calls take the
// residual tap, which reads a block's one chunk): plan is an int array of
// P_COUNT entries. With plan[0] == 0 the planner chooses; otherwise the
// first seven entries (M tiles a warp 2 or 4, brick depth, height and
// width (a multiple of 8), warps along N (24 channels each), chunk (a
// multiple of 16 up to 96, or all of ci up to 96), split (the K ranges,
// each of ceil(chunks / split) chunks, on blocks of their own; with 4 M
// tiles a warp a range holds at most 96 channels)) are taken as given. The
// call fills the rest: rows of moment partials, threads, shared memory
// bytes, slot pitches, blocks, the bank-conflict degree and the chunks a
// block. A split above 1 needs a workspace of split (twice that with a
// residual) x Do*Ho*Wo x co floats.
M3SEG_API int m3seg_conv3_mma_plan(int D, int H, int W, int ci, int co,
                                   int mode, int w_pass, int res,
                                   int* plan) {
  if (D <= 0 || H <= 0 || W <= 0 || ci <= 0 || co <= 0 || mode < 0 ||
      mode > 2 || w_pass < 1 || w_pass > 2 || res < 0 || res > 1 ||
      plan == nullptr)
    return (int)cudaErrorInvalidValue;
  MmaArgs a = geometry<MmaArgs>(D, H, W, ci, co, mode);
  a.w_pass = w_pass;
  a.res = res;
  if (!planned(a, plan)) return (int)cudaErrorInvalidValue;
  fill_plan(a, plan);
  return 0;
}

// conv3's 'bfloat16' and 'mixed' instances. x1, x2, y and r bf16; w: the
// packed B fragments (w_pass, 27, ceil(ci / 16), ceil(co / 8), 32) of
// 8 bytes, w_pass 1 (bf16 weights) or 2 (their hi and lo parts); wr: the
// residual tap's (r_pass, 1, ...) or null; bias, scale, shift and br fp32;
// part, rpart: the plan's (n_part, 2, co) moment partials, each with its
// (2, co) sums mom, rmom (or all null).
// Everything else as m3seg_conv3 (conv3.cu), with m3seg_conv3_mma_plan's
// plan for w_pass and the residual. Mode 1 (stride 2) takes the moment
// partials of the rounded outputs instead of their fp32 values: the
// reference's down conv reads its GroupNorm moments from its decimated
// bf16 volume.
M3SEG_API int m3seg_conv3_bf16(const void* x1, const void* x2, const void* w,
                               int w_pass, const float* bias,
                               const float* scale, const float* shift,
                               int pro_act, const void* wr, int r_pass,
                               const float* br, void* y, void* r,
                               float* part, float* rpart, float* mom,
                               float* rmom, float* ws, int D, int H, int W,
                               int c1, int c2, int co, int mode,
                               const int* plan, int halo_keep, int dsrc,
                               void* stream) {
  if (!args_ok(x2, scale, shift, wr, r, part, rpart, D, H, W, c1, c2, co,
               mode, pro_act, plan, halo_keep, dsrc) ||
      w_pass < 1 || w_pass > 2 ||
      (wr != nullptr && (r_pass < 1 || r_pass > 2)) ||
      (part != nullptr) != (mom != nullptr) ||
      (rpart != nullptr) != (rmom != nullptr))
    return (int)cudaErrorInvalidValue;
  MmaArgs a = geometry<MmaArgs>(D, H, W, c1 + c2, co, mode);
  a.w_pass = w_pass;
  a.res = r != nullptr;
  if (!planned(a, plan)) return (int)cudaErrorInvalidValue;
  a.halo = halo_keep >= 0;
  a.keep_lo = halo_keep >= 0 && (halo_keep & 1);
  a.keep_hi = halo_keep >= 0 && (halo_keep & 2);
  a.dsrc = dsrc;
  a.x1 = static_cast<const __nv_bfloat16*>(x1);
  a.x2 = static_cast<const __nv_bfloat16*>(x2);
  a.w = static_cast<const uint2*>(w);
  a.wr = static_cast<const uint2*>(wr);
  a.bias = bias; a.scale = scale; a.shift = shift; a.br = br;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.r = static_cast<__nv_bfloat16*>(r);
  a.part = part; a.rpart = rpart; a.ws = ws;
  a.c1 = c1; a.c2 = c2; a.pro_act = pro_act;
  a.stats_rounded = mode == 1;
  a.r_pass = r_pass;
  a.nks = ceil_div(a.ci, 16);
  a.nnt = ceil_div(co, WARP_N) * TN;
  a.unit = c1 % 8 == 0 && c2 % 8 == 0 ? 8 : 4;
  if (a.split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = a.tm == 4 ? launch_tm<4>(a, s) : launch_tm<2>(a, s);
  if (err == cudaSuccess && a.split > 1)
    err = launch_split_sum<__nv_bfloat16>(
        a.ws, a.split, (long long)a.Do * a.Ho * a.Wo, a.co, reduce_rows(a),
        a.bias, a.y, a.part, a.br, a.r, a.rpart, a.stats_rounded, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_moment_sum(part, rpart, n_part(a), co, mom, rmom, s);
}
