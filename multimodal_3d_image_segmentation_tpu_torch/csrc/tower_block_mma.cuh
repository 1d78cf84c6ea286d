// The body of one fused tower block on the bf16 tensor cores (mma.sync):
// the 'bfloat16' and 'mixed' instances of all three tower kernels,
// csrc/tower_block.cu (z read from a tensor), csrc/tower_block_s.cu (z
// from its z pass) and csrc/tower_resident.cu (z from its z phase, x
// and z read through L2).
//
// Replaces, in those instances: multimodal_3d_image_segmentation_tpu/
//   kernels/tower_block.py fused_tower_block (pallas_call in
//   _run_tower_kernel, tower_block.py:377, body _tower_kernel), and the
//   same body in kernels/tower_block_s.py (_run_tower_kernel_s, :332) and
//   kernels/tower_resident.py (_run_resident, :244): every product of the
//   TPU kernels' bf16 (one MXU pass) and packed bf16x3 ('mixed') dots.
//
// Computes what tower_block.cuh's FMA body computes, for one depth plane d
// of the tower grid (D, H, W), C channels, and one tile of kMmaTW columns
// of W, x and out channels-last (D, H, W, C) bf16:
//   y    = the inverse W stage of z            (2TW rows) x (C KH columns)
//   y1   = [ha ; hb]^T y                       per column: H rows x C
//   p, q, ds = x [W_conv ; W_cc_x ; W_ds]^T    per column: H rows x (2C+nds)
//   t    = selu(y1 + (p + b_conv));  out = selu(t W_cc_t^T + (q + b_cc))
//   F    = Mh^T out                            per column: 2KH rows x C
//   f    = the forward W stage of F            (C KH rows) x (2 KW columns)
// and writes the tile's partial f (fp32); tower_spectrum.cuh's tile sum
// adds the tiles in tile order, as it does after the FMA body.
//
// Every product is mma.sync.m16n8k16 with bf16 operands and fp32
// accumulators (m16n8k8 for a K remainder of 8: C 24, 2KH 56):
//   'bfloat16' (NP = 1): every operand is a bf16 value, rounded where the
//     twin rounds (z, y, t, F; the stage matrices and weights come rounded),
//     so each product is one pass and only the order of the sums differs
//     from the twin's;
//   'mixed' (NP = 3): an fp32 value is three bf16 parts, each the rounding
//     of what the parts before leave (kernels/tower_block.py parts3; the
//     first two are kernels/_common.py::hi_lo's split): the weights and
//     stage matrices come so packed, and the fp32 operands (z, y, t, F) are
//     split so in registers; an fp32 operand times a matrix takes the six
//     products of parts p and q with p + q < 3, a bf16 operand (x, out)
//     the three of the matrix's parts: fp32-class sums, as the twin's. (Two
//     parts, the reference's bf16x3, carry each value to 2^-17 only: they
//     flip bf16 roundings of out that the twin keeps, and HartleyMHASeg's
//     trained-network gate, whose 'mixed' twin sums exact fp32, failed on
//     them, 3-9x the twins64 path's argmax disagreement on an H100.)
// Each k step sums into a fresh accumulator, folded into the total with
// an RN add (fold, below). The matrices come packed once in fragment order
// (kernels/tower_block.py mma_mats, mma_weights): one 16-byte load a lane
// for an A fragment, 8 bytes for a B fragment. The m16n8 accumulator of t
// is, pair by pair, the A fragment of t's own product with W_cc_t, so the
// tail runs in registers from x and y1 to out.
//
// What bounds it on an H100: bytes. At HNOSeg's serving shape (grid 121 x
// 121 x 78, C 24, KH = KW = 28) a call reads x (54.8 MB bf16) and z (18.2
// MB) and writes out (54.8 MB) and f (9.1 MB): 0.041 ms at 3.35 TB/s; its
// 12.9 GFLOP take 0.013 ms at 989 TFLOP/s. What stands above that bound,
// and what the design does about it:
//   - the partial spectra, one per W tile, cross device memory once each
//     way: a block takes one plane and a tile of kMmaTW = 16 columns, half
//     the tiles of the FMA body's 8 (91 MB each way at HNOSeg's shape), and
//     writes each warp's 16 rows of a part as whole 16-byte runs, staged in
//     shared memory;
//   - the 48 SELUs a voxel: a branch-free SELU (selu_fast), about half the
//     instructions of expm1f's;
//   - one block of 16 warps an SM ('mixed' takes up to 226 KB of shared
//     memory): the y tile, the tile's out (bf16, all H rows) and F live
//     in shared memory (y and F as bf16 values, or fp32 in 'mixed'), out
//     is written once and never read back;
//     each warp keeps its H rows' inverse H A fragments in registers, and
//     the weights' and the tile's W stages' fragments are staged in shared
//     memory;
//   - four phases a block, each a set of warp tiles: inverse W (M = the 2TW
//     rows, N = (c, k), K = [re j | im j]; z read straight into B
//     fragments, two n tiles' loads in flight), inverse H and the tail (16
//     H rows of one column; ldmatrix for y), forward H (one m tile of 2KH,
//     4 columns, K = the H rows), forward W (M = (c, k), N = [re j | im
//     j], K = [re w | im w]); a phase clock (phase_clock) times them;
//   - shared-memory rows of an odd number of 16-byte units (or a swizzle,
//     f_index, f_index32), so the 8 rows of a fragment's loads fall in 8
//     distinct bank groups.
// No atomics: every sum has one order, so a second run gives the same bits.
#pragma once

#include "tower_block.cuh"

namespace {

constexpr int kMmaTW = 16;                // columns of W a block
constexpr int kMmaWarps = 16;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaMTW = 2 * kMmaTW / 16;  // m tiles of the inverse W stage
constexpr int kMmaKSF = 2 * kMmaTW / 16;  // k steps of the forward W stage
constexpr int kMmaMaxSmem = 232448;       // bytes a block may use on sm_90
constexpr int kMaxKSIH = (2 * kMaxKH + 15) / 16;  // k steps of inverse H
constexpr int kMmaMaxKW = 32;             // KW of the body (z's loads)
constexpr int kMaxKSW = 2 * kMmaMaxKW / 16;  // k steps of inverse W

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// A shared-memory row of at least n bf16 values: a whole and odd number of
// 16-byte units, so that the 8 rows of a fragment's 32-bit loads fall in 8
// distinct bank groups.
__host__ __device__ inline int mma_pitch(int n) {
  const int p = round_up(n, 8);
  return (p / 8) % 2 ? p : p + 8;
}

// The sizes of one call's GEMMs and where a block keeps its operands in
// shared memory; the host computes them once a launch.
struct MmaGeom {
  int n_tiles;     // W tiles of kMmaTW columns
  int nht;         // tiles of 16 H rows
  int kih, ksih;   // K of the inverse H stage (2KH up to 8), its k steps
  int kwp, ksw;    // KW up to 8; k steps of the inverse W stage (2 kwp)
  int mth;         // m tiles of the forward H stage (2KH rows)
  int ntf;         // n8 tiles of the forward W stage (2 kwp columns)
  int py, yw;      // y tile: a (w, c) row's pitch, a column's (C py + 8)
  int ph;          // out tile: a (w, c) row's pitch
  int sp;          // a warp's staged partial rows: their pitch (2 kwp + 8)
  // shared memory, bytes: the B fragments of wcat and wcc, the tile's
  // inverse W A fragments and forward W B fragments, the y tile (then the
  // F tile; bf16 in 'bfloat16', fp32 in 'mixed'), the out tile (then each
  // warp's staged partial rows)
  int s_wcat, s_wcc, s_iw, s_fw, s_y, s_out, smem;
};

__host__ __device__ inline MmaGeom mma_geom(int C, int H, int W, int KH,
                                            int KW, int np) {
  MmaGeom g;
  g.n_tiles = (W + kMmaTW - 1) / kMmaTW;
  g.nht = (H + 15) / 16;
  g.kih = round_up(2 * KH, 8);
  g.ksih = (g.kih + 15) / 16;
  g.kwp = round_up(KW, 8);
  g.ksw = 2 * g.kwp / 16;
  g.mth = (2 * KH + 15) / 16;
  g.ntf = 2 * g.kwp / 8;
  g.py = mma_pitch(g.kih);
  g.yw = C * g.py + 8;
  g.ph = mma_pitch(16 * g.nht);
  g.sp = 2 * g.kwp + 8;
  const int ksc = (C + 15) / 16, nc = C / 8;
  g.s_wcat = 0;  // room for 2C + 8 ds rows
  g.s_wcc = g.s_wcat + np * ksc * (2 * nc + 1) * 32 * 8;
  g.s_iw = g.s_wcc + np * ksc * nc * 32 * 8;
  g.s_fw = g.s_iw + np * kMmaMTW * g.ksw * 32 * 16;
  g.s_y = g.s_fw + np * kMmaKSF * g.ntf * 32 * 8;
  // the y and F tiles: bf16 values (np 1) or fp32 (split in registers)
  g.s_out = g.s_y + (np == 1 ? 2 : 4) *
                        imax(kMmaTW * g.yw, C * KH * 2 * kMmaTW);
  g.smem = g.s_out + imax(2 * kMmaTW * C * g.ph, 4 * kMmaWarps * 16 * g.sp);
  return g;
}

__host__ inline size_t mma_smem_bytes(int C, int H, int KH, int KW, int np) {
  return (size_t)mma_geom(C, H, kMmaTW, KH, KW, np).smem;
}

// The packed stage matrices, one buffer in this order (uint4: an A
// fragment's 16 bytes a lane; uint2: a B fragment's 8; NP parts, p = 0
// the values or hi, then mid and lo):
//   iw [n_tiles][NP][kMmaMTW][ksw][32]  A: the tile's inverse W matrix
//   ih [NP][nht][ksih][32]              A: [ha ; hb]^T, H rows x 2KH
//   fh [NP][mth][nht][32]               A: Mh^T, 2KH rows x H
//   fw [n_tiles][NP][kMmaKSF][ntf][32]  B: the tile's forward W matrix
struct MmaMats {
  const uint4* iw;
  const uint4* ih;
  const uint4* fh;
  const uint2* fw;
};

__host__ inline MmaMats mma_mats(const void* base, const MmaGeom& g,
                                 int np) {
  MmaMats m;
  m.iw = static_cast<const uint4*>(base);
  m.ih = m.iw + (size_t)g.n_tiles * np * kMmaMTW * g.ksw * 32;
  m.fh = m.ih + (size_t)np * g.nht * g.ksih * 32;
  m.fw = reinterpret_cast<const uint2*>(m.fh + (size_t)np * g.mth * g.nht *
                                                   32);
  return m;
}

// What the blocks of a launch share.
struct MmaArgs {
  MmaMats m;
  const float* ds_prev;   // (D, H, W, nds) fp32, or null
  float* partial;         // (D, n_tiles, 2, C, KH, KW) fp32
  float* ds_out;          // (D, H, W, nds) fp32, or null
  int H, W, KH, KW, nds;
  MmaGeom g;
};

// One tower block's volumes and weights: a launch's own, or in
// tower_resident the block's of the tower.
struct MmaIo {
  const bf16* x;          // (D, H, W, C)
  bf16* out;              // (D, H, W, C)
  const uint2* wcat;      // [NP][ceil(C/16)][ceil((2C + nds)/8)][32] B
  const uint2* wcc;       // [NP][ceil(C/16)][C/8][32] B
  const float* bias;      // (2C,) fp32
};

// The phase clock: each block of the last launch writes the global timer
// (ns) at its start and at the end of its four phases (inverse W with the
// staging of its fragments, inverse H and tail, forward H, forward W), for
// the first kMmaClockBlocks (plane, tile) items; a body without `forward`
// writes the first three readings only (its start, the ends of inverse W
// and of inverse H and tail). The array lives in an anonymous namespace,
// so each .cu that includes this header keeps its own clock, which its C
// entry reads with read_mma_clock (m3seg_tower_block_phase_ns,
// m3seg_tower_block_s_phase_ns, m3seg_tower_resident_mma_phase_ns).
constexpr int kMmaClockBlocks = 8192;
__device__ long long g_tower_mma_clock[kMmaClockBlocks * 5];

// This translation unit's phase clock: n_blocks x 5 readings into dst
// (host); synchronous with the device.
__host__ inline cudaError_t read_mma_clock(long long* dst, int n_blocks) {
  if (n_blocks < 0 || n_blocks > kMmaClockBlocks) return cudaErrorInvalidValue;
  return cudaMemcpyFromSymbol(dst, g_tower_mma_clock,
                              sizeof(long long) * 5 * n_blocks);
}

__device__ __forceinline__ void phase_clock(size_t blk, int phase) {
  if (threadIdx.x == 0 && blk < kMmaClockBlocks) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_tower_mma_clock[blk * 5 + phase] = t;
  }
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 operands, fp32 sums
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 8) b (8 x 8): a's registers 0 and 1 (its first 8 columns)
__device__ __forceinline__ void mma8(float (&c)[4], const unsigned (&a)[4],
                                     unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// one k step: a k16, or with k8 a k8 on the first halves
__device__ __forceinline__ void mma_step(float (&c)[4], const unsigned (&a)[4],
                                         uint2 b, bool k8) {
  if (k8) mma8(c, a, b.x);
  else mma16(c, a, b.x, b.y);
}

// The tensor cores add a k step's products to the accumulator with
// truncation, and a chain of steps into one accumulator drifts from the
// fp32 sums of the twins (on an H100 it doubled the share of f's elements
// more than one bf16 ulp from the twin's). So every k step sums into a
// fresh accumulator c and is folded into the total with an RN add; the
// first step's sum is the total. In 'mixed' the products of the smaller
// parts sum in an accumulator of their own, so that they are not cut at
// the scale of the leading product's, and fold in after it.
__device__ __forceinline__ void fold(float (&acc)[4], const float (&c)[4],
                                     bool first) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = first ? c[e] : __fadd_rn(acc[e], c[e]);
}

// the branch-free SELU of the tensor-core bodies (common.cuh)
using m3seg::selu_fast;

// (a, b) rounded to bf16, a in the low half
__device__ __forceinline__ unsigned bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// (a, b) as NQ bf16 pairs: 1 rounded ('bfloat16'); 3 the hi, mid and lo
// parts ('mixed'), each the rounding of what the parts before leave (each
// difference exact in fp32; the first two are hi_lo's split)
template <int NQ>
__device__ __forceinline__ void split(float a, float b, unsigned (&q)[NQ]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    q[i] = bf2(a, b);
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q[i]));
    a -= f.x;
    b -= f.y;
  }
}

__device__ __forceinline__ unsigned lds32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void sts32(bf16* p, unsigned v) {
  *reinterpret_cast<unsigned*>(p) = v;
}

// ldmatrix: four (two) 8 x 8 b16 matrices, row addresses from lanes 0-31
// (0-15)
__device__ __forceinline__ void ldsm4(const bf16* p, unsigned (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm2(const bf16* p, unsigned& r0,
                                      unsigned& r1) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// The B fragments of one k step of the inverse H stage for every n tile of
// C, from a column's y rows yc ([c][py], bf16): b[nc] = (k' 16 ks + 2t,
// + 8) of channel 8 nc + g, by ldmatrix (two n tiles an x4); with k8 the
// first halves only, x4 over up to four n tiles. lane: the lane's row
// address is row (lane & 7) + 8 (lane >> 4) of the n tile pair, column
// half (lane >> 3) & 1.
template <int NC>
__device__ __forceinline__ void y_fragments(const bf16* yc, int py, int ks,
                                            bool k8, int lane,
                                            uint2 (&b)[NC]) {
  if (k8) {  // matrix m = n tile m (lanes 8m .. 8m + 7), columns 16 ks ..
    const int m = min(lane >> 3, NC - 1);
    unsigned r[4];
    ldsm4(yc + (8 * m + (lane & 7)) * py + 16 * ks, r);
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) b[nc] = make_uint2(r[nc], 0u);
    return;
  }
#pragma unroll
  for (int nc = 0; nc < NC; nc += 2) {
    if (nc + 1 < NC) {
      unsigned r[4];
      ldsm4(yc + (8 * nc + (lane & 7) + 8 * (lane >> 4)) * py + 16 * ks +
                8 * ((lane >> 3) & 1),
            r);
      b[nc] = make_uint2(r[0], r[1]);
      b[nc + 1] = make_uint2(r[2], r[3]);
    } else {
      unsigned r0, r1;
      ldsm2(yc + (8 * nc + (lane & 7)) * py + 16 * ks + 8 * ((lane >> 3) & 1),
            r0, r1);
      b[nc] = make_uint2(r0, r1);
    }
  }
}

// The same k step's B fragments from a column's fp32 y rows yc ([c][py],
// 'mixed'), each split into NQ parts: b[nc][q] = part q of (k' 16 ks + 2t,
// + 8) of channel 8 nc + g (k8: the first half only).
template <int NC, int NQ>
__device__ __forceinline__ void y_fragments32(const float* yc, int py, int ks,
                                              bool k8, int gq, int tq,
                                              uint2 (&b)[NC][NQ]) {
#pragma unroll
  for (int nc = 0; nc < NC; ++nc) {
    const float* r = yc + (8 * nc + gq) * py + 16 * ks + 2 * tq;
    unsigned h0[NQ], h1[NQ] = {};
    const float2 v0 = *reinterpret_cast<const float2*>(r);
    split<NQ>(v0.x, v0.y, h0);
    if (!k8) {
      const float2 v1 = *reinterpret_cast<const float2*>(r + 8);
      split<NQ>(v1.x, v1.y, h1);
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) b[nc][q] = make_uint2(h0[q], h1[q]);
  }
}

// One k step of the inverse H stage into y1 (rows 16 ht .. of one
// column): av the lane's A fragments of the step, one a part; yc the
// column's y rows (bf16, or fp32 split into NP parts); the products of
// part p of A and part q of y for p + q < NP; K8 the last step of a K
// that is not a multiple of 16.
template <int NC, int NP, bool K8>
__device__ __forceinline__ void y1_step(float (&y1)[NC][4],
                                        const uint4 (&av)[NP], const void* yc,
                                        int py, int ks, int lane) {
  uint2 b[NC][NP];  // y's parts: its bf16 values, or split from fp32
  if constexpr (NP == 1) {
    uint2 b1[NC];
    y_fragments<NC>(static_cast<const bf16*>(yc), py, ks, K8, lane, b1);
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) b[nc][0] = b1[nc];
  } else {
    y_fragments32<NC, NP>(static_cast<const float*>(yc), py, ks, K8,
                          lane >> 2, lane & 3, b);
  }
#pragma unroll
  for (int nc = 0; nc < NC; ++nc) {
    float c[4] = {}, e[4] = {};
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const unsigned af[4] = {av[p].x, av[p].y, av[p].z, av[p].w};
#pragma unroll
      for (int q = 0; q < NP - p; ++q) {
        if (p + q == 0) mma_step(c, af, b[nc][q], K8);
        else mma_step(e, af, b[nc][q], K8);
      }
    }
    fold(y1[nc], c, false);
    if constexpr (NP > 1) fold(y1[nc], e, false);
  }
}

// The F tile's element (row, col), rows of 2 kMmaTW = 32 values (16
// words) with the words' bits 2-3 swizzled by bits 1-2 of the row, so that
// the 8 rows of a fragment's 32-bit loads fall in 8 distinct bank groups.
__device__ __forceinline__ int f_index(int row, int col) {
  return row * 2 * kMmaTW + 2 * ((col >> 1) ^ (((row >> 1) & 3) << 2)) +
         (col & 1);
}

// The same for the fp32 F tile ('mixed'): rows of 32 values (16 units of
// 8 bytes), the units' bits 2-3 swizzled by bits 0-1 of the row, so that
// the 8-byte loads of a half warp (4 rows x 4 units) fall in 16 distinct
// units of the 32 banks.
__device__ __forceinline__ int f_index32(int row, int col) {
  return row * 2 * kMmaTW + 2 * ((col >> 1) ^ ((row & 3) << 2)) + (col & 1);
}

// Plane d's z, read from an fp32 z tensor (D, 2, C, KH, KW) straight into
// B fragments. kL2: z was written by the same launch, so it is read
// through L2.
template <bool kL2>
struct ZTensorMma {
  const float* zd;  // z[d]: (2, C, KH, KW)
  int C, KH, KW;

  // (z[part][row][j], z[part][row][j + 1]), row = c KH + k, j even; 0 past
  // KW
  __device__ __forceinline__ float2 pair(int part, int row, int j) const {
    const float* p = zd + ((size_t)part * C * KH + row) * KW + j;
    if ((KW & 1) == 0)  // 8-byte aligned
      return j < KW ? m3seg::ldg_or_cg<kL2>(reinterpret_cast<const float2*>(p))
                    : make_float2(0.f, 0.f);
    return make_float2(j < KW ? m3seg::ldg_or_cg<kL2>(p) : 0.f,
                       j + 1 < KW ? m3seg::ldg_or_cg<kL2>(p + 1) : 0.f);
  }
};

// Copies n16 16-byte units from device memory to shared memory.
__device__ __forceinline__ void stage16(void* dst, const void* src, int n16) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n16; i += kMmaThreads) d[i] = __ldg(s + i);
}

// One block of the kernel on plane d, W tile `tile`. NP: the parts of a
// matrix (1 'bfloat16', 3 'mixed'). zsrc supplies z as B-fragment pairs
// (ZTensorMma). Without `forward` the block writes out (and ds) only. x is
// read through L2 where kL2 (it may be written by the same launch); x and
// out never alias.
template <int C, int NP, bool kL2, class ZSrc>
__device__ __forceinline__ void tower_block_mma_body(const ZSrc& zsrc, int d,
                                                     int tile, bool forward,
                                                     const MmaArgs& a,
                                                     const MmaIo& io) {
  constexpr int NC = C / 8;           // n8 tiles of C
  constexpr int KSC = (C + 15) / 16;  // k steps over C
  constexpr bool kC8 = C % 16 != 0;   // C's last k step is a k8
  extern __shared__ __align__(16) unsigned char tower_mma_smem[];
  const MmaGeom& g = a.g;
  const int KH = a.KH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int w0 = tile * kMmaTW, nw = min(kMmaTW, a.W - w0);
  const int n_cat = 2 * NC + (a.nds > 0);
  const size_t blk = (size_t)d * g.n_tiles + tile;
  phase_clock(blk, 0);
  uint2* wcat_s = reinterpret_cast<uint2*>(tower_mma_smem + g.s_wcat);
  uint2* wcc_s = reinterpret_cast<uint2*>(tower_mma_smem + g.s_wcc);
  uint4* iw_s = reinterpret_cast<uint4*>(tower_mma_smem + g.s_iw);
  uint2* fw_s = reinterpret_cast<uint2*>(tower_mma_smem + g.s_fw);
  // the y tile [w][c][part KH + k], then the F tile [c KH + k][part TW +
  // w]: bf16 values ('bfloat16') or fp32 ('mixed')
  bf16* ys = reinterpret_cast<bf16*>(tower_mma_smem + g.s_y);
  float* ys32 = reinterpret_cast<float*>(tower_mma_smem + g.s_y);
  bf16* os = reinterpret_cast<bf16*>(tower_mma_smem + g.s_out);

  // the block's small matrices: the weights' and the tile's W stages'
  // fragments
  stage16(wcat_s, io.wcat, NP * KSC * n_cat * 32 / 2);
  stage16(wcc_s, io.wcc, NP * KSC * NC * 32 / 2);
  stage16(iw_s, a.m.iw + (size_t)tile * NP * kMmaMTW * g.ksw * 32,
          NP * kMmaMTW * g.ksw * 32);
  stage16(fw_s, a.m.fw + (size_t)tile * NP * kMmaKSF * g.ntf * 32,
          NP * kMmaKSF * g.ntf * 32 / 2);
  __syncthreads();

  // ---- inverse W stage: y (rows [re w | im w]) x (columns (c, k)) =
  // A_iw (the tile's [Cwi^T, -Swi^T ; Swi^T, Cwi^T]) . [zre | zim]^T; a
  // warp takes two n tiles at a time, all their z loads in flight together
  const int n_nt = C * KH / 8;
  for (int nt0 = warp; nt0 < n_nt; nt0 += 2 * kMmaWarps) {
    // z's B-fragment pairs of n tiles nt0 and nt0 + kMmaWarps, every k
    // step (ksw <= kMaxKSW: KW <= 32), k' = 16 ks + 8 h + 2t (+1)
    float2 v[2][kMaxKSW][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int ks = 0; ks < kMaxKSW; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = 16 * ks + 8 * h + 2 * tq;
          const int part = kk >= g.kwp, nt = nt0 + i * kMmaWarps;
          v[i][ks][h] = ks < g.ksw && nt < n_nt
                            ? zsrc.pair(part, 8 * nt + gq, kk - part * g.kwp)
                            : make_float2(0.f, 0.f);
        }
    float acc[2][kMmaMTW][4] = {};
#pragma unroll
    for (int ks = 0; ks < kMaxKSW; ++ks) {
      if (ks >= g.ksw) break;
#pragma unroll
      for (int mt = 0; mt < kMmaMTW; ++mt) {
        uint4 av[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p)
          av[p] = iw_s[((p * kMmaMTW + mt) * g.ksw + ks) * 32 + lane];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          unsigned b0[NP], b1[NP];  // z's parts, k halves 0 and 1
          split<NP>(v[i][ks][0].x, v[i][ks][0].y, b0);
          split<NP>(v[i][ks][1].x, v[i][ks][1].y, b1);
          float c[4] = {}, e[4] = {};
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const unsigned af[4] = {av[p].x, av[p].y, av[p].z, av[p].w};
#pragma unroll
            for (int q = 0; q < NP - p; ++q) {
              if (p + q == 0) mma16(c, af, b0[q], b1[q]);
              else mma16(e, af, b0[q], b1[q]);
            }
          }
          fold(acc[i][mt], c, ks == 0);
          if constexpr (NP > 1) fold(acc[i][mt], e, false);
        }
      }
    }
    // rows 16 mt + g (+ 8): (part, w); columns 8 nt + 2t, + 1: (c, k),
    // (c, k + 1) (KH is even), stored as ys[w][c][part KH + k]
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int nt = nt0 + i * kMmaWarps;
      if (nt >= n_nt) break;
      const int nn = 8 * nt + 2 * tq, c = nn / KH, k = nn % KH;
#pragma unroll
      for (int mt = 0; mt < kMmaMTW; ++mt)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int r = 16 * mt + gq + 8 * rh;
          const int part = r / kMmaTW, w = r % kMmaTW;
          const int off = w * g.yw + c * g.py + part * KH + k;
          const float* pr = acc[i][mt] + 2 * rh;
          if constexpr (NP == 1)
            sts32(ys + off, bf2(pr[0], pr[1]));
          else
            *reinterpret_cast<float2*>(ys32 + off) = make_float2(pr[0], pr[1]);
        }
    }
  }
  // the K padding of each y row (2KH .. kih) reads as zeros
  for (int i = threadIdx.x; i < kMmaTW * C; i += kMmaThreads)
    for (int k = 2 * KH; k < g.kih; k += 2) {
      const int off = (i / C) * g.yw + (i % C) * g.py + k;
      if constexpr (NP == 1)
        sts32(ys + off, 0u);
      else
        *reinterpret_cast<float2*>(ys32 + off) = make_float2(0.f, 0.f);
    }
  __syncthreads();
  phase_clock(blk, 1);

  // ---- inverse H stage and the block tail: one warp tile = 16 H rows of
  // one column, y1, p, q, ds, t and out in registers; a warp keeps its H
  // rows (ht) from tile to tile where nht divides the warps
  const unsigned* x32 = reinterpret_cast<const unsigned*>(io.x);
  float bconv[NC][2], bcc[NC][2];
#pragma unroll
  for (int nc = 0; nc < NC; ++nc)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bconv[nc][e] = __ldg(io.bias + 8 * nc + 2 * tq + e);
      bcc[nc][e] = __ldg(io.bias + C + 8 * nc + 2 * tq + e);
    }
  // units u = (ht, w) with w < nw
  const int n_units = g.nht * nw;
  // 'bfloat16' keeps the A fragments of the warp's H rows in registers
  // while they stay the same; 'mixed''s three parts load each step
  uint4 ihf[NP == 1 ? kMaxKSIH : 1];
  int ih_ht = -1;
  for (int u = warp; u < n_units; u += kMmaWarps) {
    const int ht = u % g.nht, w = u / g.nht;
    const int hr[2] = {16 * ht + gq, 16 * ht + gq + 8};
    const bool ok[2] = {hr[0] < a.H, hr[1] < a.H};
    size_t vox[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      vox[rh] = ok[rh] ? ((size_t)d * a.H + hr[rh]) * a.W + w0 + w : 0;
    // x's A fragments: rows 16 ht + g (+ 8) of column w, channel pairs
    // (register r: k half r / 2, row r % 2); zero past H
    unsigned xa[KSC][4];
#pragma unroll
    for (int ks = 0; ks < KSC; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 16 * ks + 8 * (r / 2) + 2 * tq;
        xa[ks][r] = c < C && ok[r % 2]
                        ? m3seg::ldg_or_cg<kL2>(x32 + (vox[r % 2] * C + c) / 2)
                        : 0u;
      }
    const uint4* ih = a.m.ih + (size_t)ht * g.ksih * 32 + lane;
    if constexpr (NP == 1)
      if (ht != ih_ht) {
        ih_ht = ht;
#pragma unroll
        for (int ks = 0; ks < kMaxKSIH; ++ks)
          if (ks < g.ksih) ihf[ks] = __ldg(ih + ks * 32);
      }
    float y1[NC][4] = {};
    {
      const void* yc = NP == 1 ? static_cast<const void*>(ys + w * g.yw)
                               : static_cast<const void*>(ys32 + w * g.yw);
      const int n16 = g.kih / 16;
#pragma unroll
      for (int ks = 0; ks < kMaxKSIH; ++ks) {
        if (ks > n16 || (ks == n16 && g.kih % 16 == 0)) break;
        uint4 av[NP];
        if constexpr (NP == 1) {
          av[0] = ihf[ks];
        } else {
#pragma unroll
          for (int p = 0; p < NP; ++p)
            av[p] = __ldg(ih + ((size_t)p * g.nht * g.ksih + ks) * 32);
        }
        if (ks < n16)
          y1_step<NC, NP, false>(y1, av, yc, g.py, ks, lane);
        else
          y1_step<NC, NP, true>(y1, av, yc, g.py, ks, lane);
      }
    }
    // p, q and ds: x [W_conv ; W_cc_x ; W_ds]^T, the weight's parts
    float pq[2 * NC + 1][4];
#pragma unroll
    for (int nt = 0; nt < 2 * NC + 1; ++nt)
      if (nt < n_cat) {
#pragma unroll
        for (int ks = 0; ks < KSC; ++ks) {
          float c[4] = {}, e[4] = {};
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const uint2 b = wcat_s[((p * KSC + ks) * n_cat + nt) * 32 + lane];
            if (p == 0) mma_step(c, xa[ks], b, kC8 && ks == KSC - 1);
            else mma_step(e, xa[ks], b, kC8 && ks == KSC - 1);
          }
          fold(pq[nt], c, ks == 0);
          if constexpr (NP > 1) fold(pq[nt], e, false);
        }
      }
    // t = selu(y1 + (p + b_conv)), rounded (or split) into the A fragments
    // of its product with W_cc_t: tiles 2ks and 2ks + 1 are k step ks
    unsigned ta[NP][KSC][4];
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const float t0 = selu_fast(y1[nc][2 * rh] +
                                   (pq[nc][2 * rh] + bconv[nc][0]));
        const float t1 = selu_fast(y1[nc][2 * rh + 1] +
                                   (pq[nc][2 * rh + 1] + bconv[nc][1]));
        unsigned tp[NP];
        split<NP>(t0, t1, tp);
#pragma unroll
        for (int q = 0; q < NP; ++q) ta[q][nc / 2][2 * (nc % 2) + rh] = tp[q];
      }
    float s[NC][4];
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int ks = 0; ks < KSC; ++ks) {
        const bool k8 = kC8 && ks == KSC - 1;
        float c[4] = {}, e[4] = {};
#pragma unroll
        for (int p = 0; p < NP; ++p) {  // t's part q, W_cc_t's part p
          const uint2 b = wcc_s[((p * KSC + ks) * NC + nc) * 32 + lane];
#pragma unroll
          for (int q = 0; q < NP - p; ++q) {
            if (p + q == 0) mma_step(c, ta[q][ks], b, k8);
            else mma_step(e, ta[q][ks], b, k8);
          }
        }
        fold(s[nc], c, ks == 0);
        if constexpr (NP > 1) fold(s[nc], e, false);
      }
    // out = selu(s + (q + b_cc)), bf16, to device memory and to the out
    // tile [w][c][h] (rows past H zero); ds = ds_prev + x W_ds^T
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) {
      const int c = 8 * nc + 2 * tq;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const unsigned ov = bf2(
            selu_fast(s[nc][2 * rh] + (pq[NC + nc][2 * rh] + bcc[nc][0])),
            selu_fast(s[nc][2 * rh + 1] +
                      (pq[NC + nc][2 * rh + 1] + bcc[nc][1])));
        const unsigned ot = ok[rh] ? ov : 0u;
        bf16* o = os + (w * C + c) * g.ph + hr[rh];
        o[0] = reinterpret_cast<const bf16*>(&ot)[0];
        o[g.ph] = reinterpret_cast<const bf16*>(&ot)[1];
        if (ok[rh])
          *reinterpret_cast<unsigned*>(io.out + vox[rh] * C + c) = ov;
      }
    }
    if (a.nds > 0)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * tq + e;
          if (ok[rh] && r < a.nds) {
            const size_t i = vox[rh] * a.nds + r;
            a.ds_out[i] = a.ds_prev[i] + pq[2 * NC][2 * rh + e];
          }
        }
  }
  __syncthreads();  // the out tile is whole; the y tile is dead
  phase_clock(blk, 2);
  if (!forward) return;

  // ---- forward H stage: F (2KH rows) x (C) = Mh^T out, per column, a
  // warp tile = one m tile of 4 columns; F rounded (or split) into the F
  // tile [c KH + k][part TW + w] (f_index)
  bf16* fs = ys;
  float* fs32 = ys32;
  for (int u = warp; u < g.mth * (kMmaTW / 4); u += kMmaWarps) {
    const int mt = u % g.mth, w4 = 4 * (u / g.mth);
    float acc[4][NC][4] = {};
    for (int ks = 0; ks < g.nht; ++ks) {
      uint4 av[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        av[p] = __ldg(a.m.fh + (((size_t)p * g.mth + mt) * g.nht + ks) * 32 +
                      lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (w4 + i >= nw) break;
#pragma unroll
        for (int nc = 0; nc < NC; ++nc) {
          const bf16* orow =
              os + ((w4 + i) * C + 8 * nc + gq) * g.ph + 16 * ks + 2 * tq;
          const unsigned b0 = lds32(orow), b1 = lds32(orow + 8);
          float c[4] = {}, e[4] = {};
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const unsigned af[4] = {av[p].x, av[p].y, av[p].z, av[p].w};
            if (p == 0) mma16(c, af, b0, b1);
            else mma16(e, af, b0, b1);
          }
          fold(acc[i][nc], c, false);
          if constexpr (NP > 1) fold(acc[i][nc], e, false);
        }
      }
    }
    // columns w4 + i, w4 + i + 1 of a row are one 32-bit word
#pragma unroll
    for (int i = 0; i < 4; i += 2)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int k2 = 16 * mt + gq + 8 * rh;
        if (k2 >= 2 * KH) continue;
        const int part = k2 / KH, k = k2 % KH;
#pragma unroll
        for (int nc = 0; nc < NC; ++nc)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * nc + 2 * tq + e;
            const float v0 = acc[i][nc][2 * rh + e];  // 0 past nw
            const float v1 = acc[i + 1][nc][2 * rh + e];
            const int row = c * KH + k, col = part * kMmaTW + w4 + i;
            if constexpr (NP == 1)
              sts32(fs + f_index(row, col), bf2(v0, v1));
            else
              *reinterpret_cast<float2*>(fs32 + f_index32(row, col)) =
                  make_float2(v0, v1);
          }
      }
  }
  __syncthreads();  // the F tile is whole; the out tile is dead
  phase_clock(blk, 3);

  // ---- forward W stage: the tile's partial f, rows (c, k), columns
  // [re j | im j] = F [Cw, Sw ; -Sw, Cw] over the tile's [re w | im w]; a
  // warp tile = one m tile, staged in the warp's rows of the dead out tile
  // and written to device memory as whole 16-byte runs: its 16 rows of
  // each part are KW 16 contiguous floats
  const int ng = C * KH * a.KW;
  float* pd = a.partial + blk * 2 * ng;
  float* st = reinterpret_cast<float*>(os) + warp * 16 * g.sp;
  const float inv_kw = 1.f / a.KW;
  for (int mt = warp; mt < C * KH / 16; mt += kMmaWarps) {
    for (int nt0 = 0; nt0 < g.ntf; nt0 += 4) {
      float acc[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < kMmaKSF; ++ks) {
        unsigned af[NP][4];  // F's parts: its bf16 values, or split
        const int row = 16 * mt + gq;
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // register r: row half r % 2, k r / 2
          const int rr = row + 8 * (r % 2);
          const int col = 16 * ks + 8 * (r / 2) + 2 * tq;
          if constexpr (NP == 1) {
            af[0][r] = lds32(fs + f_index(rr, col));
          } else {
            const float2 v =
                *reinterpret_cast<const float2*>(fs32 + f_index32(rr, col));
            unsigned q3[NP];
            split<NP>(v.x, v.y, q3);
#pragma unroll
            for (int q = 0; q < NP; ++q) af[q][r] = q3[q];
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (nt0 + q < g.ntf) {
            float c[4] = {}, e[4] = {};
#pragma unroll
            for (int p = 0; p < NP; ++p) {  // F's part f, the matrix's p
              const uint2 b =
                  fw_s[((p * kMmaKSF + ks) * g.ntf + nt0 + q) * 32 + lane];
#pragma unroll
              for (int f = 0; f < NP - p; ++f) {
                if (p + f == 0) mma16(c, af[f], b.x, b.y);
                else mma16(e, af[f], b.x, b.y);
              }
            }
            fold(acc[q], c, ks == 0);
            if constexpr (NP > 1) fold(acc[q], e, false);
          }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (nt0 + q < g.ntf)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
            *reinterpret_cast<float2*>(st + (gq + 8 * rh) * g.sp +
                                       8 * (nt0 + q) + 2 * tq) =
                make_float2(acc[q][2 * rh], acc[q][2 * rh + 1]);
    }
    __syncwarp();
    // each part's 16 rows x KW: 4 KW float4s, 16-byte aligned
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      float4* dst = reinterpret_cast<float4*>(pd + (size_t)part * ng +
                                              (size_t)16 * mt * a.KW);
      for (int i = lane; i < 4 * a.KW; i += 32) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // row n / KW, exact in fp32 here
          const int n = 4 * i + e;
          const int r = __float2int_rz((n + 0.5f) * inv_kw);
          v[e] = st[r * g.sp + part * g.kwp + n - r * a.KW];
        }
        dst[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncwarp();
  }
  __syncthreads();
  phase_clock(blk, 4);
}

}  // namespace
