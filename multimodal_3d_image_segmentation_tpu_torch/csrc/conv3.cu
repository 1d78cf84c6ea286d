// k=3 convolution + bias with V-Net-DS's fused options, on channels-last
// fp32 volumes (the fp32 instance; conv3_mma.cu holds the bf16 ones).
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/conv3d_flat.py:305
//   (_conv3_flat_impl, the pallas_call behind conv3_flat): a k=3 SAME conv
//   with an optional second input read as a virtual channel concat, a
//   per-input-channel scale/shift + activation prologue (the previous
//   layer's GroupNorm, deferred), a 1x1 residual tap of the pre-prologue
//   input, and per-channel GroupNorm moment sums of the output. The Pallas
//   kernel's flat padded layout and lane rolls exist for TPU lanes; here
//   the volume stays (D, H, W, C) and the zero padding is a bounds check.
//   Two geometry modes the TPU path expressed with extra passes are folded
//   in: an output stride of 2 (the down convs; the reference convolves at
//   stride 1 and decimates after), and an input dilation of 2 (the
//   transposed up convs, which the reference runs over a zero-interleaved
//   volume with the flipped kernel). The TPU kernel's two depth modes are
//   flags of the same body, both in the input slots' voxel mapping:
//   halo (``_conv3_kernel(halo=True)``, conv3d_flat.py:105-171): the input
//   holds D + 2 planes, the first and the last a neighbouring depth shard's
//   planes; they are read as data (prologue included) where their keep
//   flag is set and as zero padding where it is not (the global volume
//   ends), so logical plane -1 and D read storage planes 0 and D + 1. The
//   output, the residual tap and the moment sums cover the D interior
//   planes only. Stride 2 reads only the previous halo, dilation 2 only
//   the next one. dilated_depth (conv3d_flat.py:159-163, :221-227): a
//   stride-1 conv over the depth-dilated grid of D = 2 dsrc planes, whose
//   even plane 2j reads source plane j and whose odd planes are zero.
//
// What bounds it on an H100: operations. V-Net-DS at base width 24 runs
// 0.305 TFLOP of k=3 convs per 240x240x155 volume (29 launches) and moves
// 1.64 GB; at 67 TFLOP/s fp32 (CUDA cores) and 3.35 TB/s that is 4.6 ms
// of arithmetic against 0.5 ms of memory. The products stay in exact fp32
// FMAs on the CUDA cores (TF32 and wgmma wait for the Dice gate of the
// precision policy).
//
// Design: a direct convolution over bricks. A block owns an output brick
// (bd x bh x nrw*RW voxels of the iteration grid) and a tile of cot output
// channels (the whole co up to 96). The input channels run in chunks of ck:
// for each chunk the block copies the brick's input with its halo into
// shared memory once (cp.async, 4 bytes a value, so the copy also turns
// the channels-last volume into one (z, y, w) plane per channel; outside
// the volume the copy zero-fills), applies the prologue once per value
// inside the volume (the padding stays zero), and copies the chunk's 27 x
// ck x cot weights beside it. Two stages: chunk c+1 is in flight while
// chunk c is computed. Every tap then reads shifted windows of the same
// brick, so a value is fetched from memory and its prologue evaluated
// about halo-ratio times (1.5-3) instead of 27 times. A thread owns a run
// of RW consecutive outputs along W times 8 output channels: it loads one
// input row (the run and its halo) into registers and serves the three kx
// taps from it, with the weights read as float4 broadcasts, 24 FMAs per
// value loaded from shared memory at RW = 8. The pitches of the brick are
// chosen on the host so that a warp's row loads meet no bank conflict
// where a choice avoids one.
//
// Stride 2 reads every other input along each axis (the brick spans 2b+1
// inputs). The dilated mode splits the output into its 8 parity classes:
// along an axis, parity 0 takes the centre tap at source offset 0, parity
// 1 the outer taps at offsets 0 and +1, so each class is a conv over the
// source grid with 1 or 2 taps per axis, 27 tap-volumes over the 8 classes
// (the MACs of the transposed conv itself); the W parity is a template
// argument (two launches), the (z, y) parity the grid's z. Grids that give
// too few blocks for the 132 SMs also split the chunks over blocks; each
// block then writes its partial sums to a workspace and a second kernel
// adds them in a fixed order with the bias and the moment sums. The
// residual tap is a second pass over the chunks, centre tap only, into the
// same registers after the main output is written. Moment sums are
// reduced in a fixed order within a block and written as per-block
// partials, which conv3.cuh's conv3_moment_sum adds in float64 in a fixed
// order. No atomics: the result does not change from run to run.
//
// The 'bfloat16' and 'mixed' instances run another body, on the bf16
// tensor cores (conv3_mma.cu); this file holds the fp32 instance.
#include "conv3.cuh"

namespace {

constexpr int TN = 8;              // output channels per thread
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;   // bytes a block may use on sm_90
constexpr int CHUNK8_SMEM = 100000;  // bytes; deeper chunks measured slower

// the launch plan, an int array shared with the wrapper: the first seven
// fields choose (0 in P_RW: the planner chooses), the rest follow
enum PlanField {
  P_RW, P_BD, P_BH, P_NRW, P_COT, P_CK, P_SPLIT,
  P_NPART, P_THREADS, P_SMEM, P_PW, P_PL, P_BLOCKS, P_CONFLICT,
  P_COUNT
};

struct Conv3Args {
  const float* x1;    // (D, H, W, c1)
  const float* x2;    // (D, H, W, c2) or null
  const float* w;     // (27, ci, co), row ((kz*3+ky)*3+kx)*ci + c
  const float* bias;  // (co,)
  const float* scale;  // (ci,) prologue scale, or null (no prologue)
  const float* shift;  // (ci,) prologue shift
  const float* wr;    // (co, ci) residual tap or null
  const float* br;    // (co,)
  float* y;           // (Do, Ho, Wo, co)
  float* r;           // (Do, Ho, Wo, co) or null
  float* part;        // (n_part, 2, co) moment partials or null
  float* rpart;       // the same for r, or null
  float* ws;          // split > 1: ((1 or 2) x split, Do*Ho*Wo, co)
  int D, H, W, c1, c2, ci, co;
  int Do, Ho, Wo;     // output volume
  int Gd, Gh, Gw;     // iteration grid (the source grid in mode 2)
  int mode;           // 0: stride 1; 1: stride 2; 2: input dilation 2
  int halo;           // 1: the input holds planes -1..D (halo mode)
  int keep_lo, keep_hi;  // halo mode: planes -1 and D are data, not padding
  int dsrc;           // > 0: dilated depth, the input's dsrc source planes
  int pro_act;        // 0 none, 1 elu, 2 selu, 3 relu
  // the plan
  int rw, bd, bh, nrw, cot, ck, split;
  int nbd, nbh, nbw;  // bricks along each axis
  int ez, ey, ew;     // the input brick's extent
  int pw, pl, cpl;    // shared-memory pitches: row, plane, channel
  int nslot;          // input slots a channel (ez * pl)
  int stage;          // floats of one stage: ck * cpl input, 27 ck cot weights
  int nchunk;         // chunks of ck input channels
  int threads;
};

// Along W, for output i of a thread's run and tap t: the run's input
// register v[S*i + off(t)] and the weight tap kx(t). Modes 2 and 3 are the
// dilated mode's W parity 0 and 1.
template <int MODE> struct WTaps {
  static constexpr int S = MODE == 1 ? 2 : 1;
  static constexpr int N = MODE == 2 ? 1 : MODE == 3 ? 2 : 3;
  __device__ static constexpr int kx(int t) {
    return MODE == 2 ? 1 : MODE == 3 ? 2 * t : t;
  }
  __device__ static constexpr int off(int t) { return MODE == 2 ? 0 : t; }
  // inputs a run of RW outputs reads
  template <int RW>
  static constexpr int NIN =
      MODE == 0 ? RW + 2 : MODE == 1 ? 2 * RW + 1 : RW + (MODE == 3);
};

template <int RW, int MODE>
__global__ void __launch_bounds__(MAX_THREADS, 2)
conv3_brick(const Conv3Args a) {
  using WT = WTaps<MODE>;
  constexpr int S = WT::S;
  constexpr int NIN = WT::template NIN<RW>;
  extern __shared__ __align__(16) float smem[];
  int* gvox = reinterpret_cast<int*>(smem + 2 * a.stage);

  const int tid = threadIdx.x;
  const int nrun = a.bd * a.bh * a.nrw;
  const int run = tid % nrun, cg = tid / nrun;
  const int lr = run % a.nrw, ly = (run / a.nrw) % a.bh,
            lz = run / (a.nrw * a.bh);
  const int brick = blockIdx.x;
  const int bw_ = brick % a.nbw, bh_ = (brick / a.nbw) % a.nbh,
            bd_ = brick / (a.nbw * a.nbh);
  const int n0 = blockIdx.y * a.cot;
  const int cls4 = blockIdx.z / a.split, sp = blockIdx.z % a.split;
  const int pz = MODE >= 2 ? cls4 >> 1 : 0, py = MODE >= 2 ? cls4 & 1 : 0;
  const int px = MODE == 3 ? 1 : 0;
  const int gd0 = bd_ * a.bd, gh0 = bh_ * a.bh, gw0 = bw_ * a.nrw * RW;
  const int oz = MODE >= 2 ? gd0 : S * gd0 - 1;
  const int oy = MODE >= 2 ? gh0 : S * gh0 - 1;
  const int ow = MODE >= 2 ? gw0 : S * gw0 - 1;

  // the volume voxel of each input slot (input_voxel): -1 outside the
  // volume (padding, zero-filled), -2 a pitch pad slot (never read)
  for (int s = tid; s < a.nslot; s += a.threads) {
    const int z = s / a.pl, rem = s % a.pl;
    const int yy = rem / a.pw, ww = rem % a.pw;
    gvox[s] = yy < a.ey && ww < a.ew
                  ? input_voxel(oz + z, oy + yy, ow + ww, a.D, a.H, a.W,
                                a.halo, a.keep_lo, a.keep_hi, a.dsrc)
                  : -2;
  }
  __syncthreads();

  // issue the copies of chunk k into stage st: the input brick (main pass)
  // and the weights of the 27 taps, or of the residual's one
  auto load_chunk = [&](int k, int st, bool res) {
    float* in_s = smem + st * a.stage;
    float* w_s = in_s + a.ck * a.cpl;
    const int c0 = k * a.ck;
    for (int s = tid; s < a.nslot; s += a.threads) {
      const int g = gvox[s];
      if (g == -2) continue;
      for (int c = 0; c < a.ck; ++c) {
        const int cc = c0 + c;
        const bool ok = g >= 0 && cc < a.ci;
        const float* src = a.x1;
        if (ok)
          src = cc < a.c1 ? a.x1 + (long long)g * a.c1 + cc
                          : a.x2 + (long long)g * a.c2 + (cc - a.c1);
        cp_async4(in_s + c * a.cpl + s, src, ok);
      }
    }
    if (res) {  // (co, ci): one value a copy
      for (int e = tid; e < a.ck * a.cot; e += a.threads) {
        const int c = e / a.cot, n = e % a.cot;
        const int cc = c0 + c;
        const bool ok = cc < a.ci && n0 + n < a.co;
        cp_async4(w_s + e,
                  ok ? a.wr + (long long)(n0 + n) * a.ci + cc : a.wr, ok);
      }
      return;
    }
    const float* wsrc = a.w;
    const int q4 = a.cot / 4;
    const int total = 27 * a.ck * q4;
    for (int e = tid; e < total; e += a.threads) {
      const int q = e % q4, row = e / q4;  // row = tap * ck + c
      const int c = row % a.ck, tap = row / a.ck;
      const int cc = c0 + c, n = n0 + 4 * q;
      const bool ok = cc < a.ci && n < a.co;
      const float* src =
          ok ? wsrc + ((long long)tap * a.ci + cc) * a.co + n : wsrc;
      cp_async16(w_s + row * a.cot + 4 * q, src, ok);
    }
  };

  // the prologue on the slots this thread copied (its own cp.async writes
  // are visible to it after the wait), inside the volume only
  auto prologue = [&](int k, int st) {
    float* in_s = smem + st * a.stage;
    const int c0 = k * a.ck;
    for (int c = 0; c < a.ck && c0 + c < a.ci; ++c) {
      const float sc = __ldg(a.scale + c0 + c);
      const float sh = __ldg(a.shift + c0 + c);
      float* plane = in_s + c * a.cpl;
      for (int s = tid; s < a.nslot; s += a.threads)
        if (gvox[s] >= 0)
          plane[s] = activate(__fadd_rn(__fmul_rn(plane[s], sc), sh),
                              a.pro_act);
    }
  };

  float acc[RW][TN];

  // one input row (the run and its halo) against the W taps of one (kz,
  // ky) weight row; wt points at tap kx = 0, channel c, column cg * TN
  auto row_taps = [&](const float* row, const float* wt) {
    float v[NIN];
#pragma unroll
    for (int i = 0; i < NIN; ++i) v[i] = row[i];
#pragma unroll
    for (int t = 0; t < WT::N; ++t) {
      const float4* wp =
          reinterpret_cast<const float4*>(wt + WT::kx(t) * a.ck * a.cot);
      const float4 w0 = wp[0], w1 = wp[1];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float xv = v[S * i + WT::off(t)];
        acc[i][0] = fmaf(xv, w0.x, acc[i][0]);
        acc[i][1] = fmaf(xv, w0.y, acc[i][1]);
        acc[i][2] = fmaf(xv, w0.z, acc[i][2]);
        acc[i][3] = fmaf(xv, w0.w, acc[i][3]);
        acc[i][4] = fmaf(xv, w1.x, acc[i][4]);
        acc[i][5] = fmaf(xv, w1.y, acc[i][5]);
        acc[i][6] = fmaf(xv, w1.z, acc[i][6]);
        acc[i][7] = fmaf(xv, w1.w, acc[i][7]);
      }
    }
  };

  auto compute = [&](int k, int st) {
    const float* in_s = smem + st * a.stage;
    const float* w_s = in_s + a.ck * a.cpl + cg * TN;
    const int nc = min(a.ck, a.ci - k * a.ck);
    for (int c = 0; c < nc; ++c) {
      const float* in_c = in_s + c * a.cpl + S * lr * RW;
      if constexpr (MODE < 2) {
#pragma unroll
        for (int kz = 0; kz < 3; ++kz)
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
            row_taps(in_c + (S * lz + kz) * a.pl + (S * ly + ky) * a.pw,
                     w_s + ((kz * 3 + ky) * 3 * a.ck + c) * a.cot);
      } else {
        const int nz = pz ? 2 : 1, ny = py ? 2 : 1;
        for (int tz = 0; tz < nz; ++tz)
          for (int ty = 0; ty < ny; ++ty) {
            const int kz = pz ? 2 * tz : 1, ky = py ? 2 * ty : 1;
            row_taps(in_c + (lz + (pz ? tz : 0)) * a.pl +
                         (ly + (py ? ty : 0)) * a.pw,
                     w_s + ((kz * 3 + ky) * 3 * a.ck + c) * a.cot);
          }
      }
    }
  };

  // the residual: the centre tap of the pre-prologue input (mode 0 only)
  auto compute_res = [&](int k, int st) {
    const float* in_s = smem + st * a.stage;
    const float* w_s = in_s + a.ck * a.cpl + cg * TN;
    const int nc = min(a.ck, a.ci - k * a.ck);
    for (int c = 0; c < nc; ++c) {
      const float* row = in_s + c * a.cpl + (lz + 1) * a.pl +
                         (ly + 1) * a.pw + lr * RW + 1;
      const float4 w0 = *reinterpret_cast<const float4*>(w_s + c * a.cot);
      const float4 w1 =
          *reinterpret_cast<const float4*>(w_s + c * a.cot + 4);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float xv = row[i];
        acc[i][0] = fmaf(xv, w0.x, acc[i][0]);
        acc[i][1] = fmaf(xv, w0.y, acc[i][1]);
        acc[i][2] = fmaf(xv, w0.z, acc[i][2]);
        acc[i][3] = fmaf(xv, w0.w, acc[i][3]);
        acc[i][4] = fmaf(xv, w1.x, acc[i][4]);
        acc[i][5] = fmaf(xv, w1.y, acc[i][5]);
        acc[i][6] = fmaf(xv, w1.z, acc[i][6]);
        acc[i][7] = fmaf(xv, w1.w, acc[i][7]);
      }
    }
  };

  // acc = the contraction over chunks [k0, k1), double-buffered: the
  // copies of chunk k+1 run while chunk k is computed
  auto contract = [&](bool res, int k0, int k1) {
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    load_chunk(k0, 0, res);
    cp_async_commit();
    for (int k = k0; k < k1; ++k) {
      const int st = (k - k0) & 1;
      cp_async_wait_all();
      if (!res && a.scale != nullptr) prologue(k, st);
      __syncthreads();  // chunk k is in; chunk k-1's stage is free
      if (k + 1 < k1) {
        load_chunk(k + 1, st ^ 1, res);
        cp_async_commit();
      }
      if (res)
        compute_res(k, st);
      else
        compute(k, st);
    }
    __syncthreads();  // the stages are free again
  };

  const int gz = gd0 + lz, gy = gh0 + ly;
  const bool row_ok = gz < a.Gd && gy < a.Gh;
  const int nbricks = a.nbd * a.nbh * a.nbw;
  const int ncol = n0 + cg * TN;  // this thread's first output channel

  auto out_voxel = [&](int gw) -> long long {
    if constexpr (MODE >= 2)
      return ((long long)(2 * gz + pz) * a.Ho + 2 * gy + py) * a.Wo +
             2 * gw + px;
    else
      return ((long long)gz * a.Ho + gy) * a.Wo + gw;
  };

  // bias, store, and the block's moment partials in a fixed order
  auto epilogue = [&](float* out, const float* b, float* part) {
    float s[TN], s2[TN], bn[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      s[j] = 0.f;
      s2[j] = 0.f;
      bn[j] = ncol + j < a.co ? __ldg(b + ncol + j) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int gw = gw0 + lr * RW + i;
      if (!row_ok || gw >= a.Gw) continue;
      float* o = out + out_voxel(gw) * a.co + ncol;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (ncol + 4 * q >= a.co) continue;
        float4 v;
        v.x = acc[i][4 * q + 0] + bn[4 * q + 0];
        v.y = acc[i][4 * q + 1] + bn[4 * q + 1];
        v.z = acc[i][4 * q + 2] + bn[4 * q + 2];
        v.w = acc[i][4 * q + 3] + bn[4 * q + 3];
        *reinterpret_cast<float4*>(o + 4 * q) = v;
        s[4 * q + 0] += v.x; s2[4 * q + 0] += v.x * v.x;
        s[4 * q + 1] += v.y; s2[4 * q + 1] += v.y * v.y;
        s[4 * q + 2] += v.z; s2[4 * q + 2] += v.z * v.z;
        s[4 * q + 3] += v.w; s2[4 * q + 3] += v.w * v.w;
      }
    }
    if (part == nullptr) return;
    float* red = smem;  // (2, nrun, cot), in the free stages
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      red[run * a.cot + cg * TN + j] = s[j];
      red[(nrun + run) * a.cot + cg * TN + j] = s2[j];
    }
    __syncthreads();
    const int cls = MODE >= 2 ? cls4 * 2 + px : 0;
    for (int t = tid; t < 2 * a.cot; t += a.threads) {
      const int q = t / a.cot, n = t % a.cot;
      if (n0 + n >= a.co) continue;
      float sum = 0.f;
      for (int rr = 0; rr < nrun; ++rr)
        sum += red[(q * nrun + rr) * a.cot + n];
      part[((long long)(cls * nbricks + brick) * 2 + q) * a.co + n0 + n] = sum;
    }
    __syncthreads();
  };

  // split chunks: this block's raw partial sums
  auto store_partial = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int gw = gw0 + lr * RW + i;
      if (!row_ok || gw >= a.Gw) continue;
      float* o = dst + out_voxel(gw) * a.co + ncol;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (ncol + 4 * q < a.co)
          *reinterpret_cast<float4*>(o + 4 * q) =
              make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                          acc[i][4 * q + 2], acc[i][4 * q + 3]);
    }
  };

  const long long m_out = (long long)a.Do * a.Ho * a.Wo * a.co;
  const int k0 = sp * a.nchunk / a.split, k1 = (sp + 1) * a.nchunk / a.split;
  contract(false, k0, k1);
  if (a.split == 1)
    epilogue(a.y, a.bias, a.part);
  else
    store_partial(a.ws + sp * m_out);
  if (a.r != nullptr) {
    contract(true, k0, k1);
    if (a.split == 1)
      epilogue(a.r, a.br, a.rpart);
    else
      store_partial(a.ws + (a.split + sp) * m_out);
  }
}

// The largest number of distinct words that one bank serves in one row
// load of a warp, over the block's warps (threads of one run share their
// words). Row loads of all taps shift every thread alike, so this is the
// conflict degree of each of them.
int conflict_degree(const Conv3Args& a, int pw, int pl) {
  const int s = a.mode == 1 ? 2 : 1;
  const int nrun = a.bd * a.bh * a.nrw;
  int worst = 1;
  for (int w0 = 0; w0 < a.threads; w0 += 32) {
    int base[32], nb = 0;
    for (int t = w0; t < w0 + 32 && t < a.threads; ++t) {
      const int run = t % nrun;
      const int lr = run % a.nrw, ly = (run / a.nrw) % a.bh,
                lz = run / (a.nrw * a.bh);
      const int b = s * lz * pl + s * ly * pw + s * lr * a.rw;
      bool seen = false;
      for (int i = 0; i < nb; ++i) seen |= base[i] == b;
      if (!seen) base[nb++] = b;
    }
    int count[32] = {0};
    for (int i = 0; i < nb; ++i) {
      const int c = ++count[base[i] % 32];
      worst = c > worst ? c : worst;
    }
  }
  return worst;
}

// The brick, grid and chunk counts the chosen fields imply; false where
// the plan cannot run.
bool shape(Conv3Args& a) {
  if ((a.rw != 8 && a.rw != 5) || a.bd < 1 || a.bh < 1 || a.nrw < 1 ||
      a.cot < 8 || a.cot % 8 || a.ck < 1 || a.split < 1)
    return false;
  a.threads = a.bd * a.bh * a.nrw * (a.cot / TN);
  if (a.threads > MAX_THREADS) return false;
  a.nbd = ceil_div(a.Gd, a.bd);
  a.nbh = ceil_div(a.Gh, a.bh);
  a.nbw = ceil_div(a.Gw, a.nrw * a.rw);
  a.ez = extent(a.mode, a.bd);
  a.ey = extent(a.mode, a.bh);
  a.ew = extent(a.mode, a.nrw * a.rw);
  a.nchunk = ceil_div(a.ci, a.ck);
  return a.split <= a.nchunk;
}

// The shared-memory layout for row pitch pw and plane pitch pl.
bool pitch(Conv3Args& a, int pw, int pl) {
  if (pw < a.ew || pl < a.ey * pw) return false;
  a.pw = pw;
  a.pl = pl;
  a.nslot = a.ez * pl;
  a.cpl = (a.nslot + 3) / 4 * 4;
  a.stage = a.ck * a.cpl + 27 * a.ck * a.cot;
  // the epilogue's (2, nrun, cot) moment scratch lives in the two stages
  const int nrun = a.bd * a.bh * a.nrw;
  if (a.stage < nrun * a.cot) a.stage = nrun * a.cot;
  return true;
}

// The pitches with the fewest bank conflicts, then the least memory.
void best_pitch(Conv3Args& a) {
  int best = 1 << 30, bpw = a.ew, bpl = a.ey * a.ew;
  for (int pw = a.ew; pw < a.ew + 16; ++pw)
    for (int pl = a.ey * pw; pl < a.ey * pw + 32; ++pl) {
      const int cost = conflict_degree(a, pw, pl) * (1 << 20) + a.ez * pl;
      if (cost < best) { best = cost; bpw = pw; bpl = pl; }
    }
  pitch(a, bpw, bpl);
}

long long smem_bytes(const Conv3Args& a) {
  return 4LL * (2LL * a.stage + a.nslot);
}

// The planner, from a search over the plans of the 29 V-Net-DS calls on an
// H100 (utils/conv3_sweep.py): a W run of 5 unless 8 wastes fewer grid
// columns (5 leaves more registers and keeps the stride-1 body free of
// spills), one run along W, the whole co up to 96 per block, the most (z,
// y) rows of runs that keep the block within 256 threads (H taking the
// larger share), a chunk of 8 channels where a block then stays within
// CHUNK8_SMEM (else 4), and a split of the chunks that fills about one wave of
// two blocks on each SM, each split keeping 4 chunks or more (a parity
// class of the dilated mode counts as a quarter of a block: it has 1-8 of
// the 27 taps).
void choose(Conv3Args& a) {
  const int w8 = ceil_div(a.Gw, 8) * 8, w5 = ceil_div(a.Gw, 5) * 5;
  a.rw = w5 <= w8 ? 5 : 8;
  a.nrw = 1;
  a.cot = a.co <= 96 ? ceil_div(a.co, TN) * TN : 96;
  if (a.co > 96 && a.co % 96 && a.co % 64 == 0) a.cot = 64;
  const int max_rows = MAX_THREADS / (a.cot / TN);
  a.bd = 1;
  a.bh = 1;
  while (2 * a.bd * a.bh <= max_rows) {
    if (a.bh <= a.bd && a.bh < a.Gh) a.bh *= 2;
    else if (a.bd < a.Gd) a.bd *= 2;
    else if (a.bh < a.Gh) a.bh *= 2;
    else break;
  }
  a.split = 1;
  const int chunks[2] = {8, 4};
  for (int ck : chunks) {
    a.ck = ck;
    if (a.ci % ck && ck > 4) continue;
    shape(a);
    best_pitch(a);
    if (smem_bytes(a) <= CHUNK8_SMEM) break;
  }
  const long long blocks = (long long)a.nbd * a.nbh * a.nbw *
                           ceil_div(a.co, a.cot) * (a.mode == 2 ? 2 : 1);
  const long long want = 2LL * NUM_SMS / blocks;
  const int most = a.nchunk / 4 > 1 ? a.nchunk / 4 : 1;
  a.split = (int)(want < 1 ? 1 : want < most ? want : most);
  shape(a);
  best_pitch(a);
}

// rows of moment partials: the reduce kernel's blocks, or the bricks of
// each parity class
int n_part(const Conv3Args& a) {
  const long long m_out = (long long)a.Do * a.Ho * a.Wo;
  return a.split > 1 ? (int)((m_out + REDUCE_ROWS - 1) / REDUCE_ROWS)
                     : a.nbd * a.nbh * a.nbw * (a.mode == 2 ? 8 : 1);
}

void fill_plan(const Conv3Args& a, int* plan) {
  plan[P_RW] = a.rw; plan[P_BD] = a.bd; plan[P_BH] = a.bh;
  plan[P_NRW] = a.nrw; plan[P_COT] = a.cot; plan[P_CK] = a.ck;
  plan[P_SPLIT] = a.split;
  const int nbricks = a.nbd * a.nbh * a.nbw;
  plan[P_NPART] = n_part(a);
  plan[P_THREADS] = a.threads;
  plan[P_SMEM] = (int)smem_bytes(a);
  plan[P_PW] = a.pw;
  plan[P_PL] = a.pl;
  plan[P_BLOCKS] = nbricks * ceil_div(a.co, a.cot) *
                   (a.mode == 2 ? 8 : 1) * a.split;
  plan[P_CONFLICT] = conflict_degree(a, a.pw, a.pl);
}

// Take the plan's chosen fields (and its pitches, where it has them), or
// choose them all where P_RW is 0.
bool planned(Conv3Args& a, const int* plan) {
  if (plan[P_RW] == 0) {
    choose(a);
  } else {
    a.rw = plan[P_RW]; a.bd = plan[P_BD]; a.bh = plan[P_BH];
    a.nrw = plan[P_NRW]; a.cot = plan[P_COT]; a.ck = plan[P_CK];
    a.split = plan[P_SPLIT];
    if (!shape(a)) return false;
    if (plan[P_PW] > 0) {
      if (!pitch(a, plan[P_PW], plan[P_PL])) return false;
    } else {
      best_pitch(a);
    }
  }
  return smem_bytes(a) <= MAX_SMEM;
}

template <int RW, int MODE>
cudaError_t launch_brick(const Conv3Args& a, cudaStream_t stream) {
  static bool attr = false;  // raise the dynamic shared memory cap once
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3_brick<RW, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((unsigned)(a.nbd * a.nbh * a.nbw),
                  (unsigned)ceil_div(a.co, a.cot),
                  (unsigned)((a.mode == 2 ? 4 : 1) * a.split));
  conv3_brick<RW, MODE><<<grid, a.threads, smem_bytes(a), stream>>>(a);
  return cudaGetLastError();
}

template <int RW>
cudaError_t launch_mode(const Conv3Args& a, cudaStream_t stream) {
  if (a.mode == 0) return launch_brick<RW, 0>(a, stream);
  if (a.mode == 1) return launch_brick<RW, 1>(a, stream);
  const cudaError_t e = launch_brick<RW, 2>(a, stream);  // W parity 0
  if (e != cudaSuccess) return e;
  return launch_brick<RW, 3>(a, stream);                 // W parity 1
}

}  // namespace

// The launch plan of a (D, H, W) input with ci channels, co outputs and a
// mode: plan is an int array of P_COUNT entries. With plan[0] == 0 the
// planner chooses; otherwise the first seven entries (W run 8 or 5,
// brick depth and height, runs along W, channel tile, chunk, split) are
// taken as given. The call fills the rest: rows of moment partials,
// threads, shared memory bytes, pitches, blocks and the bank-conflict
// degree. A split above 1 needs a workspace of split (twice that with a
// residual) x Do*Ho*Wo x co floats.
M3SEG_API int m3seg_conv3_plan(int D, int H, int W, int ci, int co,
                               int mode, int* plan) {
  if (D <= 0 || H <= 0 || W <= 0 || ci <= 0 || co <= 0 || mode < 0 ||
      mode > 2 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  Conv3Args a = geometry<Conv3Args>(D, H, W, ci, co, mode);
  if (!planned(a, plan)) return (int)cudaErrorInvalidValue;
  fill_plan(a, plan);
  return 0;
}

// x1: (D, H, W, c1), x2: (D, H, W, c2) or null (c2 = 0); w: (27*ci, co)
// with ci = c1 + c2; scale, shift: (ci,) each, or both null; wr: (co, ci)
// or null (mode 0 without prologue only); part/rpart: (n_part, 2, co) or
// null, each with its (2, co) sums mom, rmom; ws: the
// plan's workspace (null when its split is 1); plan: m3seg_conv3_plan's
// filled array. All fp32, contiguous, 16-byte aligned; c1, c2 and co
// multiples of 4. Output (Do, Ho, Wo, co): mode 0 (D, H, W), mode 1
// ((D-1)/2+1, ...), mode 2 (2D, 2H, 2W). halo_keep -1: no halo; 0-3: halo
// mode, x1 and x2 hold D + 2 planes, bit 0 keeps the first halo plane and
// bit 1 the last (a plane not kept reads as zero padding). dsrc > 0:
// dilated depth (mode 0, no residual, no halo), x1 and x2 hold at least
// dsrc planes and D is 2 * dsrc. The plan is the one of (D, H, W).
M3SEG_API int m3seg_conv3(const float* x1, const float* x2, const float* w,
                          const float* bias, const float* scale,
                          const float* shift, int pro_act,
                          const float* wr, const float* br, float* y,
                          float* r, float* part, float* rpart, float* mom,
                          float* rmom, float* ws, int D, int H, int W, int c1,
                          int c2, int co, int mode, const int* plan,
                          int halo_keep, int dsrc, void* stream) {
  if (!args_ok(x2, scale, shift, wr, r, part, rpart, D, H, W, c1, c2, co,
               mode, pro_act, plan, halo_keep, dsrc) ||
      (part != nullptr) != (mom != nullptr) ||
      (rpart != nullptr) != (rmom != nullptr))
    return (int)cudaErrorInvalidValue;
  Conv3Args a = geometry<Conv3Args>(D, H, W, c1 + c2, co, mode);
  if (!planned(a, plan)) return (int)cudaErrorInvalidValue;
  a.halo = halo_keep >= 0;
  a.keep_lo = halo_keep >= 0 && (halo_keep & 1);
  a.keep_hi = halo_keep >= 0 && (halo_keep & 2);
  a.dsrc = dsrc;
  a.x1 = x1; a.x2 = x2; a.w = w; a.bias = bias; a.scale = scale;
  a.shift = shift; a.wr = wr;
  a.br = br; a.y = y; a.r = r; a.part = part; a.rpart = rpart; a.ws = ws;
  a.c1 = c1; a.c2 = c2; a.pro_act = pro_act;
  if (a.split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = a.rw == 8 ? launch_mode<8>(a, s) : launch_mode<5>(a, s);
  if (err == cudaSuccess && a.split > 1)
    err = launch_split_sum<float>(
        a.ws, a.split, (long long)a.Do * a.Ho * a.Wo, a.co, REDUCE_ROWS,
        a.bias, a.y, a.part, a.br, a.r, a.rpart, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_moment_sum(part, rpart, n_part(a), co, mom, rmom, s);
}
