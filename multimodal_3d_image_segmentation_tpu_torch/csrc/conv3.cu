// k=3 convolution + bias with V-Net-DS's fused options, on channels-last
// fp32 volumes.
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
//   volume with the flipped kernel).
//
// What bounds it on an H100: operations. V-Net-DS at base width 24 runs
// 0.305 TFLOP of k=3 convs per 240x240x155 volume (29 launches) and moves
// 1.64 GB; at 67 TFLOP/s fp32 (CUDA cores) and 3.35 TB/s that is 4.6 ms
// of arithmetic against 0.5 ms of memory. The products stay
// in exact fp32 FMAs on the CUDA cores (TF32 and wgmma wait for the Dice
// gate of the precision policy).
//
// Design: an implicit GEMM. Each block computes a BM-voxel x BN-channel
// output tile; the contraction runs over the 27 taps x ci input channels in
// chunks of BK channels, each staged in shared memory (the input tile
// gathered with bounds checks, the prologue applied inside the volume
// only, so the padding stays zero; the weight tile from (27, ci, co) packed weights, so no
// weight set has to fit shared memory). Each thread holds a TM x TN
// register tile. (Issuing the next chunk's loads before the FMAs raised the
// registers and cut occupancy, and decoding the tap of every chunk with
// integer divisions cost as much as its FMAs: both were slower at the
// large levels, measured on the card.) Tile shapes are instantiated for co multiples of 64, 48 and 24 so the widths
// of the path (24 to 384) waste no columns. The grid spans output channels
// as well as voxels; where that still gives too few blocks for the 132 SMs
// (the 31x31x20 level and below), the taps are split over blocks too,
// each block writes its partial sums to a workspace, and a second kernel
// adds them in a fixed order with the bias and the moment sums. The
// dilated mode splits the output into its 8
// parity classes (grid z), each a stride-1 conv over the source grid with
// only the taps that meet a source voxel: 27 tap-volumes over 8 classes
// instead of 216, the MACs of the transposed conv itself. The residual tap
// is a second, centre-tap-only contraction into the same registers after
// the main output is written. Moment sums are reduced in a fixed order
// within a block and written as per-block partials; the wrapper sums them
// in float64, so the result does not change from run to run.
#include "common.cuh"

namespace {

constexpr int BK = 8;
constexpr int REDUCE_ROWS = 16;    // voxels per block of the split-sum pass
// split the taps of a grid with fewer blocks than 4 waves of 4 blocks on
// each of the 132 SMs, up to that count: the last, partly filled wave then
// costs at most a fifth of the time
constexpr int TARGET_BLOCKS = 4 * 4 * 132;

struct Conv3Args {
  const float* x1;    // (D, H, W, c1)
  const float* x2;    // (D, H, W, c2) or null
  const float* w;     // (27, ci, co), row ((kz*3+ky)*3+kx)*ci + c
  const float* bias;  // (co,)
  const float* pro;   // (2, ci): scale, shift; or null
  const float* wr;    // (ci, co) residual tap or null
  const float* br;    // (co,)
  float* y;           // (Do, Ho, Wo, co)
  float* r;           // (Do, Ho, Wo, co) or null
  float* part;        // (blocks, 2, co) moment partials or null
  float* rpart;       // the same for r, or null
  float* ws;          // split > 1: (split [+ 1 with r], M, co) partial sums
  int D, H, W, c1, c2, ci, co;
  int Do, Ho, Wo;     // output volume
  int Gd, Gh, Gw;     // iteration grid (one parity class in mode 2)
  int mode;           // 0: stride 1; 1: stride 2; 2: input dilation 2
  int pro_act;        // 0 none, 1 elu, 2 selu, 3 relu
  int split;          // blocks along the taps
  int nmb;            // blocks along the voxels
};

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v > 0.f ? v : expm1f(v);
    case 2: return m3seg::selu(v);
    case 3: return fmaxf(v, 0.f);
    default: return v;
  }
}

__device__ __forceinline__ float prologue(float v, float s, float t,
                                          int act) {
  return activate(__fadd_rn(__fmul_rn(v, s), t), act);
}

// taps along one axis: all three, or in mode 2 those that meet a source
// voxel for output parity p (p = 0: the centre; p = 1: the two outer taps)
__device__ __forceinline__ int axis_count(int mode, int p) {
  return mode != 2 ? 3 : (p ? 2 : 1);
}
__device__ __forceinline__ int axis_tap(int mode, int p, int i) {
  return mode != 2 ? i : (p ? 2 * i : 1);
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv3_kernel(const Conv3Args a) {
  constexpr int COLS = BN / TN;
  constexpr int ROWS = BM / TM;
  constexpr int NT = ROWS * COLS;
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int vz[BM], vy[BM], vx[BM];
  __shared__ float red[2][ROWS][BN];

  const int tid = threadIdx.x;
  const int tx = tid % COLS, ty = tid / COLS;
  const int mb = blockIdx.x, n0 = blockIdx.y * BN;
  const int cls = blockIdx.z / a.split, sp = blockIdx.z % a.split;
  const int pz = cls >> 2, py = (cls >> 1) & 1, px = cls & 1;
  const long long M = (long long)a.Gd * a.Gh * a.Gw;
  const long long m0 = (long long)mb * BM;
  const int nz = axis_count(a.mode, pz), ny = axis_count(a.mode, py),
            nx = axis_count(a.mode, px);

  for (int m = tid; m < BM; m += NT) {
    const long long g = m0 + m;
    if (g < M) {
      vx[m] = (int)(g % a.Gw);
      const long long t = g / a.Gw;
      vy[m] = (int)(t % a.Gh);
      vz[m] = (int)(t / a.Gh);
    } else {  // past the end: every tap reads padding
      vz[m] = -(1 << 24); vy[m] = 0; vx[m] = 0;
    }
  }
  __syncthreads();

  float acc[TM][TN];

  // stage input channels [c0, c0+BK) of tap (kz, ky, kx) in shared memory
  // (the prologue applied inside the volume only, so the padding stays
  // zero) with the matching rows of that tap's (ci, co) weight slice wtap
  auto stage = [&](int kz, int ky, int kx, int c0, const float* wtap,
                   bool pro_on) {
    for (int idx = tid; idx < BM * (BK / 4); idx += NT) {
      const int m = idx % BM, kq = idx / BM;
      const int c = c0 + 4 * kq;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < a.ci) {
        int iz, iy, ix;
        if (a.mode == 2) {
          iz = vz[m] + (kz >> 1); iy = vy[m] + (ky >> 1);
          ix = vx[m] + (kx >> 1);
        } else {
          const int s = a.mode == 1 ? 2 : 1;
          iz = s * vz[m] + kz - 1; iy = s * vy[m] + ky - 1;
          ix = s * vx[m] + kx - 1;
        }
        if (iz >= 0 && iz < a.D && iy >= 0 && iy < a.H && ix >= 0 &&
            ix < a.W) {
          const long long vox = ((long long)iz * a.H + iy) * a.W + ix;
          const float* src = c < a.c1 ? a.x1 + vox * a.c1 + c
                                      : a.x2 + vox * a.c2 + (c - a.c1);
          v = __ldg(reinterpret_cast<const float4*>(src));
          if (pro_on) {
            const float4 s = __ldg(reinterpret_cast<const float4*>(a.pro + c));
            const float4 t =
                __ldg(reinterpret_cast<const float4*>(a.pro + a.ci + c));
            v.x = prologue(v.x, s.x, t.x, a.pro_act);
            v.y = prologue(v.y, s.y, t.y, a.pro_act);
            v.z = prologue(v.z, s.z, t.z, a.pro_act);
            v.w = prologue(v.w, s.w, t.w, a.pro_act);
          }
        }
      }
      As[4 * kq + 0][m] = v.x;
      As[4 * kq + 1][m] = v.y;
      As[4 * kq + 2][m] = v.z;
      As[4 * kq + 3][m] = v.w;
    }
    for (int idx = tid; idx < BK * (BN / 4); idx += NT) {
      const int kk = idx / (BN / 4), nq = idx % (BN / 4);
      const int n = n0 + 4 * nq;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + kk < a.ci && n < a.co)
        v = __ldg(reinterpret_cast<const float4*>(
            wtap + (long long)(c0 + kk) * a.co + n));
      *reinterpret_cast<float4*>(&Bs[kk][4 * nq]) = v;
    }
  };

  // acc = the contraction over taps [t0, t1) of this block's class (or
  // over the residual's centre tap), in chunks of BK channels
  auto contract = [&](int t0, int t1, bool residual) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int t = t0; t < t1; ++t) {
      int kz = 1, ky = 1, kx = 1;
      const float* wtap = a.wr;
      if (!residual) {
        kz = axis_tap(a.mode, pz, t / (ny * nx));
        ky = axis_tap(a.mode, py, (t / nx) % ny);
        kx = axis_tap(a.mode, px, t % nx);
        wtap = a.w + (long long)((kz * 3 + ky) * 3 + kx) * a.ci * a.co;
      }
      for (int c0 = 0; c0 < a.ci; c0 += BK) {
        stage(kz, ky, kx, c0, wtap, !residual && a.pro != nullptr);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          float av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = As[k][ty * TM + i];
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx * TN + j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  };

  // bias, store, and the block's moment partials in a fixed order
  auto epilogue = [&](float* out, const float* b, float* part) {
    float s[TN], s2[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) { s[j] = 0.f; s2[j] = 0.f; }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty * TM + i;
      if (m0 + m >= M) continue;
      long long ov;
      if (a.mode == 2)
        ov = ((long long)(2 * vz[m] + pz) * a.Ho + 2 * vy[m] + py) * a.Wo +
             2 * vx[m] + px;
      else
        ov = m0 + m;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        if (n < a.co) {
          const float v = acc[i][j] + b[n];
          out[ov * a.co + n] = v;
          s[j] += v;
          s2[j] += v * v;
        }
      }
    }
    if (part == nullptr) return;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      red[0][ty][tx * TN + j] = s[j];
      red[1][ty][tx * TN + j] = s2[j];
    }
    __syncthreads();
    for (int t = tid; t < 2 * BN; t += NT) {
      const int q = t / BN, n = t % BN;
      if (n0 + n < a.co) {
        float sum = 0.f;
        for (int rr = 0; rr < ROWS; ++rr) sum += red[q][rr][n];
        part[((long long)(cls * a.nmb + mb) * 2 + q) * a.co + n0 + n] = sum;
      }
    }
    __syncthreads();
  };

  // split taps: the raw partial sums of this block's taps (modes 0 and 1,
  // where the voxel index is the output index)
  auto store_partial = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + ty * TM + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        if (n < a.co) dst[m * a.co + n] = acc[i][j];
      }
    }
  };

  const int nt = nz * ny * nx;
  contract(sp * nt / a.split, (sp + 1) * nt / a.split, false);
  if (a.split == 1)
    epilogue(a.y, a.bias, a.part);
  else
    store_partial(a.ws + (long long)sp * M * a.co);
  if (a.r != nullptr && sp == 0) {  // the residual rides the first split
    contract(0, 1, true);
    if (a.split == 1)
      epilogue(a.r, a.br, a.rpart);
    else
      store_partial(a.ws + (long long)a.split * M * a.co);
  }
}

// out[m, n] = sum over k of ws[k, m, n] (in order) + bias[n], with each
// block's moment partials over its REDUCE_ROWS voxels. A block is 32
// columns x 8 row lanes; the lanes' sums are added in a fixed order.
__global__ void __launch_bounds__(256)
conv3_split_sum(const float* __restrict__ ws, int split, long long M,
                int co, const float* __restrict__ bias,
                float* __restrict__ out, float* __restrict__ part) {
  __shared__ float red[2][8][32];
  const int ln = threadIdx.x % 32, lr = threadIdx.x / 32;
  const long long m0 = (long long)blockIdx.x * REDUCE_ROWS;
  const long long m1 = m0 + REDUCE_ROWS < M ? m0 + REDUCE_ROWS : M;
  for (int nb = 0; nb < co; nb += 32) {
    const int n = nb + ln;
    float s = 0.f, s2 = 0.f;
    if (n < co) {
      for (long long m = m0 + lr; m < m1; m += 8) {
        float v = 0.f;
#pragma unroll 4
        for (int k = 0; k < split; ++k)
          v += ws[((long long)k * M + m) * co + n];
        v += bias[n];
        out[m * co + n] = v;
        s += v;
        s2 += v * v;
      }
    }
    red[0][lr][ln] = s;
    red[1][lr][ln] = s2;
    __syncthreads();
    if (part != nullptr && threadIdx.x < 64 && nb + threadIdx.x % 32 < co) {
      const int q = threadIdx.x / 32, nn = threadIdx.x % 32;
      float sum = 0.f;
      for (int r = 0; r < 8; ++r) sum += red[q][r][nn];
      part[((long long)blockIdx.x * 2 + q) * co + nb + nn] = sum;
    }
    __syncthreads();
  }
}

// the output tile for co channels: no wasted column at the path's widths
// (24 to 384); other multiples of 4 take the 64 x 64 tile, masked
struct Tile { int bm, bn; };

Tile tile_for(int co) {
  if (co % 64 == 0) return {64, 64};
  if (co % 48 == 0) return {64, 48};
  if (co % 24 == 0) return {128, 24};
  return {64, 64};
}

// blocks along the taps, and the rows of moment partials per output
void plan(const Conv3Args& a, int* split, int* n_part) {
  const Tile t = tile_for(a.co);
  const long long M = (long long)a.Gd * a.Gh * a.Gw;
  const long long nmb = (M + t.bm - 1) / t.bm;
  const long long blocks = nmb * ((a.co + t.bn - 1) / t.bn);
  if (a.mode == 2 || blocks >= TARGET_BLOCKS) {
    *split = 1;
    *n_part = (int)(nmb * (a.mode == 2 ? 8 : 1));
  } else {
    const long long want = (TARGET_BLOCKS + blocks - 1) / blocks;
    *split = (int)(want < 27 ? want : 27);
    *n_part = (int)((M + REDUCE_ROWS - 1) / REDUCE_ROWS);
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(Conv3Args a, cudaStream_t stream) {
  const long long M = (long long)a.Gd * a.Gh * a.Gw;
  a.nmb = (int)((M + BM - 1) / BM);
  const dim3 grid((unsigned)a.nmb, (unsigned)((a.co + BN - 1) / BN),
                  (a.mode == 2 ? 8u : 1u) * (unsigned)a.split);
  conv3_kernel<BM, BN, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return err;
  const unsigned nb = (unsigned)((M + REDUCE_ROWS - 1) / REDUCE_ROWS);
  conv3_split_sum<<<nb, 256, 0, stream>>>(a.ws, a.split, M, a.co, a.bias,
                                          a.y, a.part);
  if (a.r != nullptr)
    conv3_split_sum<<<nb, 256, 0, stream>>>(
        a.ws + (long long)a.split * M * a.co, 1, M, a.co, a.br, a.r,
        a.rpart);
  return cudaGetLastError();
}

// the output volume and the iteration grid of a (D, H, W) input
Conv3Args geometry(int D, int H, int W, int co, int mode) {
  Conv3Args a{};
  a.D = D; a.H = H; a.W = W; a.co = co; a.mode = mode;
  if (mode == 1) {
    a.Do = (D - 1) / 2 + 1; a.Ho = (H - 1) / 2 + 1; a.Wo = (W - 1) / 2 + 1;
  } else if (mode == 2) {
    a.Do = 2 * D; a.Ho = 2 * H; a.Wo = 2 * W;
  } else {
    a.Do = D; a.Ho = H; a.Wo = W;
  }
  if (mode == 2) { a.Gd = D; a.Gh = H; a.Gw = W; }
  else { a.Gd = a.Do; a.Gh = a.Ho; a.Gw = a.Wo; }
  return a;
}

}  // namespace

// The launch plan for a (D, H, W) input, co outputs and a mode: blocks
// along the taps (``split``; > 1 needs a workspace of (split + 1 with a
// residual) x voxels x co floats) and the rows of moment partials.
M3SEG_API int m3seg_conv3_plan(int D, int H, int W, int co, int mode,
                               int* split, int* n_part) {
  if (D <= 0 || H <= 0 || W <= 0 || co <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  plan(geometry(D, H, W, co, mode), split, n_part);
  return 0;
}

// x1: (D, H, W, c1), x2: (D, H, W, c2) or null (c2 = 0); w: (27*ci, co)
// with ci = c1 + c2; pro: (2, ci) or null; wr: (ci, co) or null (mode 0
// without prologue only); part/rpart: (n_part, 2, co) or null; ws: the
// plan's workspace (null when its split is 1). All fp32, contiguous,
// 16-byte aligned; c1, c2 and co multiples of 4. Output (Do, Ho, Wo, co):
// mode 0 (D, H, W), mode 1 ((D-1)/2+1, ...), mode 2 (2D, 2H, 2W).
M3SEG_API int m3seg_conv3(const float* x1, const float* x2, const float* w,
                          const float* bias, const float* pro, int pro_act,
                          const float* wr, const float* br, float* y,
                          float* r, float* part, float* rpart, float* ws,
                          int D, int H, int W, int c1, int c2, int co,
                          int mode, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || c1 <= 0 || c2 < 0 || co <= 0 ||
      c1 % 4 || c2 % 4 || co % 4 || mode < 0 || mode > 2 || pro_act < 0 ||
      pro_act > 3 || (c2 > 0) != (x2 != nullptr) ||
      (r != nullptr && (mode != 0 || pro != nullptr || wr == nullptr)) ||
      (rpart != nullptr && (r == nullptr || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  Conv3Args a = geometry(D, H, W, co, mode);
  a.x1 = x1; a.x2 = x2; a.w = w; a.bias = bias; a.pro = pro; a.wr = wr;
  a.br = br; a.y = y; a.r = r; a.part = part; a.rpart = rpart; a.ws = ws;
  a.c1 = c1; a.c2 = c2; a.ci = c1 + c2; a.pro_act = pro_act;
  int n_part;
  plan(a, &a.split, &n_part);
  if (a.split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tile t = tile_for(co);
  if (t.bn == 48) return (int)launch<64, 48, 4, 3>(a, s);
  if (t.bn == 24) return (int)launch<128, 24, 8, 3>(a, s);
  return (int)launch<64, 64, 4, 4>(a, s);
}
