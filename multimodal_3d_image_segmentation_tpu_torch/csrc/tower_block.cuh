// The body of one fused tower block, shared by csrc/tower_block.cu (z read
// from a tensor), csrc/tower_block_s.cu (z formed from the resident
// spectrum once per plane by a pass of its own, then read like a tensor)
// and csrc/tower_resident.cu (the same, in a phase of its own per tower
// block).
//
// Computes, for one depth plane d of the tower grid (D, H, W), C channels,
// and one tile of kTW columns of W, x and out channels-last (D, H, W, C):
//   y    = [zre Cwi - zim Swi, zre Swi + zim Cwi]        inverse W stage
//   y1   = yre A + yim B                inverse H stage, (H, W, C)
//   p, q = [W_conv ; W_cc_x] x + [b_conv ; b_cc];  ds = ds_prev + W_ds x
//   t    = selu(y1 + p);  out = selu(W_cc_t t + q)
//   F    = out Mh   (H -> [cos | sin] x KH, 1/H)          forward H stage
//   f    = [Fre Cw - Fim Sw, Fre Sw + Fim Cw]  (W -> KW)  forward W stage
// and writes the tile's partial f; the kernels' second passes reduce the
// partials over the tiles in a fixed order. Exact fp32 FMAs on the CUDA
// cores (no TF32): the TPU kernel's packed bf16x3 products are its way to
// fp32-class accuracy; here fp32 is native. Hartley and Fourier differ only
// in the stage matrices (A, B: Hartley's fold C - S, -(C + S), Fourier's
// real part C, -S; Cwi, Swi carry Fourier's Hermitian weights).
//
// What bounds it on an H100: the fp32 operations (about 5,600 FMAs and 48
// SELUs a voxel at the serving shapes, against 200 bytes of volume
// traffic). One plane is 906 KB at the serving sizes and does not fit a
// block's shared memory, and the forward stage is a reduction over the
// whole plane, so each block takes one plane and one tile of kTW columns
// of W. What the design does so that two blocks of 256 threads (16 warps)
// stay resident on an SM at every serving shape, with fewer shared-memory
// loads per FMA than one voxel per thread gives:
//   - first pass, over the rows of H in chunks of kTH: the inverse H stage
//     of a chunk as a register-tiled product (4 rows x 4 channels of one
//     column per thread: each 16-byte load of y or of the (A, B) rows feeds
//     8 FMAs, one value per voxel fed 4), then the block tail at one voxel
//     per thread (x and t in registers, weights as 16-byte broadcasts),
//     writing out. The chunk's (A, B) rows are staged in shared memory with
//     cp.async while the previous chunk computes;
//   - second pass: the tile's out read back through L2 chunk by chunk (it
//     was just written) into the forward H accumulators F, kept in
//     registers: each thread owns a fixed, even share of (4 of 2KH, 4 of C)
//     tiles of its column, so F needs no read-modify-write in shared
//     memory and its 43 KB there (at C 24, KH 28) are free. F lives only in
//     the second pass, so the tail's 48 values a voxel have the registers
//     to themselves.
// At the end F is written over the y tile (dead by then) and the block
// applies the forward W stage over its columns. Each value keeps the
// summation order of the one-voxel-per-thread design before it (y1 over k,
// the mixes over input channels, F over h, the W stages over j and w, all
// ascending), so the bits are the same. No atomics: the result is the same
// from run to run. SELU keeps expm1f, as torch.selu does.
//
// Registers: two blocks an SM cap a thread at 128. At C 24 ptxas then
// spills a dozen long-lived scalars (shared-memory offsets, loop bounds):
// stored once at the start and reloaded mostly at the heads of the chunk
// loops and stages, not in the FMA loops. A build capped at 255 registers
// spills nothing at C 24 but holds one block an SM, and is slower on an
// H100 (PERF.md, section 6), so the cap and its spills are kept.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTW = 8;               // columns of W per block
constexpr int kTH = 32;              // rows of H per chunk
constexpr int kThreads = kTW * kTH;  // one thread per voxel of a chunk
constexpr int kMaxDs = 8;
constexpr int kMaxKH = 32;           // F's registers: KH / 2 x C / 4 tiles

struct Mats {  // fp32 stage matrices, row-major
  const float* cwi;  // (KW, W)
  const float* swi;  // (KW, W)
  const float* ha;   // (KH, H)  inverse H, real part
  const float* hb;   // (KH, H)  inverse H, imaginary part
  const float* mhf;  // (H, 2KH) [cos | sin] / H
  const float* cw;   // (W, KW)  / W
  const float* sw;   // (W, KW)
};

// The stage matrices in the order the wrappers pack them into one buffer:
// mhf first, so that its rows (read as float4) stay 16-byte aligned for any
// KW and W.
__host__ inline Mats unpack_mats(const float* mats, int H, int W, int KH,
                                 int KW) {
  Mats m;
  m.mhf = mats;
  m.cwi = m.mhf + (size_t)H * 2 * KH;
  m.swi = m.cwi + (size_t)KW * W;
  m.ha = m.swi + (size_t)KW * W;
  m.hb = m.ha + (size_t)KH * H;
  m.cw = m.hb + (size_t)KH * H;
  m.sw = m.cw + (size_t)W * KW;
  return m;
}

__host__ inline size_t mats_floats(int H, int W, int KH, int KW) {
  return 4 * (size_t)KW * W + 4 * (size_t)KH * H;
}

// Shared memory of a block, in floats (each part a multiple of 4, so every
// part is 16-byte aligned for float4 access).
__host__ __device__ inline int smem_floats(int C, int KH, int KW) {
  return 2 * KH * kTW * C            // y tile, then the F tile
         + kTH * kTW * C             // one chunk: y1, then out
         + 2 * KH * kTH              // (A, B) rows of the chunk
         + kTH * 2 * KH              // Mh rows of the chunk
         + (2 * C + kMaxDs) * C + C * C + 2 * C  // weights, bias
         + 4 * KW * kTW;             // the tile's columns of Cwi, Swi, Cw, Sw
}

// 4- and 16-byte asynchronous copies to shared memory; with `valid` false
// the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stages the rows h0 .. h0 + kTH - 1 of the inverse H matrices as (A, B)
// pairs [KH][kTH][2]; rows past H are zero.
__device__ __forceinline__ void stage_ab(const Mats& m, int h0, int H, int KH,
                                         float* ab_s) {
  for (int i = threadIdx.x; i < KH * kTH; i += kThreads) {
    const int k = i / kTH, hl = i % kTH;
    const bool ok = h0 + hl < H;
    const size_t g = ok ? (size_t)k * H + h0 + hl : 0;
    cp_async4(ab_s + 2 * i, m.ha + g, ok);
    cp_async4(ab_s + 2 * i + 1, m.hb + g, ok);
  }
}

// Stages the rows h0 .. h0 + kTH - 1 of Mh, [kTH][2KH]; rows past H are
// zero (2KH is a multiple of 4).
__device__ __forceinline__ void stage_mh(const Mats& m, int h0, int H, int KH,
                                         float* mh_s) {
  const int n4 = kTH * 2 * KH / 4;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const bool ok = h0 + (4 * i) / (2 * KH) < H;
    cp_async16(mh_s + 4 * i, m.mhf + (ok ? (size_t)h0 * 2 * KH + 4 * i : 0),
               ok);
  }
}

// Stages rows h0 .. h0 + kTH - 1 of the tile's columns of out (plane d),
// [kTW][kTH][C], through L2 (cp.async.cg: the same block wrote them);
// voxels outside the volume are zero.
template <int C>
__device__ __forceinline__ void stage_out(const float* out, int d, int h0,
                                          int H, int W, int w0, int nw,
                                          float* o_s) {
  constexpr int C4 = C / 4;
  for (int i = threadIdx.x; i < kTH * kTW * C4; i += kThreads) {
    const int q = i % C4, v = i / C4;
    const int wl = v % kTW, hl = v / kTW;  // W fastest: coalesced reads
    const bool ok = h0 + hl < H && wl < nw;
    const size_t g =
        ok ? (((size_t)d * H + h0 + hl) * W + w0 + wl) * C + 4 * q : 0;
    cp_async16(o_s + (wl * kTH + hl) * C + 4 * q, out + g, ok);
  }
}

// One block of the kernel on plane d, W tile `tile` of n_tiles. zsrc
// supplies the plane's z: zsrc.fill_y(y_s, ny, cwi_s, swi_s) writes the
// inverse W stage of z over the tile's columns into the y tile,
// [2][KH][kTW][C]; every thread of the block calls it. Without `forward` the block writes out (and ds) only,
// no partial spectrum. x is read through L2 (ld.global.cg), so it may be
// written by the same launch; x and out never alias. wcat (2C + nds, C),
// wcc (C, C), bias (2C): the weights, rows = outputs. KH <= kMaxKH (the
// wrappers check).
template <int C, class ZSrc>
__device__ __forceinline__ void tower_block_body(
    const ZSrc& zsrc, int d, int tile, int n_tiles, bool forward,
    const float* __restrict__ x, const float* __restrict__ wcat,
    const float* __restrict__ wcc, const float* __restrict__ bias,
    const Mats& m, const float* __restrict__ ds_prev, float* __restrict__ out,
    float* __restrict__ partial, float* __restrict__ ds_out, int H, int W,
    int KH, int KW, int nds) {
  constexpr int C4 = C / 4;
  // F tiles of 4 (of 2KH) x 4 (of C) per thread: a column has KH / 2 x
  // C4, over its kTH threads
  constexpr int kFJ = (kMaxKH / 2 * C4 + kTH - 1) / kTH;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int w0 = tile * kTW;
  const int nw = min(kTW, W - w0);
  const int tid = threadIdx.x;
  const int ny = KH * kTW * C;       // one component of the y tile
  const int k2n = 2 * KH;
  float* y_s = smem;                 // [2][KH][kTW][C]; F [kTW][2KH][C]
  float* o_s = y_s + 2 * ny;         // [kTW][kTH][C]: y1, then out
  float* ab_s = o_s + kTH * kTW * C;           // [KH][kTH][2]
  float* mh_s = ab_s + 2 * KH * kTH;           // [kTH][2KH]
  float* wcat_s = mh_s + kTH * k2n;            // [2C + nds][C] (out, in)
  float* wcc_s = wcat_s + (2 * C + kMaxDs) * C;  // [C][C]     (out, in)
  float* b_s = wcc_s + C * C;                  // [2C]
  float* cwi_s = b_s + 2 * C;                  // [KW][kTW]
  float* swi_s = cwi_s + KW * kTW;             // [KW][kTW]
  float* cw_s = swi_s + KW * kTW;              // [kTW][KW]
  float* sw_s = cw_s + kTW * KW;               // [kTW][KW]

  // the first chunk's (A, B) rows load while z is formed
  stage_ab(m, 0, H, KH, ab_s);
  cp_async_commit();
  for (int i = tid; i < (2 * C + nds) * C; i += kThreads) wcat_s[i] = wcat[i];
  for (int i = tid; i < C * C; i += kThreads) wcc_s[i] = wcc[i];
  for (int i = tid; i < 2 * C; i += kThreads) b_s[i] = bias[i];
  for (int i = tid; i < KW * kTW; i += kThreads) {
    const int j = i / kTW, wl = i % kTW;  // columns past W are zero
    cwi_s[i] = wl < nw ? m.cwi[j * W + w0 + wl] : 0.f;
    swi_s[i] = wl < nw ? m.swi[j * W + w0 + wl] : 0.f;
    const int wl2 = i / KW, j2 = i % KW;
    cw_s[i] = wl2 < nw ? m.cw[(w0 + wl2) * KW + j2] : 0.f;
    sw_s[i] = wl2 < nw ? m.sw[(w0 + wl2) * KW + j2] : 0.f;
  }
  __syncthreads();

  // ---- inverse W stage of z[d] for this tile's columns
  zsrc.fill_y(y_s, ny, cwi_s, swi_s);

  const float4* y4 = reinterpret_cast<const float4*>(y_s);
  float4* o4 = reinterpret_cast<float4*>(o_s);
  const float4* wcat4 = reinterpret_cast<const float4*>(wcat_s);
  const float4* wcc4 = reinterpret_cast<const float4*>(wcc_s);
  // the block tail: voxel (hl, wl) of the chunk; forward H: column wl
  const int hl = tid % kTH, wl = tid / kTH;

  for (int h0 = 0; h0 < H; h0 += kTH) {
    const bool more = h0 + kTH < H;
    cp_async_wait_all();
    __syncthreads();  // the chunk's (A, B) rows have landed

    // ---- y1, the inverse H stage of the chunk: 4 rows x 4 channels of one
    // column per task, t = fmaf(r, a, fmaf(i, b, t)) over k ascending
    const float4* ab4 = reinterpret_cast<const float4*>(ab_s);
    for (int e = tid; e < kTW * (kTH / 4) * C4; e += kThreads) {
      const int q = e % C4, r = e / C4;
      const int h4 = r % (kTH / 4), wa = r / (kTH / 4);
      float4 t4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) t4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
      for (int k = 0; k < KH; ++k) {
        const float4 yr = y4[(k * kTW + wa) * C4 + q];
        const float4 yi = y4[ny / 4 + (k * kTW + wa) * C4 + q];
        // (a, b) of rows 4 h4 .. 4 h4 + 3
        const float4 p01 = ab4[(k * kTH + 4 * h4) / 2];
        const float4 p23 = ab4[(k * kTH + 4 * h4) / 2 + 1];
        const float av[4] = {p01.x, p01.z, p23.x, p23.z};
        const float bv[4] = {p01.y, p01.w, p23.y, p23.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          t4[u].x = fmaf(yr.x, av[u], fmaf(yi.x, bv[u], t4[u].x));
          t4[u].y = fmaf(yr.y, av[u], fmaf(yi.y, bv[u], t4[u].y));
          t4[u].z = fmaf(yr.z, av[u], fmaf(yi.z, bv[u], t4[u].z));
          t4[u].w = fmaf(yr.w, av[u], fmaf(yi.w, bv[u], t4[u].w));
        }
      }
      float4* dst = o4 + (wa * kTH + 4 * h4) * C4 + q;
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[u * C4] = t4[u];
    }
    __syncthreads();
    if (more) {  // the next chunk's (A, B) rows
      stage_ab(m, h0 + kTH, H, KH, ab_s);
      cp_async_commit();
    }

    // ---- the block tail at one voxel per thread, all channels in
    // registers, the weights the same for every thread
    {
      const int h = h0 + hl;
      const float4* vs4 = o4 + (wl * kTH + hl) * C4;  // y1
      if (h < H && wl < nw) {
        const size_t vox = ((size_t)d * H + h) * W + (w0 + wl);
        const float4* src = reinterpret_cast<const float4*>(x + vox * C);
        float xv[C], t[C];
#pragma unroll
        for (int q = 0; q < C4; ++q) {
          const float4 v = __ldcg(src + q), u = vs4[q];
          xv[4 * q] = v.x;
          xv[4 * q + 1] = v.y;
          xv[4 * q + 2] = v.z;
          xv[4 * q + 3] = v.w;
          t[4 * q] = u.x;
          t[4 * q + 1] = u.y;
          t[4 * q + 2] = u.z;
          t[4 * q + 3] = u.w;
        }
        // t = selu(y1 + W_conv x + b_conv)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float p = 0.f;
#pragma unroll
          for (int q = 0; q < C4; ++q) {
            const float4 wv = wcat4[c * C4 + q];
            p = fmaf(xv[4 * q], wv.x, p);
            p = fmaf(xv[4 * q + 1], wv.y, p);
            p = fmaf(xv[4 * q + 2], wv.z, p);
            p = fmaf(xv[4 * q + 3], wv.w, p);
          }
          t[c] = m3seg::selu(t[c] + (p + b_s[c]));
        }
        // out = selu(W_cc_t t + W_cc_x x + b_cc), four channels at a time
        float4* dst = reinterpret_cast<float4*>(out + vox * C);
#pragma unroll
        for (int q4 = 0; q4 < C4; ++q4) {
          float ov[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = 4 * q4 + u;
            float q = 0.f, s = 0.f;
#pragma unroll
            for (int q2 = 0; q2 < C4; ++q2) {
              const float4 wv = wcat4[(C + c) * C4 + q2];
              q = fmaf(xv[4 * q2], wv.x, q);
              q = fmaf(xv[4 * q2 + 1], wv.y, q);
              q = fmaf(xv[4 * q2 + 2], wv.z, q);
              q = fmaf(xv[4 * q2 + 3], wv.w, q);
              const float4 cv = wcc4[c * C4 + q2];
              s = fmaf(t[4 * q2], cv.x, s);
              s = fmaf(t[4 * q2 + 1], cv.y, s);
              s = fmaf(t[4 * q2 + 2], cv.z, s);
              s = fmaf(t[4 * q2 + 3], cv.w, s);
            }
            ov[u] = m3seg::selu(s + (q + b_s[C + c]));
          }
          dst[q4] = make_float4(ov[0], ov[1], ov[2], ov[3]);
        }
        // deep supervision: ds = ds_prev + W_ds x (no bias); four rows (the
        // configs' out_channels) move as one 16-byte load and store
        float dsv[kMaxDs];
#pragma unroll
        for (int r = 0; r < kMaxDs; ++r) {
          dsv[r] = 0.f;
          if (r < nds) {
#pragma unroll
            for (int q = 0; q < C4; ++q) {
              const float4 wv = wcat4[(2 * C + r) * C4 + q];
              dsv[r] = fmaf(xv[4 * q], wv.x, dsv[r]);
              dsv[r] = fmaf(xv[4 * q + 1], wv.y, dsv[r]);
              dsv[r] = fmaf(xv[4 * q + 2], wv.z, dsv[r]);
              dsv[r] = fmaf(xv[4 * q + 3], wv.w, dsv[r]);
            }
          }
        }
        if (nds == 4) {
          const float4 pv =
              *reinterpret_cast<const float4*>(ds_prev + vox * 4);
          *reinterpret_cast<float4*>(ds_out + vox * 4) = make_float4(
              pv.x + dsv[0], pv.y + dsv[1], pv.z + dsv[2], pv.w + dsv[3]);
        } else {
#pragma unroll
          for (int r = 0; r < kMaxDs; ++r)
            if (r < nds)
              ds_out[vox * nds + r] = ds_prev[vox * nds + r] + dsv[r];
        }
      }
    }
    __syncthreads();  // the chunk's y1 no longer read
  }
  if (!forward) return;

  // ---- second pass, the forward H stage: the tile's out, written above,
  // read back through L2 chunk by chunk into F, held in registers only
  // now, so that the first pass's tail has the registers to itself.
  // Thread hl of column wl holds tiles e = hl + kTH j: (4 rows k4 of 2KH,
  // channels 4q .. 4q + 3)
  const int n_ft = (KH / 2) * C4;  // F tiles of a column
  float4 acc_f[kFJ][4];
#pragma unroll
  for (int j = 0; j < kFJ; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc_f[j][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int h0 = 0; h0 < H; h0 += kTH) {
    stage_out<C>(out, d, h0, H, W, w0, nw, o_s);
    stage_mh(m, h0, H, KH, mh_s);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    const int nh = min(kTH, H - h0);
    const float4* mh4 = reinterpret_cast<const float4*>(mh_s);
#pragma unroll
    for (int j = 0; j < kFJ; ++j) {
      const int e = hl + kTH * j;
      if (e < n_ft) {
        const int q = e % C4, k4 = e / C4;
#pragma unroll 4
        for (int hh = 0; hh < nh; ++hh) {
          const float4 ov4 = o4[(wl * kTH + hh) * C4 + q];
          const float4 mv = mh4[hh * (k2n / 4) + k4];
          const float mu[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc_f[j][u].x = fmaf(ov4.x, mu[u], acc_f[j][u].x);
            acc_f[j][u].y = fmaf(ov4.y, mu[u], acc_f[j][u].y);
            acc_f[j][u].z = fmaf(ov4.z, mu[u], acc_f[j][u].z);
            acc_f[j][u].w = fmaf(ov4.w, mu[u], acc_f[j][u].w);
          }
        }
      }
    }
    __syncthreads();  // the next chunk rewrites the chunk and Mh rows
  }

  // F over the y tile, which no thread reads any more
  float4* f4w = reinterpret_cast<float4*>(y_s);
#pragma unroll
  for (int j = 0; j < kFJ; ++j) {
    const int e = hl + kTH * j;
    if (e < n_ft) {
      const int q = e % C4, k4 = e / C4;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        f4w[(wl * k2n + 4 * k4 + u) * C4 + q] = acc_f[j][u];
    }
  }
  __syncthreads();

  // ---- forward W stage over this tile's columns: the partial spectrum,
  // four channels of one (k, j) per thread
  const int ng = C * KH * KW;
  const float4* f4s = reinterpret_cast<const float4*>(y_s);
  float* pd = partial + ((size_t)d * n_tiles + tile) * 2 * ng;
  for (int e = tid; e < KH * KW * C4; e += kThreads) {
    const int j = e % KW, r = e / KW;
    const int q = r % C4, k = r / C4;
    float re[4] = {0.f, 0.f, 0.f, 0.f}, im[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < nw; ++w) {
      const float4 a4 = f4s[(w * k2n + k) * C4 + q];
      const float4 b4 = f4s[(w * k2n + KH + k) * C4 + q];
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cs = cw_s[w * KW + j], sn = sw_s[w * KW + j];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        re[u] = fmaf(av[u], cs, fmaf(-bv[u], sn, re[u]));
        im[u] = fmaf(av[u], sn, fmaf(bv[u], cs, im[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = ((4 * q + u) * KH + k) * KW + j;
      pd[idx] = re[u];
      pd[ng + idx] = im[u];
    }
  }
}

// Adds one z value pair (a = re, b = im of column j) to the inverse W stage
// of the tile's kTW columns; cwi_j, swi_j: row j of the tile's Cwi, Swi.
__device__ __forceinline__ void w_inverse_add(float a, float b,
                                              const float* cwi_j,
                                              const float* swi_j,
                                              float (&re)[kTW],
                                              float (&im)[kTW]) {
  const float4* cs4 = reinterpret_cast<const float4*>(cwi_j);
  const float4* sn4 = reinterpret_cast<const float4*>(swi_j);
#pragma unroll
  for (int q = 0; q < kTW / 4; ++q) {
    const float4 cs = cs4[q], sn = sn4[q];
    const float cv[4] = {cs.x, cs.y, cs.z, cs.w};
    const float sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      re[4 * q + u] = fmaf(a, cv[u], fmaf(-b, sv[u], re[4 * q + u]));
      im[4 * q + u] = fmaf(a, sv[u], fmaf(b, cv[u], im[4 * q + u]));
    }
  }
}

// Plane d's z, read from a z tensor (D, 2, C, KH, KW): one z row (c, k)
// per thread, all kTW columns at once. kL2: z was written by the same
// launch (tower_resident's z phase), so it is read through L2.
template <bool kL2>
struct ZFromTensor {
  const float* zd;  // z[d]: (2, C, KH, KW)
  int C, KH, KW;

  __device__ __forceinline__ void row(int c, int k, const float* cwi_s,
                                      const float* swi_s, float (&re)[kTW],
                                      float (&im)[kTW]) const {
    const float* zr = zd + (size_t)(c * KH + k) * KW;
    const float* zi = zr + (size_t)C * KH * KW;
    if ((KW & 3) == 0) {  // 16-byte loads, four in flight for each part
#pragma unroll 4
      for (int j4 = 0; j4 < KW; j4 += 4) {
        const float4 a4 =
            m3seg::ldg_or_cg<kL2>(reinterpret_cast<const float4*>(zr + j4));
        const float4 b4 =
            m3seg::ldg_or_cg<kL2>(reinterpret_cast<const float4*>(zi + j4));
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w_inverse_add(av[u], bv[u], cwi_s + (j4 + u) * kTW,
                        swi_s + (j4 + u) * kTW, re, im);
      }
    } else if ((KW & 1) == 0) {
#pragma unroll 2
      for (int j2 = 0; j2 < KW; j2 += 2) {
        const float2 a2 =
            m3seg::ldg_or_cg<kL2>(reinterpret_cast<const float2*>(zr + j2));
        const float2 b2 =
            m3seg::ldg_or_cg<kL2>(reinterpret_cast<const float2*>(zi + j2));
        w_inverse_add(a2.x, b2.x, cwi_s + j2 * kTW, swi_s + j2 * kTW, re,
                      im);
        w_inverse_add(a2.y, b2.y, cwi_s + (j2 + 1) * kTW,
                      swi_s + (j2 + 1) * kTW, re, im);
      }
    } else {  // odd KW: rows start at odd offsets
      for (int j = 0; j < KW; ++j)
        w_inverse_add(m3seg::ldg_or_cg<kL2>(zr + j),
                      m3seg::ldg_or_cg<kL2>(zi + j), cwi_s + j * kTW,
                      swi_s + j * kTW, re, im);
    }
  }

  __device__ __forceinline__ void fill_y(float* y_s, int ny,
                                         const float* cwi_s,
                                         const float* swi_s) const {
    for (int e = threadIdx.x; e < C * KH; e += kThreads) {
      const int c = e % C, k = e / C;
      float re[kTW], im[kTW];
#pragma unroll
      for (int w = 0; w < kTW; ++w) re[w] = im[w] = 0.f;
      row(c, k, cwi_s, swi_s, re, im);
#pragma unroll
      for (int w = 0; w < kTW; ++w) {
        y_s[(k * kTW + w) * C + c] = re[w];
        y_s[ny + (k * kTW + w) * C + c] = im[w];
      }
    }
  }
};

// Sets the kernel's dynamic shared memory and reports its occupancy:
// resident blocks per SM at that shared memory, and registers per thread.
template <class Kernel>
cudaError_t kernel_occupancy(Kernel kernel, size_t smem, int* blocks,
                             int* regs) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       kThreads, smem);
}

}  // namespace
