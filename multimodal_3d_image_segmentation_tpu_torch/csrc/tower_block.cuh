// The body of one fused tower block, shared by csrc/tower_block.cu (z read
// from a tensor) and csrc/tower_block_s.cu (z formed from the resident
// spectrum inside the block).
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
// Design. One plane is 906 KB at the serving sizes and does not fit a
// block's 227 KB of shared memory (the TPU kernel keeps 8 whole planes in
// VMEM), and the forward stage is a reduction over the whole plane. So each
// block takes one plane and one tile of kTW columns of W: it computes the
// inverse W stage of z for its columns into shared memory (the z source is
// the caller's: read from a tensor, or formed from the resident spectrum),
// then walks the rows of H in chunks of kTH, one thread per voxel and one
// warp per column, so that the column's y and the weights are read from
// shared memory as 16-byte broadcasts; the voxel's C channels stay in
// registers. Each chunk's output folds into the forward H stage of the
// tile's columns, held in shared memory, a 4 x 4 register tile per thread.
// At the end the block applies the forward W stage over its columns and
// writes its partial spectrum. No atomics: the result is the same from run
// to run. SELU keeps expm1f, as torch.selu does.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTW = 8;               // columns of W per block
constexpr int kTH = 32;              // rows of H per chunk
constexpr int kThreads = kTW * kTH;  // one thread per voxel of a chunk
constexpr int kMaxDs = 8;

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
__host__ __device__ inline int smem_floats(int C, int KH, int KW, int nds) {
  return 4 * KH * kTW * C          // y tile and F tile
         + kTH * kTW * C           // one chunk of out
         + (2 * C + nds) * C + C * C + 2 * C  // weights, bias
         + 4 * KW * kTW;           // the tile's columns of Cwi, Swi, Cw, Sw
}

// One block of the kernel on plane blockIdx.y, W tile blockIdx.x. ZSrc
// supplies the plane's z: zsrc.fill_y<C>(y_s, ny, cwi_s, swi_s, scratch)
// writes the inverse W stage of z over the tile's columns into the y tile,
// [2][KH][kTW][C]; every thread of the block calls it; scratch holds
// kTH kTW C floats.
template <int C, class ZSrc>
__device__ __forceinline__ void tower_block_body(
    const ZSrc& zsrc, const float* __restrict__ x,
    const float* __restrict__ wcat, const float* __restrict__ wcc,
    const float* __restrict__ bias, const Mats& m,
    const float* __restrict__ ds_prev, float* __restrict__ out,
    float* __restrict__ partial, float* __restrict__ ds_out, int H, int W,
    int KH, int KW, int nds) {
  constexpr int C4 = C / 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = blockIdx.x, d = blockIdx.y, n_tiles = gridDim.x;
  const int w0 = tile * kTW;
  const int nw = min(kTW, W - w0);
  const int tid = threadIdx.x;
  const int ny = KH * kTW * C;       // one component of the y tile
  float* y_s = smem;                 // [2][KH][kTW][C]
  float* f_s = y_s + 2 * ny;         // [kTW][2KH][C]: F = out Mh
  float* o_s = f_s + 2 * ny;         // [kTW][kTH][C]
  float* wcat_s = o_s + kTH * kTW * C;        // [2C + nds][C] (out, in)
  float* wcc_s = wcat_s + (2 * C + nds) * C;  // [C][C]        (out, in)
  float* b_s = wcc_s + C * C;                 // [2C]
  float* cwi_s = b_s + 2 * C;                 // [KW][kTW]
  float* swi_s = cwi_s + KW * kTW;            // [KW][kTW]
  float* cw_s = swi_s + KW * kTW;             // [kTW][KW]
  float* sw_s = cw_s + kTW * KW;              // [kTW][KW]

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
  for (int i = tid; i < 2 * ny / 4; i += kThreads)
    reinterpret_cast<float4*>(f_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // ---- inverse W stage of z[d] for this tile's columns (the chunk of out,
  // not yet in use, is the scratch)
  zsrc.template fill_y<C>(y_s, ny, cwi_s, swi_s, o_s);
  __syncthreads();

  const float4* wcat4 = reinterpret_cast<const float4*>(wcat_s);
  const float4* wcc4 = reinterpret_cast<const float4*>(wcc_s);
  // a warp takes 32 rows of one column: its shared-memory reads of the
  // column's y and of the weights are broadcasts
  const int hl = tid % kTH, wl = tid / kTH;
  const int k2n = 2 * KH;
  for (int h0 = 0; h0 < H; h0 += kTH) {
    const int h = h0 + hl;
    float4* o_dst = reinterpret_cast<float4*>(o_s + (wl * kTH + hl) * C);
    if (h < H && wl < nw) {
      // the voxel's channels first: their loads overlap the y1 loop
      const size_t vox = ((size_t)d * H + h) * W + (w0 + wl);
      float xv[C];
      const float4* src = reinterpret_cast<const float4*>(x + vox * C);
#pragma unroll
      for (int q = 0; q < C4; ++q) {
        const float4 v = src[q];
        xv[4 * q] = v.x;
        xv[4 * q + 1] = v.y;
        xv[4 * q + 2] = v.z;
        xv[4 * q + 3] = v.w;
      }
      // y1: the inverse H stage at this voxel, all channels
      float t[C];
#pragma unroll
      for (int c = 0; c < C; ++c) t[c] = 0.f;
#pragma unroll 2
      for (int k = 0; k < KH; ++k) {
        const float a = __ldg(m.ha + k * H + h), b = __ldg(m.hb + k * H + h);
        const float4* yr = reinterpret_cast<const float4*>(
            y_s + (k * kTW + wl) * C);
        const float4* yi = yr + ny / 4;
#pragma unroll
        for (int q = 0; q < C4; ++q) {
          const float4 r = yr[q], i = yi[q];
          t[4 * q] = fmaf(r.x, a, fmaf(i.x, b, t[4 * q]));
          t[4 * q + 1] = fmaf(r.y, a, fmaf(i.y, b, t[4 * q + 1]));
          t[4 * q + 2] = fmaf(r.z, a, fmaf(i.z, b, t[4 * q + 2]));
          t[4 * q + 3] = fmaf(r.w, a, fmaf(i.w, b, t[4 * q + 3]));
        }
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
        float o4[4];
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
          o4[u] = m3seg::selu(s + (q + b_s[C + c]));
        }
        const float4 ov = make_float4(o4[0], o4[1], o4[2], o4[3]);
        dst[q4] = ov;
        o_dst[q4] = ov;
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
        const float4 pv = *reinterpret_cast<const float4*>(ds_prev + vox * 4);
        *reinterpret_cast<float4*>(ds_out + vox * 4) = make_float4(
            pv.x + dsv[0], pv.y + dsv[1], pv.z + dsv[2], pv.w + dsv[3]);
      } else {
#pragma unroll
        for (int r = 0; r < kMaxDs; ++r)
          if (r < nds) ds_out[vox * nds + r] = ds_prev[vox * nds + r] + dsv[r];
      }
    } else {
#pragma unroll
      for (int q = 0; q < C4; ++q) o_dst[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    // ---- forward H stage of this chunk into F, a 4 (k2) x 4 (c) tile of
    // one column per thread
    const int nh = min(kTH, H - h0);
    const int nk4 = k2n / 4;
    const float4* o4s = reinterpret_cast<const float4*>(o_s);
    float4* f4s = reinterpret_cast<float4*>(f_s);
    for (int e = tid; e < kTW * nk4 * C4; e += kThreads) {
      const int q = e % C4, r = e / C4;
      const int k4 = r % nk4, wl2 = r / nk4;
      float4 acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = f4s[(wl2 * k2n + 4 * k4 + u) * C4 + q];
      const float* mh = m.mhf + (size_t)h0 * k2n + 4 * k4;
#pragma unroll 4
      for (int hh = 0; hh < nh; ++hh) {
        const float4 ov = o4s[(wl2 * kTH + hh) * C4 + q];
        const float4 mv = __ldg(reinterpret_cast<const float4*>(mh + hh * k2n));
        const float mu[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[u].x = fmaf(ov.x, mu[u], acc[u].x);
          acc[u].y = fmaf(ov.y, mu[u], acc[u].y);
          acc[u].z = fmaf(ov.z, mu[u], acc[u].z);
          acc[u].w = fmaf(ov.w, mu[u], acc[u].w);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) f4s[(wl2 * k2n + 4 * k4 + u) * C4 + q] = acc[u];
    }
    __syncthreads();
  }

  // ---- forward W stage over this tile's columns: the partial spectrum,
  // four channels of one (k, j) per thread
  const int ng = C * KH * KW;
  const float4* f4s = reinterpret_cast<const float4*>(f_s);
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
