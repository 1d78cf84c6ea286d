// Fused tower block of the spectral towers (HartleyMHASeg serving).
//
// Replaces: multimodal_3d_image_segmentation_tpu/kernels/tower_block.py
//   fused_tower_block (pallas_call in _run_tower_kernel, tower_block.py:377,
//   body _tower_kernel).
//
// Computes, for every depth plane d of the tower grid (D, H, W), C channels,
// x and out channels-last (D, H, W, C), spectra (D, 2, C, KH, KW):
//   y    = [zre Cwi - zim Swi, zre Swi + zim Cwi]        inverse W stage
//   y1   = yre A + yim B         inverse H stage ('fold'), (H, W, C)
//   p, q = [W_conv ; W_cc_x] x + [b_conv ; b_cc];  ds = ds_prev + W_ds x
//   t    = selu(y1 + p);  out = selu(W_cc_t t + q)
//   F    = out Mh   (H -> [cos | sin] x KH, 1/H)          forward H stage
//   f    = [Fre Cw - Fim Sw, Fre Sw + Fim Cw]  (W -> KW)  forward W stage
// in exact fp32 FMAs on the CUDA cores (no TF32): the TPU kernel's packed
// bf16x3 products are its way to fp32-class accuracy; here fp32 is native.
//
// What bounds it on an H100: the operations. At the serving size (grid
// 121 x 121 x 78, C 24, KH = KW = 24, 4 ds rows) a call does 47.6 M MACs
// per plane, 11.5 GFLOP, 0.172 ms at 67 TFLOP/s fp32, against 282.6 MB of
// volume, spectra and ds traffic, 0.084 ms at 3.35 TB/s.
//
// Design. One plane is 906 KB at the serving size and does not fit a
// block's 227 KB of shared memory (the TPU kernel keeps 8 whole planes in
// VMEM), and the forward stage is a reduction over the whole plane. So each
// block takes one plane and one tile of kTW columns of W (121 x 10 blocks at
// the serving size, 109 KB of shared memory each, two blocks per SM): it
// computes the inverse W stage of z for its columns into shared memory (one
// z row per thread, all kTW columns at once), then walks the rows of H in
// chunks of kTH, one thread per voxel and one warp per column, so that the
// column's y and the weights are read from shared memory as 16-byte
// broadcasts; the voxel's C channels stay in registers. Each chunk's output
// folds into the forward H stage of the tile's columns, held in shared
// memory, a 4 x 4 register tile per thread. At the end the block applies
// the forward W stage over its columns and writes a partial spectrum; a
// second kernel sums the tiles' partials in tile order. No atomics: f is
// the same from run to run. SELU keeps expm1f, as torch.selu does.
#include "common.cuh"

namespace {

constexpr int kTW = 8;               // columns of W per block
constexpr int kTH = 32;              // rows of H per chunk
constexpr int kThreads = kTW * kTH;  // one thread per voxel of a chunk
constexpr int kMaxDs = 8;

struct Mats {  // fp32 stage matrices, row-major
  const float* cwi;  // (KW, W)
  const float* swi;  // (KW, W)
  const float* ha;   // (KH, H)  C - S
  const float* hb;   // (KH, H)  -(C + S)
  const float* mhf;  // (H, 2KH) [cos | sin] / H
  const float* cw;   // (W, KW)  / W
  const float* sw;   // (W, KW)
};

// Shared memory of a block, in floats (each part a multiple of 4, so every
// part is 16-byte aligned for float4 access).
__host__ __device__ inline int smem_floats(int C, int KH, int KW, int nds) {
  return 4 * KH * kTW * C          // y tile and F tile
         + kTH * kTW * C           // one chunk of out
         + (2 * C + nds) * C + C * C + 2 * C  // weights, bias
         + 4 * KW * kTW;           // the tile's columns of Cwi, Swi, Cw, Sw
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
tower_block_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ wcat,
                   const float* __restrict__ wcc,
                   const float* __restrict__ bias, Mats m,
                   const float* __restrict__ ds_prev,
                   float* __restrict__ out, float* __restrict__ partial,
                   float* __restrict__ ds_out, int H, int W, int KH, int KW,
                   int nds) {
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

  // ---- inverse W stage of z[d] for this tile's columns: one z row (c, k)
  // per thread, all kTW columns at once
  const float* zd = z + (size_t)d * 2 * C * KH * KW;
  for (int e = tid; e < C * KH; e += kThreads) {
    const int c = e % C, k = e / C;
    const float* zr = zd + (size_t)(c * KH + k) * KW;
    const float* zi = zr + (size_t)C * KH * KW;
    float re[kTW], im[kTW];
#pragma unroll
    for (int w = 0; w < kTW; ++w) re[w] = im[w] = 0.f;
#pragma unroll 2
    for (int j2 = 0; j2 < KW; j2 += 2) {  // KW = 2 * modes is even
      const float2 a2 = __ldg(reinterpret_cast<const float2*>(zr + j2));
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(zi + j2));
      const float av[2] = {a2.x, a2.y}, bv[2] = {b2.x, b2.y};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float a = av[jj], b = bv[jj];
        const float4* cs4 =
            reinterpret_cast<const float4*>(cwi_s + (j2 + jj) * kTW);
        const float4* sn4 =
            reinterpret_cast<const float4*>(swi_s + (j2 + jj) * kTW);
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
    }
#pragma unroll
    for (int w = 0; w < kTW; ++w) {
      y_s[(k * kTW + w) * C + c] = re[w];
      y_s[ny + (k * kTW + w) * C + c] = im[w];
    }
  }
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

// f[d] = sum over the tiles of partial[d][tile], in tile order.
__global__ void tower_spectrum_sum(const float* __restrict__ partial,
                                   float* __restrict__ f, int n_tiles,
                                   long long per_plane, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long d = i / per_plane, e = i % per_plane;
  const float* p = partial + d * n_tiles * per_plane + e;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += p[t * per_plane];
  f[i] = s;
}

template <int C>
cudaError_t launch(const float* x, const float* z, const float* wcat,
                   const float* wcc, const float* bias, Mats m,
                   const float* ds_prev, float* out, float* f, float* ds,
                   float* partial, int D, int H, int W, int KH, int KW,
                   int nds, cudaStream_t stream) {
  const int n_tiles = (W + kTW - 1) / kTW;
  const size_t smem = sizeof(float) * smem_floats(C, KH, KW, nds);
  cudaError_t err = cudaFuncSetAttribute(
      tower_block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  tower_block_kernel<C><<<dim3(n_tiles, D), kThreads, smem, stream>>>(
      x, z, wcat, wcc, bias, m, ds_prev, out, partial, ds, H, W, KH, KW, nds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_plane = 2LL * C * KH * KW;
  const long long total = per_plane * D;
  const int threads = 256;
  tower_spectrum_sum<<<(unsigned)((total + threads - 1) / threads), threads,
                       0, stream>>>(partial, f, n_tiles, per_plane, total);
  return cudaGetLastError();
}

}  // namespace

// x, out: (D, H, W, c); z, f: (D, 2, c, kh, kw); wcat: (2c + nds, c) and
// wcc: (c, c), rows = outputs; bias: (2c,); mats: the stage matrices in the
// order of Mats; ds_prev, ds: (D, H, W, nds) or null when nds == 0;
// partial: (D, ceil(W / 8), 2, c, kh, kw) scratch. fp32, contiguous.
M3SEG_API int m3seg_tower_block(const float* x, const float* z,
                                const float* wcat, const float* wcc,
                                const float* bias, const float* mats,
                                const float* ds_prev, float* out, float* f,
                                float* ds, float* partial, int D, int H,
                                int W, int c, int kh, int kw, int nds,
                                void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || kh <= 0 || kw <= 0 || nds < 0 ||
      nds > kMaxDs || (nds > 0 && (ds_prev == nullptr || ds == nullptr)))
    return (int)cudaErrorInvalidValue;
  Mats m;
  m.cwi = mats;
  m.swi = m.cwi + (size_t)kw * W;
  m.ha = m.swi + (size_t)kw * W;
  m.hb = m.ha + (size_t)kh * H;
  m.mhf = m.hb + (size_t)kh * H;
  m.cw = m.mhf + (size_t)H * 2 * kh;
  m.sw = m.cw + (size_t)W * kw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 8:
      return (int)launch<8>(x, z, wcat, wcc, bias, m, ds_prev, out, f, ds,
                            partial, D, H, W, kh, kw, nds, s);
    case 24:
      return (int)launch<24>(x, z, wcat, wcc, bias, m, ds_prev, out, f, ds,
                             partial, D, H, W, kh, kw, nds, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
