// The resident packed spectrum's two ends of a tower block, shared by
// csrc/tower_block_s.cu (one block per launch) and csrc/tower_resident.cu
// (the whole tower in one persistent launch):
//   ZFromSpectrum        a plane's z = sum_s mi[d, :, s] sy[s], formed inside
//                        the block body (the inverse depth stage);
//   depth_group_element  the forward depth stage of the blocks' partial
//                        spectra, one element of one plane group.
// The spectrum (KS, C, KH, KW) fp32: Hartley KS = KD, real; Fourier
// KS = 2 KD, [re; im]. mi, mf: the depth matrices (D, 2, KS), one row per
// plane. kL2: the spectrum and the partials were written by the same launch
// (see m3seg::ldg_or_cg).
#pragma once

#include "tower_block.cuh"

namespace {

constexpr int kMaxKS = 64;       // spectrum rows a depth-pass thread holds
constexpr int kDepthGroups = 8;  // plane groups of the depth pass

// Inverse W stage of the z rows r0 .. r0 + nr - 1 (row r = c KH + k),
// held in shared memory as zre = zs[(r - r0) KW + j], zim = zs[chunk + ...],
// into the y tile: one thread per (row, column) output.
__device__ __forceinline__ void w_inverse_rows(
    const float* zs, int chunk, int r0, int nr, const float* cwi_s,
    const float* swi_s, float* y_s, int ny, int C, int KH, int KW) {
  for (int o = threadIdx.x; o < nr * kTW; o += kThreads) {
    const int rl = o / kTW, w = o % kTW;
    const int c = (r0 + rl) / KH, k = (r0 + rl) % KH;
    const float* za = zs + rl * KW;
    const float* zb = za + chunk;
    float re = 0.f, im = 0.f;
    for (int j = 0; j < KW; ++j) {
      const float a = za[j], b = zb[j];
      const float cv = cwi_s[j * kTW + w], sv = swi_s[j * kTW + w];
      re = fmaf(a, cv, fmaf(-b, sv, re));
      im = fmaf(a, sv, fmaf(b, cv, im));
    }
    y_s[(k * kTW + w) * C + c] = re;
    y_s[ny + (k * kTW + w) * C + c] = im;
  }
}

// Adds sum_s mi[d, :, s] sy[s] at the N4 x 4 consecutive values src[0..]
// of a chunk to za, zb: one 16-byte load per spectrum row and slot, all
// slots' loads in flight together.
template <int N4, bool kL2>
__device__ __forceinline__ void z_values_vec(const float* src,
                                             const float* mi, int KS, int ng,
                                             float (&za)[N4][4],
                                             float (&zb)[N4][4]) {
#pragma unroll 4
  for (int s = 0; s < KS; ++s) {
    const float* p = src + (size_t)s * ng;
    float4 q[N4];
#pragma unroll
    for (int n = 0; n < N4; ++n)
      q[n] = m3seg::ldg_or_cg<kL2>(
          reinterpret_cast<const float4*>(p + n * 4 * kThreads));
    const float m0 = __ldg(mi + s), m1 = __ldg(mi + KS + s);
#pragma unroll
    for (int n = 0; n < N4; ++n) {
      const float v[4] = {q[n].x, q[n].y, q[n].z, q[n].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        za[n][u] = fmaf(m0, v[u], za[n][u]);
        zb[n][u] = fmaf(m1, v[u], zb[n][u]);
      }
    }
  }
}

// The same with scalar loads, for a KW that is not a multiple of 4 (the
// values past ne stay zero).
template <int N4, bool kL2>
__device__ __forceinline__ void z_values_scalar(const float* src,
                                                const float* mi, int KS,
                                                int ng, int left,
                                                float (&za)[N4][4],
                                                float (&zb)[N4][4]) {
#pragma unroll 2
  for (int s = 0; s < KS; ++s) {
    const float* p = src + (size_t)s * ng;
    float v[N4][4];
#pragma unroll
    for (int n = 0; n < N4; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = n * 4 * kThreads + u;
        v[n][u] = i < left ? m3seg::ldg_or_cg<kL2>(p + i) : 0.f;
      }
    const float m0 = __ldg(mi + s), m1 = __ldg(mi + KS + s);
#pragma unroll
    for (int n = 0; n < N4; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        za[n][u] = fmaf(m0, v[n][u], za[n][u]);
        zb[n][u] = fmaf(m1, v[n][u], zb[n][u]);
      }
  }
}

// Plane d's z, formed from the resident spectrum chunk by chunk: a chunk
// is the whole rows (row r = c KH + k) of at most kTH kTW C / 2 values (the
// scratch holds its two components); each thread forms N4 = C / 8 slots of
// four consecutive values, z = sum_s mi[d, :, s] sy[s].
template <bool kL2>
struct ZFromSpectrum {
  const float* sy;  // (KS, C, KH, KW)
  const float* mi;  // mi[d]: (2, KS)
  int KS, C, KH, KW;

  template <int CC>
  __device__ __forceinline__ void fill_y(float* y_s, int ny,
                                         const float* cwi_s,
                                         const float* swi_s,
                                         float* zs) const {
    constexpr int N4 = CC / 8, chunk = 4 * N4 * kThreads;
    const int ng = CC * KH * KW;  // the stride of a spectrum row
    // Through L2 (kL2) a chunk holds a multiple of 4 rows, so that every
    // chunk starts 16-byte aligned (ng is a multiple of 4: CC is 8 or 24)
    // and takes 16-byte loads: scalar loads would fetch each L2 sector four
    // times, where the read-only path serves the repeats from L1. The
    // caller keeps KW <= kThreads, so a chunk holds at least 4 rows.
    const int rows = kL2 ? (chunk / KW) & ~3 : chunk / KW;
    const bool vec = kL2 || (KW & 3) == 0;
    const int i0 = 4 * threadIdx.x;
    for (int r0 = 0; r0 < CC * KH; r0 += rows) {
      const int nr = min(rows, CC * KH - r0), ne = nr * KW;
      const float* src = sy + (size_t)r0 * KW + i0;
      float za[N4][4] = {}, zb[N4][4] = {};
      if (vec && i0 + 4 * kThreads * (N4 - 1) + 3 < ne)
        z_values_vec<N4, kL2>(src, mi, KS, ng, za, zb);
      else if (i0 < ne)
        z_values_scalar<N4, kL2>(src, mi, KS, ng, ne - i0, za, zb);
#pragma unroll
      for (int n = 0; n < N4; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + n * 4 * kThreads + u;
          zs[i] = za[n][u];
          zs[chunk + i] = zb[n][u];
        }
      __syncthreads();
      w_inverse_rows(zs, chunk, r0, nr, cwi_s, swi_s, y_s, ny, CC, KH, KW);
      __syncthreads();
    }
  }
};

// groups[g][s][e] = sum over the planes d of group g, in plane order, of
// mf[d][0][s] f0 + mf[d][1][s] f1, f_q = sum over the tiles of
// partial[d][tile][q][e] in tile order: element e of a spectrum row
// (C KH KW) and group g, all KS rows in registers.
template <bool kL2>
__device__ __forceinline__ void depth_group_element(
    const float* __restrict__ partial, const float* __restrict__ mf,
    float* __restrict__ groups, int D, int n_tiles, int ng, int KS, int e,
    int g) {
  const int per_group = (D + kDepthGroups - 1) / kDepthGroups;
  const int d0 = g * per_group, d1 = min(D, d0 + per_group);
  float acc[kMaxKS];
#pragma unroll
  for (int s = 0; s < kMaxKS; ++s) acc[s] = 0.f;
  for (int d = d0; d < d1; ++d) {
    const float* p = partial + (size_t)d * n_tiles * 2 * ng + e;
    float f0 = 0.f, f1 = 0.f;
#pragma unroll 4
    for (int t = 0; t < n_tiles; ++t) {
      f0 += m3seg::ld_or_cg<kL2>(p + (size_t)t * 2 * ng);
      f1 += m3seg::ld_or_cg<kL2>(p + (size_t)t * 2 * ng + ng);
    }
    const float* md = mf + (size_t)d * 2 * KS;
#pragma unroll
    for (int s = 0; s < kMaxKS; ++s)
      if (s < KS)
        acc[s] = fmaf(__ldg(md + s), f0, fmaf(__ldg(md + KS + s), f1, acc[s]));
  }
  float* out = groups + (size_t)g * KS * ng + e;
#pragma unroll
  for (int s = 0; s < kMaxKS; ++s)
    if (s < KS) out[(size_t)s * ng] = acc[s];
}

}  // namespace
