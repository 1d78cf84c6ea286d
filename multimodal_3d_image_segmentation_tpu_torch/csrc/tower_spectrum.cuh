// The resident packed spectrum's two ends of a tower block, shared by
// csrc/tower_block_s.cu (each in a launch of its own) and
// csrc/tower_resident.cu (each in a phase between grid barriers); the tile
// sum is also csrc/tower_block.cu's second launch:
//   z_group_element  the inverse depth stage: each plane's z
//                    = sum_s mi[d, :, s] sy[s], once per plane, into a
//                    scratch z (D, 2, C, KH, KW) that the block body reads
//                    (ZFromTensor);
//   tile_sum4        the blocks' partial spectra summed over the W tiles of
//                    each plane, in tile order, into f (D, 2, C KH KW);
//   depth_rows       the forward depth stage of f into the folded spectrum
//                    s_f: the planes of each of kDepthGroups groups in
//                    plane order, then the groups in group order.
// The spectrum (KS, C, KH, KW) fp32: Hartley KS = KD, real; Fourier
// KS = 2 KD, [re; im]. mi: the inverse depth matrix (D, 2, KS), one row
// per plane; mf: the forward one, packed (ceil(KS / 4), D, 2, 4). kL2: the
// buffer read was written by the same launch (see m3seg::ldg_or_cg). No
// atomics: every sum has one fixed order, so a second run gives the same
// bits.
#pragma once

#include "tower_block.cuh"

namespace {

// The spectrum rows the C entries and wrappers take. No pass here needs a
// bound (z_group_element loops over KS, depth_rows takes 4 rows a thread);
// it stays until ROADMAP R2 lifts it with tests at KS > 64.
constexpr int kMaxKS = 64;
constexpr int kDepthGroups = 8;  // plane groups of the forward depth stage
constexpr int kDepthRows = 4;    // spectrum rows of a depth_rows thread
constexpr int kZGroups = 64;     // plane groups of the z pass
constexpr int kPassThreads = 256;  // threads of a pass launched on its own

// z at the four elements e4 .. e4 + 3 of a spectrum row (C KH KW) for the
// planes of group g: z[d][q][e] = sum_s mi[d][q][s] s[s][e], s ascending.
// Four planes at a time share each 16-byte load of the spectrum, so every
// load feeds 32 FMAs (ng is a multiple of 4: C is 8 or 24). (An earlier
// version of the resident kernel's z phase that held all KS spectrum
// values of an element in a register array gave wrong sums for C 8 on the
// card and right ones in a host run of the same source; its cause was not
// found. The CUDA tests hold this function at C 8 with short last plane
// groups, in both kernels.)
template <bool kL2>
__device__ __forceinline__ void z_group_element(const float* s,
                                                const float* __restrict__ mi,
                                                float* z, int D, int ng,
                                                int KS, int e4, int g) {
  const int per_group = (D + kZGroups - 1) / kZGroups;
  const int d1 = min(D, (g + 1) * per_group);
  for (int d0 = g * per_group; d0 < d1; d0 += 4) {
    const int n = min(4, d1 - d0);
    float za[4][4] = {}, zb[4][4] = {};  // [plane][element]
#pragma unroll 2
    for (int k = 0; k < KS; ++k) {
      const float4 q = m3seg::ldg_or_cg<kL2>(
          reinterpret_cast<const float4*>(s + (size_t)k * ng + e4));
      const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < n) {
          const float* md = mi + (size_t)(d0 + i) * 2 * KS;
          const float m0 = __ldg(md + k), m1 = __ldg(md + KS + k);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            za[i][u] = fmaf(m0, v[u], za[i][u]);
            zb[i][u] = fmaf(m1, v[u], zb[i][u]);
          }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) {
        float* zd = z + (size_t)(d0 + i) * 2 * ng + e4;
        *reinterpret_cast<float4*>(zd) =
            make_float4(za[i][0], za[i][1], za[i][2], za[i][3]);
        *reinterpret_cast<float4*>(zd + ng) =
            make_float4(zb[i][0], zb[i][1], zb[i][2], zb[i][3]);
      }
  }
}

// Float4 i of f (D, 2 ng): the sum over the n_tiles tiles of plane
// d = i / per4 of partial (D, n_tiles, 2 ng), in tile order; per4 = 2 ng / 4
// (ng is a multiple of 4: C is 8 or 24). Each thread keeps four 16-byte
// loads in flight.
template <bool kL2>
__device__ __forceinline__ void tile_sum4(const float* partial, float* f,
                                          int n_tiles, int per4,
                                          long long i) {
  const long long d = i / per4, e4 = i % per4;
  const float4* p =
      reinterpret_cast<const float4*>(partial) + d * n_tiles * per4 + e4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int t = 0; t < n_tiles; ++t) {
    const float4 v = m3seg::ld_or_cg<kL2>(p + (size_t)t * per4);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  reinterpret_cast<float4*>(f)[i] = s;
}

// The tile sum as a launch of its own: one thread per float4 of f.
__global__ void tower_spectrum_tiles(const float* __restrict__ partial,
                                     float* __restrict__ f, int n_tiles,
                                     int per4, long long total4) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < total4) tile_sum4<false>(partial, f, n_tiles, per4, i);
}

// f (D, 2 ng) = partial (D, n_tiles, 2 ng) summed over its tiles.
inline cudaError_t launch_tile_sum(const float* partial, float* f, int D,
                                   int n_tiles, int ng,
                                   cudaStream_t stream) {
  const int per4 = 2 * ng / 4;
  const long long total4 = (long long)D * per4;
  tower_spectrum_tiles<<<(unsigned)((total4 + kPassThreads - 1) /
                                    kPassThreads),
                         kPassThreads, 0, stream>>>(partial, f, n_tiles,
                                                    per4, total4);
  return cudaGetLastError();
}

// s_f[s0 + u][e], u < kDepthRows: for each of the kDepthGroups plane
// groups in group order, the sum over its planes d, in plane order, of
// mf[d][0][s] f[d][0][e] + mf[d][1][s] f[d][1][e]. mf4: mf's rows s0 ..
// s0 + kDepthRows - 1 as (D, 2) float4s (the wrappers pack mf so, rows past
// KS zero), read as warp-wide broadcasts. The loads of four planes are in
// flight at once; each value of f feeds kDepthRows rows.
template <bool kL2>
__device__ __forceinline__ void depth_rows(const float* f,
                                           const float4* __restrict__ mf4,
                                           float* s_f, int D, int ng, int KS,
                                           int e, int s0) {
  const int per_group = (D + kDepthGroups - 1) / kDepthGroups;
  float tot[kDepthRows] = {};
  for (int g = 0; g < kDepthGroups; ++g) {
    const int d1 = min(D, (g + 1) * per_group);
    float acc[kDepthRows] = {};
#pragma unroll 4
    for (int d = g * per_group; d < d1; ++d) {
      const float f0 = m3seg::ld_or_cg<kL2>(f + (size_t)d * 2 * ng + e);
      const float f1 = m3seg::ld_or_cg<kL2>(f + (size_t)d * 2 * ng + ng + e);
      const float4 a = __ldg(mf4 + 2 * d), b = __ldg(mf4 + 2 * d + 1);
      const float av[kDepthRows] = {a.x, a.y, a.z, a.w};
      const float bv[kDepthRows] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < kDepthRows; ++u)
        acc[u] = fmaf(av[u], f0, fmaf(bv[u], f1, acc[u]));
    }
#pragma unroll
    for (int u = 0; u < kDepthRows; ++u) tot[u] += acc[u];
  }
#pragma unroll
  for (int u = 0; u < kDepthRows; ++u)
    if (s0 + u < KS) s_f[(size_t)(s0 + u) * ng + e] = tot[u];
}

}  // namespace
