// Shared device helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>

namespace m3seg {

constexpr float kSeluScale = 1.0507009873554804934193349852946f;
constexpr float kSeluAlpha = 1.6732632423543772848170429916717f;

// SELU with expm1 on the negative branch, as torch.selu and jax.nn.selu.
__device__ __forceinline__ float selu(float v) {
  return kSeluScale * (v > 0.f ? v : kSeluAlpha * expm1f(v));
}

// Loads of a buffer that one launch rewrites between grid-wide barriers
// (kL2, the persistent tower kernel) go through L2 with ld.global.cg: the
// read-only path (__ldg) is not coherent with those writes, and an SM's L1
// may still hold a line that another SM has rewritten since. Otherwise
// ldg_or_cg is __ldg and ld_or_cg a plain load.
template <bool kL2, class T>
__device__ __forceinline__ T ldg_or_cg(const T* p) {
  if constexpr (kL2) return __ldcg(p);
  else return __ldg(p);
}

template <bool kL2, class T>
__device__ __forceinline__ T ld_or_cg(const T* p) {
  if constexpr (kL2) return __ldcg(p);
  else return *p;
}

}  // namespace m3seg

// Every C entry point returns the launch status (cudaGetLastError) as an
// int; 0 is success. The Python wrapper raises on anything else.
#define M3SEG_API extern "C" __attribute__((visibility("default")))
