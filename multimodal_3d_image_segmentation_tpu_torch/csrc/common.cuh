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

}  // namespace m3seg

// Every C entry point returns the launch status (cudaGetLastError) as an
// int; 0 is success. The Python wrapper raises on anything else.
#define M3SEG_API extern "C" __attribute__((visibility("default")))
