// Shared device helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace m3seg {

constexpr float kSeluScale = 1.0507009873554804934193349852946f;
constexpr float kSeluAlpha = 1.6732632423543772848170429916717f;

// SELU with expm1 on the negative branch, as torch.selu and jax.nn.selu.
__device__ __forceinline__ float selu(float v) {
  return kSeluScale * (v > 0.f ? v : kSeluAlpha * expm1f(v));
}

// SELU with a branch-free expm1 of the negative branch: a Taylor
// polynomial on [-0.5, 0] (its truncation 1e-8 relative), exp2 (ex2.approx)
// less 1 below; within a few fp32 ulps of expm1f, where torch.selu's and
// the FMA bodies' expm1f costs about twice the instructions and a branch.
// The tensor-core bodies' SELU (tower_block_mma.cuh, conv_in_mma.cu).
__device__ __forceinline__ float selu_fast(float v) {
  const float x = v > 0.f ? 0.f : v;  // NaN stays NaN
  float p = 1.f / 40320.f;
  p = fmaf(p, x, 1.f / 5040.f);
  p = fmaf(p, x, 1.f / 720.f);
  p = fmaf(p, x, 1.f / 120.f);
  p = fmaf(p, x, 1.f / 24.f);
  p = fmaf(p, x, 1.f / 6.f);
  p = fmaf(p, x, 0.5f);
  p = fmaf(p, x, 1.f);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * 1.4426950408889634f));
  const float em1 = x > -0.5f ? p * x : e - 1.f;
  return kSeluScale * (v > 0.f ? v : kSeluAlpha * em1);
}

// fp32 <-> the element type of a kernel instance (float or bf16), through
// the conversion intrinsics only; from_float rounds to nearest even.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back: the value a T store and reload would give.
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// 8 bf16 values (16 bytes) <-> two float4, and 4 (8 bytes) <- one float4.
__device__ __forceinline__ void bf16x8_to_float4x2(uint4 q, float4* d) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
  d[0] = make_float4(a.x, a.y, b.x, b.y);
  d[1] = make_float4(c.x, c.y, e.x, e.y);
}
__device__ __forceinline__ uint4 float4x2_to_bf16x8(float4 a, float4 b) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return q;
}
__device__ __forceinline__ uint2 float4_to_bf16x4(float4 a) {
  uint2 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  return q;
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
