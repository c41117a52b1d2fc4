// Helpers shared by the kernels: element types, 4-wide loads
// into f32 registers, stores back to the element type, warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Masked logits.  The same finite value as the JAX kernels, so that a
// fully masked tile keeps exp(NEG_INF - NEG_INF) = 1 finite; the kernels
// zero masked probabilities explicitly.
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// dtype codes shared with the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ bool is_live(float s) { return s > 0.5f * NEG_INF; }

// Four consecutive elements (16 bytes of f32, 8 bytes of bf16; the
// wrappers check the 16-byte alignment of every base pointer, and every
// offset used here is a multiple of 4 elements).
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  uint2 t = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Reductions over aligned groups of `width` lanes (width a power of two <= 32).
__device__ __forceinline__ float group_max(float x, int width) {
  for (int off = width / 2; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x, int width) {
  for (int off = width / 2; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
