// Loads and stores that read f32 or bf16 global memory as f32, for the
// kernels that take either type and compute in f32 (flash_attn, wkv).
#pragma once

#include <cuda_bf16.h>

// Four consecutive elements (16-byte aligned for f32, 8 for bf16) as floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

// One f32 value into the output's type, rounded to nearest.
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Four f32 values into four consecutive elements (aligned as for load4),
// each rounded to nearest as store1 rounds it.
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __halves2bfloat162(__float2bfloat16(x.x), __float2bfloat16(x.y));
  const __nv_bfloat162 b = __halves2bfloat162(__float2bfloat16(x.z), __float2bfloat16(x.w));
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}
