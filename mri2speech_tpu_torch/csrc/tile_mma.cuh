// Operand types and special functions shared by the port's kernels
// (mrf_stage.cu, mbconv_block.cu, and chip_smoke.py's SiLU probe).
//
// Operand<T> rounds an fp32 value to the operand type of the products (bf16 or
// fp32) and back; siluf_ and sigmoidf_ are the precise SiLU and sigmoid the
// kernels use (built without --use_fast_math).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace m2s {

template <typename T>
struct Operand;

template <>
struct Operand<float> {
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static float to_float(float v) { return v; }
};

template <>
struct Operand<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 round(float v) { return __float2bfloat16_rn(v); }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
};

// v rounded to the operand type and back: what the product will see
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Operand<T>::to_float(Operand<T>::round(v));
}

// 1 / d for d >= 1, rounded as the IEEE division 1.0f / d rounds, without the
// division's slow-path branch, so the compiler can interleave several: MUFU.RCP
// and one Newton step with FMA on d / 4 (exact, and 4 / d stays normal), then
// the exact * 1/4, which rounds a second time only where 1/d is subnormal (d >
// 2^126); 0 for d = inf. chip_smoke.py holds sigmoidf_ and siluf_ against the
// division for every fp32 x.
__device__ __forceinline__ float rcp_ge1(float d) {
  const float ds = d * 0.25f;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(ds));
  r = fmaf(fmaf(-ds, r, 1.0f), r, r) * 0.25f;
  return d == __int_as_float(0x7f800000) ? 0.0f : r;
}

// precise expf (not __expf): built without --use_fast_math
__device__ __forceinline__ float sigmoidf_(float x) { return rcp_ge1(1.0f + expf(-x)); }
__device__ __forceinline__ float siluf_(float x) { return x * sigmoidf_(x); }

}  // namespace m2s
