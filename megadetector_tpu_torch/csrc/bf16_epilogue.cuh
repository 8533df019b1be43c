// bf16 rounding helpers shared by silu_bf16.cu (the bf16 conv epilogue)
// and conv_int8.cu (the experiments' bf16 and hybrid epilogues). XLA
// lowers every bf16 jnp op to an f32 op and a rounding convert, so
// x * sigmoid(x) on a bf16 value is exp, 1 +, 1 / and * each rounded to
// bf16; these helpers round at exactly those points (the build passes
// -fmad=false). Where the graph converts a bf16 result straight back to
// f32, XLA drops that op's rounding (it removes the f32 -> bf16 -> f32
// pair), so the experiments' epilogues take the last op in f32.

#pragma once

#include <cuda_bf16.h>

// f32 -> bf16 (round to nearest even) -> f32
__device__ __forceinline__ float md_bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 1 + exp(-y) of a bf16 value y, in bf16: e = bf16(exp(-y)),
// d = bf16(1 + e)
__device__ __forceinline__ float md_sigmoid_denominator_bf16(float y) {
  const float e = md_bf16_round(expf(-y));
  return md_bf16_round(__fadd_rn(1.0f, e));
}

// sigmoid of a bf16 value y, in bf16: s = bf16(1 / d)
__device__ __forceinline__ float md_sigmoid_bf16(float y) {
  return md_bf16_round(__fdiv_rn(1.0f, md_sigmoid_denominator_bf16(y)));
}

// y * sigmoid(y) of a bf16 value y, the product rounded to bf16 too
__device__ __forceinline__ __nv_bfloat16 md_silu_bf16_one(float y) {
  return __float2bfloat16_rn(__fmul_rn(y, md_sigmoid_bf16(y)));
}
