// The int8 chain's float epilogue, shared by conv_int8.cu and
// bottleneck_int8.cu. Every step rounds where the plain PyTorch version
// (ops/conv_int8.py chain_epilogue_reference) rounds, so kernel and plain
// version agree bit for bit on the card.

#pragma once

#include <stdint.h>

// acc * scale + bias: int -> float, product and sum each rounded
__device__ __forceinline__ float md_affine(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

// y * sigmoid(y), with PyTorch's CUDA sigmoid 1 / (1 + exp(-y))
__device__ __forceinline__ float md_silu(float y) {
  return __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y))));
}

// clamp(rint(y / scale), -127, 127): IEEE division, round half to even
__device__ __forceinline__ int8_t md_requant(float y, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(y, scale)), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}
