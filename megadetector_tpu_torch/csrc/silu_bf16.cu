// bf16 conv epilogue for Hopper (sm_90a): per-channel bias add and SiLU,
// bf16 in and bf16 out.
//
// Replaces the TPU kernel experiments/exp_pallas_l0_retry.py _bf16_kernel
// (x * sigmoid(x) on a bf16 block), which is the activation
// megadetector_tpu/models/yolov5.py _conv applies after every float conv
// when the detector computes in bf16:
//
//   y   = bf16(conv + b)                      (when a bias is given)
//   e   = bf16(exp(-y))
//   d   = bf16(1 + e)
//   s   = bf16(1 / d)
//   out = bf16(y * s)
//
// Every step rounds to bf16, because XLA lowers the bf16 graph that way
// (one f32 op, then a convert to bf16, per jnp op): x * sigmoid(x) on a
// bf16 array is exp, add, divide and multiply, each rounded. The plain
// PyTorch version (ops/silu_bf16.py silu_bf16_reference) is the same
// chain of bf16 torch ops, which on the card compute each op in float and
// round once, so kernel and plain version agree bit for bit: expf is the
// same library function, 1 / d an IEEE division (__fdiv_rn) and the
// conversions round to nearest even (__float2bfloat16_rn). The build
// passes -fmad=false.
//
// The bias belongs to the conv (cuDNN's own bias add would round once,
// after the sum, where the JAX graph rounds the conv output and then the
// sum); it is fused here to save one pass over the tensor.
//
// Layout: any dense tensor of n elements; element i has channel
// (i / inner) % c (channels_last / NHWC: inner = 1; NCHW: inner = H*W).
//
// What bounds it: memory. Each element is read once and written once (4
// bytes); a thread handles 8 elements as one 16-byte load and store when
// the pointers are 16-byte aligned and n % 8 == 0, else one element. The
// channel of each element costs an integer division, which made the first
// version with a bias 2.3x slower than without on the card; the 8-element
// path now finds the channels once per vector where the layout allows:
// channels_last with C % 8 == 0 (8 consecutive channels, one 16-byte bias
// load) or NCHW with H*W % 8 == 0 (one channel for all 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_epilogue.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float with_bias(__nv_bfloat16 x,
                                           const __nv_bfloat16* bias,
                                           unsigned ch) {
  const float xf = __bfloat162float(x);
  if (bias == nullptr) return xf;
  return md_bf16_round(__fadd_rn(xf, __bfloat162float(bias[ch])));
}

// How the 8-element kernel finds the channels of its vector
enum ChannelMap {
  kNoBias = 0,       // no bias
  kPerElement = 1,   // (i / inner) % c for each element
  kConsecutive = 2,  // inner == 1, c % 8 == 0: channels ch0 .. ch0 + 7
  kShared = 3,       // inner % 8 == 0: one channel for the vector
};

__global__ void __launch_bounds__(kThreads)
    silu_bf16_vec8_kernel(const uint4* x,
                          const __nv_bfloat16* __restrict__ bias,
                          uint4* out, unsigned n8, unsigned c,
                          unsigned inner, int map) {
  const unsigned v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n8) return;
  uint4 in = x[v];
  const __nv_bfloat16* xi = reinterpret_cast<const __nv_bfloat16*>(&in);
  uint4 res;
  __nv_bfloat16* yo = reinterpret_cast<__nv_bfloat16*>(&res);
  const unsigned i0 = v * 8u;
  if (map == kNoBias) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      yo[k] = md_silu_bf16_one(__bfloat162float(xi[k]));
  } else if (map == kConsecutive) {
    const unsigned ch0 = i0 % c;
    uint4 bv = *reinterpret_cast<const uint4*>(bias + ch0);
    const __nv_bfloat16* bk = reinterpret_cast<const __nv_bfloat16*>(&bv);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      yo[k] = md_silu_bf16_one(md_bf16_round(__fadd_rn(
          __bfloat162float(xi[k]), __bfloat162float(bk[k]))));
  } else if (map == kShared) {
    const float b = __bfloat162float(bias[(i0 / inner) % c]);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      yo[k] = md_silu_bf16_one(
          md_bf16_round(__fadd_rn(__bfloat162float(xi[k]), b)));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      yo[k] = md_silu_bf16_one(
          with_bias(xi[k], bias, ((i0 + k) / inner) % c));
  }
  out[v] = res;
}

__global__ void __launch_bounds__(kThreads)
    silu_bf16_kernel(const __nv_bfloat16* x,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* out, unsigned n, unsigned c,
                     unsigned inner) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned ch = bias ? (i / inner) % c : 0u;
  out[i] = md_silu_bf16_one(with_bias(x[i], bias, ch));
}

}  // namespace

extern "C" {

// out may alias x (in place: each thread reads its elements before it
// writes them, so x and out carry no __restrict__). bias is null or [c]
// bf16. n < 2^31.
// Launches on [stream]. Returns cudaGetLastError() (0 = launched).
int md_silu_bf16(const void* x, const void* bias, void* out, long long n,
                 int c, int inner, void* stream) {
  if (n <= 0) return 0;
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const unsigned n8 = (unsigned)(n / 8);
    int map = kPerElement;
    if (b == nullptr)
      map = kNoBias;
    else if (inner == 1 && c % 8 == 0 &&
             reinterpret_cast<uintptr_t>(bias) % 16 == 0)
      map = kConsecutive;
    else if (inner % 8 == 0)
      map = kShared;
    silu_bf16_vec8_kernel<<<(n8 + kThreads - 1) / kThreads, kThreads, 0,
                            s>>>(static_cast<const uint4*>(x), b,
                                 static_cast<uint4*>(out), n8, (unsigned)c,
                                 (unsigned)inner, map);
  } else {
    silu_bf16_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                       0, s>>>(static_cast<const __nv_bfloat16*>(x), b,
                               static_cast<__nv_bfloat16*>(out),
                               (unsigned)n, (unsigned)c, (unsigned)inner);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
