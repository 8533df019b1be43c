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
//
// The backward (md_silu_bf16_backward), for bf16 training: the VJP that
// JAX takes of y * sigmoid(y), y = x + b, which XLA differentiates in the
// TPU program (there is no Pallas kernel for it):
//
//   y  = bf16(x + b)                 (recomputed from the saved x and b)
//   s  = sigmoid(y) as above
//   i  = bf16(s * bf16(1 - s))       logistic's JVP
//   dx = bf16(bf16(g * s) + bf16(bf16(y * g) * i))
//   db = bf16(sum over N, H, W of dx, in float32)
//
// rounded where the JAX graph rounds (ops/silu_bf16.py
// silu_bf16_backward_reference is the same chain as torch ops). What bounds
// it: memory again, g and x read and dx written (6 bytes an element); db
// is C values. Each block walks the tensor grid-stride with the forward's
// vectors and channel maps, writes dx and adds each dx (as rounded) into
// per-channel float32 sums in shared memory; at its end it writes its sums
// to its row of [blocks, C] partials, and a second small kernel adds the
// rows in order per channel and rounds once. Shared-memory atomics make
// the order of a block's float32 sum vary from run to run, so db may
// differ from the plain version's by one bf16 step where a sum lies at a
// rounding boundary; dx is exact.

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

// dx of one element: g, x as floats (bf16 values), b the bias (0 without)
__device__ __forceinline__ __nv_bfloat16 silu_bf16_grad_one(
    float g, float x, const float* b) {
  const float y = b ? md_bf16_round(__fadd_rn(x, *b)) : x;
  const float s = md_sigmoid_bf16(y);
  const float h = md_bf16_round(__fsub_rn(1.0f, s));
  const float i = md_bf16_round(__fmul_rn(s, h));
  const float k = md_bf16_round(__fmul_rn(g, s));
  const float j = md_bf16_round(__fmul_rn(y, g));
  const float l = md_bf16_round(__fmul_rn(j, i));
  return __float2bfloat16_rn(__fadd_rn(k, l));
}

// One pass: dx, and (with a bias) the block's per-channel sums of dx in
// dynamic shared memory, written to partials[blockIdx.x * c + ch]. VEC:
// 16-byte vectors of 8 elements (n8 of them), with the forward's channel
// maps; else one element a thread.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    silu_bf16_bwd_kernel(const __nv_bfloat16* __restrict__ g,
                         const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ dx,
                         float* __restrict__ partials, unsigned units,
                         unsigned c, unsigned inner, int map) {
  extern __shared__ float sums[];
  if (bias) {
    for (unsigned ch = threadIdx.x; ch < c; ch += kThreads) sums[ch] = 0.0f;
    __syncthreads();
  }
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned u = blockIdx.x * kThreads + threadIdx.x; u < units;
       u += stride) {
    if (!VEC) {
      const unsigned ch = bias ? (u / inner) % c : 0u;
      const float b = bias ? __bfloat162float(bias[ch]) : 0.0f;
      const __nv_bfloat16 d =
          silu_bf16_grad_one(__bfloat162float(g[u]), __bfloat162float(x[u]),
                             bias ? &b : nullptr);
      dx[u] = d;
      if (bias) atomicAdd(&sums[ch], __bfloat162float(d));
      continue;
    }
    const uint4 gv = reinterpret_cast<const uint4*>(g)[u];
    const uint4 xv = reinterpret_cast<const uint4*>(x)[u];
    const __nv_bfloat16* gk = reinterpret_cast<const __nv_bfloat16*>(&gv);
    const __nv_bfloat16* xk = reinterpret_cast<const __nv_bfloat16*>(&xv);
    uint4 res;
    __nv_bfloat16* dk = reinterpret_cast<__nv_bfloat16*>(&res);
    const unsigned i0 = u * 8u;
    if (map == kNoBias) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dk[k] = silu_bf16_grad_one(__bfloat162float(gk[k]),
                                   __bfloat162float(xk[k]), nullptr);
    } else if (map == kShared) {
      const unsigned ch = (i0 / inner) % c;
      const float b = __bfloat162float(bias[ch]);
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        dk[k] = silu_bf16_grad_one(__bfloat162float(gk[k]),
                                   __bfloat162float(xk[k]), &b);
        sum = __fadd_rn(sum, __bfloat162float(dk[k]));
      }
      atomicAdd(&sums[ch], sum);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const unsigned ch =
            map == kConsecutive ? (i0 % c) + k : ((i0 + k) / inner) % c;
        const float b = __bfloat162float(bias[ch]);
        dk[k] = silu_bf16_grad_one(__bfloat162float(gk[k]),
                                   __bfloat162float(xk[k]), &b);
        atomicAdd(&sums[ch], __bfloat162float(dk[k]));
      }
    }
    reinterpret_cast<uint4*>(dx)[u] = res;
  }
  if (bias) {
    __syncthreads();
    for (unsigned ch = threadIdx.x; ch < c; ch += kThreads)
      partials[(size_t)blockIdx.x * c + ch] = sums[ch];
  }
}

// db[ch] = bf16(sum of the blocks' partial sums, in block order)
__global__ void __launch_bounds__(kThreads)
    silu_bf16_bwd_bias_kernel(const float* __restrict__ partials,
                              unsigned blocks, unsigned c,
                              __nv_bfloat16* __restrict__ db) {
  const unsigned ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= c) return;
  float sum = 0.0f;
  for (unsigned b = 0; b < blocks; ++b)
    sum = __fadd_rn(sum, partials[(size_t)b * c + ch]);
  db[ch] = __float2bfloat16_rn(sum);
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

// Backward of md_silu_bf16 at the output gradient g: dx (x's layout, may
// not alias g or x) and, with a bias, db [c] bf16 through partials
// [blocks, c] float32 scratch. g, x and dx share one dense layout; n <
// 2^31; c * 4 bytes of shared memory (at most 48 KB). Launches two kernels
// on [stream] (one without a bias). Returns cudaGetLastError().
int md_silu_bf16_backward(const void* g, const void* x, const void* bias,
                          void* dx, void* partials, void* db, long long n,
                          int c, int inner, int blocks, void* stream) {
  if (n <= 0 || blocks <= 0) return 0;
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const size_t smem = b ? (size_t)c * sizeof(float) : 0;
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* dxp = static_cast<__nv_bfloat16*>(dx);
  auto* pp = static_cast<float*>(partials);
  if (vec) {
    int map = kPerElement;
    if (b == nullptr)
      map = kNoBias;
    else if (inner == 1 && c % 8 == 0)
      map = kConsecutive;
    else if (inner % 8 == 0)
      map = kShared;
    silu_bf16_bwd_kernel<true><<<blocks, kThreads, smem, s>>>(
        gp, xp, b, dxp, pp, (unsigned)(n / 8), (unsigned)c, (unsigned)inner,
        map);
  } else {
    silu_bf16_bwd_kernel<false><<<blocks, kThreads, smem, s>>>(
        gp, xp, b, dxp, pp, (unsigned)n, (unsigned)c, (unsigned)inner,
        kPerElement);
  }
  if (b != nullptr) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    silu_bf16_bwd_bias_kernel<<<(c + kThreads - 1) / kThreads, kThreads, 0,
                                s>>>(pp, (unsigned)blocks, (unsigned)c,
                                     static_cast<__nv_bfloat16*>(db));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
