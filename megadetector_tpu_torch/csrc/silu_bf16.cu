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
// silu_bf16_backward_reference is the same chain as torch ops).
//
// What bounds it: memory, g and x read and dx written (6 bytes an
// element; db is C values), and nothing else may cost more. A kernel
// that adds each dx into per-channel shared-memory sums with float
// atomics and computes the sigmoid chain for each element takes 3.75
// times the byte bound at [8,128,240,320] on the card: at C = 128 one
// atomic instruction of a warp hits 16 addresses in 4 banks, and the
// chain (expf, an IEEE division with its slow-path call, seven
// roundings) is about 55 instructions an element, as many issue cycles
// as the bytes take. The design:
//
// - s and i depend on the bf16 value y alone. Every |y| < 2^-8 gives
//   (0.5, 0.25), every y >= 128 (1, 0) and every y <= -128 (0, 0), so a
//   table of (s, i) bf16 pairs over the 15 binades 2^-8 <= |y| < 2^7 of
//   each sign, with one entry for each side's outside, covers every y:
//   3,844 entries, 15,376 bytes. It is built once a device by
//   silu_bf16_grad_table_kernel from md_sigmoid_bf16 itself, so it is
//   exact by construction, and each block stages it into shared memory
//   with cp.async while its first loads are in flight. An element then
//   costs one shared-memory load, three multiplies and two adds with
//   their roundings (about 25 instructions, 33 with the bias sum and the
//   loop). A NaN y reads the outside entry, and dx is NaN all the same
//   (y * g is).
// - No atomics, and db the same bits on every call: each float32 sum has
//   one owner and a fixed order. With a bias and inner == 1 (channels_
//   last, the training layout: [rows, C]), a thread owns one unit of 8
//   consecutive channels (one 16-byte vector; 1 channel where C % 8 != 0
//   or a pointer is not 16-byte aligned) and walks the rows
//   bx * lanes + lane + k * gridDim.x * lanes in order, 8 float32 sums in
//   registers; the block adds its lanes in a fixed shared-memory tree
//   and writes one partial row. NCHW (inner > 1): a block walks tiles of
//   one (n, c) plane, one register sum a thread, then a fixed shuffle
//   tree, and writes one partial a tile. silu_bf16_bwd_bias_kernel adds
//   the partial rows of each channel in a fixed order (64 strided
//   slices, then a tree) and rounds once. ops/silu_bf16.py backward_plan
//   picks the partition and silu_bf16_backward_bias_sum_ordered repeats
//   it in torch ops, bit for bit.
// - Bytes in flight: each thread loads two rows (or four tile units) of
//   g and x as 16-byte vectors, evict-first, before it computes any of
//   them (four rows take 72 registers and lose a block an SM). A grid of
//   at most 528 blocks (4 of 256 threads on each of 132 SMs) stays
//   resident, so each stages the table once.
//
// Measured on an H100 SXM at 700 W (chip_smoke.py phase 25): 0.75-0.78
// of the byte bound at [8,128,240,320] with a bias, 0.80 without; small
// shapes pay the two launches and the table's staging (about 6 us a
// call at [64,64,1,1]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// ---- The backward ----

// The (s, i) table. Entry k of a sign (0 <= k < kTableHalf) holds y's
// with float bits sign | (kTableLo + (k << 16)): entry 0 every |y| below
// 2^-8 (kTableLo is the largest bf16 there), entry kTableHalf - 1 every
// |y| from 128 (kTableHi) up, NaN and infinities included. s is the high
// half of an entry, i the low half.
constexpr unsigned kTableLo = 0x3B7F0000u;
constexpr unsigned kTableHi = 0x43000000u;
constexpr unsigned kTableHalf = ((kTableHi - kTableLo) >> 16) + 1;
constexpr unsigned kTableEntries = 2 * kTableHalf;
constexpr unsigned kTableChunks = kTableEntries * 4 / 16;
static_assert(kTableEntries * 4 % 16 == 0, "16-byte chunks");

__device__ __align__(16) uint32_t g_grad_table[kTableEntries];

__global__ void __launch_bounds__(kThreads) silu_bf16_grad_table_kernel() {
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= kTableEntries) return;
  const unsigned sign = e < kTableHalf ? 0u : 0x80000000u;
  const float y = __uint_as_float(sign | (kTableLo + ((e % kTableHalf) << 16)));
  const float s = md_sigmoid_bf16(y);
  const float h = md_bf16_round(__fsub_rn(1.0f, s));
  const float i = md_bf16_round(__fmul_rn(s, h));
  g_grad_table[e] = (__float_as_uint(s) & 0xFFFF0000u) | (__float_as_uint(i) >> 16);
}

// Starts the copy of the table into [table] (shared memory);
// wait_table() completes it for the whole block
__device__ __forceinline__ void stage_table(uint32_t* table) {
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(table));
  for (unsigned k = threadIdx.x; k < kTableChunks; k += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + k * 16u),
                 "l"(g_grad_table + k * 4u));
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_table() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// bf16 halves of a 32-bit word as floats, and two floats rounded into one
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The (s, i) entry of a bf16 value y
__device__ __forceinline__ uint32_t grad_lookup(const uint32_t* table,
                                                float y) {
  const unsigned bits = __float_as_uint(y);
  const unsigned a = min(max(bits & 0x7FFFFFFFu, kTableLo), kTableHi);
  return table[((a - kTableLo) >> 16) + (bits >> 31) * kTableHalf];
}

// dx of one element, as a float holding its bf16 value: g, y bf16 values
// (y = x + b already rounded)
__device__ __forceinline__ float grad_one(const uint32_t* table, float g,
                                          float y) {
  const uint32_t t = grad_lookup(table, y);
  const float k = md_bf16_round(__fmul_rn(g, hi_f(t)));
  const float j = md_bf16_round(__fmul_rn(y, g));
  const float l = md_bf16_round(__fmul_rn(j, lo_f(t)));
  return md_bf16_round(__fadd_rn(k, l));
}

// dx of the two elements of a word of g and of x (bias b0, b1 when
// BIAS), packed; the same roundings as grad_one, two at a time
template <bool BIAS>
__device__ __forceinline__ uint32_t grad_pair(const uint32_t* table,
                                              uint32_t gw, uint32_t xw,
                                              float b0, float b1) {
  float y0 = lo_f(xw), y1 = hi_f(xw);
  if (BIAS) {
    const uint32_t yw = pack_rn(__fadd_rn(y0, b0), __fadd_rn(y1, b1));
    y0 = lo_f(yw);
    y1 = hi_f(yw);
  }
  const float g0 = lo_f(gw), g1 = hi_f(gw);
  const uint32_t t0 = grad_lookup(table, y0), t1 = grad_lookup(table, y1);
  const uint32_t kw =
      pack_rn(__fmul_rn(g0, hi_f(t0)), __fmul_rn(g1, hi_f(t1)));
  const uint32_t jw = pack_rn(__fmul_rn(y0, g0), __fmul_rn(y1, g1));
  const uint32_t lw = pack_rn(__fmul_rn(lo_f(jw), lo_f(t0)),
                              __fmul_rn(hi_f(jw), lo_f(t1)));
  return pack_rn(__fadd_rn(lo_f(kw), lo_f(lw)),
                 __fadd_rn(hi_f(kw), hi_f(lw)));
}

// A unit of W elements: one 16-byte vector (W = 8) or one element. g and
// x are read once, so their loads are marked evict-first (__ldcs)
template <int W>
struct Unit;

template <>
struct Unit<8> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, unsigned u) {
    v = __ldcs(reinterpret_cast<const uint4*>(p) + u);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p, unsigned u) const {
    reinterpret_cast<uint4*>(p)[u] = v;
  }
  __device__ __forceinline__ uint32_t word(int k) const {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
  __device__ __forceinline__ void set(int k, uint32_t w) {
    if (k == 0) v.x = w;
    else if (k == 1) v.y = w;
    else if (k == 2) v.z = w;
    else v.w = w;
  }
};

template <>
struct Unit<1> {
  unsigned short v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, unsigned u) {
    v = __ldcs(reinterpret_cast<const unsigned short*>(p) + u);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p, unsigned u) const {
    reinterpret_cast<unsigned short*>(p)[u] = v;
  }
};

// dx of a unit into [d]; the elements' dx (as rounded) in e[0 .. W)
// b[k] is element k's bias (unused without BIAS)
template <bool BIAS>
__device__ __forceinline__ void grad_unit(const uint32_t* table,
                                          const Unit<8>& g, const Unit<8>& x,
                                          const float* b, Unit<8>& d,
                                          float* e) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t w = grad_pair<BIAS>(table, g.word(k), x.word(k),
                                       BIAS ? b[2 * k] : 0.0f,
                                       BIAS ? b[2 * k + 1] : 0.0f);
    d.set(k, w);
    e[2 * k] = lo_f(w);
    e[2 * k + 1] = hi_f(w);
  }
}

template <bool BIAS>
__device__ __forceinline__ void grad_unit(const uint32_t* table,
                                          const Unit<1>& g, const Unit<1>& x,
                                          const float* b, Unit<1>& d,
                                          float* e) {
  float y = __uint_as_float(static_cast<uint32_t>(x.v) << 16);
  if (BIAS) y = md_bf16_round(__fadd_rn(y, b[0]));
  e[0] = grad_one(table, __uint_as_float(static_cast<uint32_t>(g.v) << 16),
                  y);
  d.v = static_cast<unsigned short>(__float_as_uint(e[0]) >> 16);
}

// Rows a thread of the rows kernel loads before it computes any
constexpr int kRowSteps = 2;

// With a bias and inner == 1: the tensor is [rows, c], c / W units of W
// channels a row. Thread (lane, col) of block (bx, by) (lane =
// threadIdx.x / cols) owns unit by * cols + col and walks rows
// bx * lanes + lane + k * gridDim.x * lanes for k = 0, 1, ... in order,
// kRowSteps rows loaded before any is computed; its W sums are reduced over
// the lanes by a fixed tree (at step s, lane l < s adds lane l + s,
// s from the largest power of two below lanes down to 1) and written to
// partials[bx * c + channel].
template <int W>
__global__ void __launch_bounds__(kThreads)
    silu_bf16_bwd_rows_kernel(const __nv_bfloat16* __restrict__ g,
                              const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ bias,
                              __nv_bfloat16* __restrict__ dx,
                              float* __restrict__ partials, unsigned rows,
                              unsigned c, unsigned cols, unsigned lanes) {
  __shared__ __align__(16) uint32_t table[kTableEntries];
  stage_table(table);
  const unsigned col = threadIdx.x % cols, lane = threadIdx.x / cols;
  const unsigned units = c / W;
  const unsigned unit = blockIdx.y * cols + col;
  const bool live = unit < units;
  float b[W], sum[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    sum[k] = 0.0f;
    b[k] = live ? __bfloat162float(bias[unit * W + k]) : 0.0f;
  }
  const unsigned stride = gridDim.x * lanes;
  unsigned r = blockIdx.x * lanes + lane;
  Unit<W> gv[kRowSteps], xv[kRowSteps];
  // the next kRowSteps rows of the walk, all loads issued first
  auto load = [&](unsigned r0) {
#pragma unroll
    for (int j = 0; j < kRowSteps; ++j) {
      if (live && r0 + j * stride < rows) {
        gv[j].load(g, (r0 + j * stride) * units + unit);
        xv[j].load(x, (r0 + j * stride) * units + unit);
      }
    }
  };
  load(r);
  wait_table();
  while (live && r < rows) {
#pragma unroll
    for (int j = 0; j < kRowSteps; ++j) {
      if (r + j * stride < rows) {
        Unit<W> d;
        float e[W];
        grad_unit<true>(table, gv[j], xv[j], b, d, e);
        d.store(dx, (r + j * stride) * units + unit);
#pragma unroll
        for (int k = 0; k < W; ++k) sum[k] = __fadd_rn(sum[k], e[k]);
      }
    }
    r += kRowSteps * stride;
    load(r);
  }
  // The lanes' sums: [lanes][cols * W] floats over the table's space
  __syncthreads();
  float* red = reinterpret_cast<float*>(table);
  const unsigned at = lane * cols * W + col * W;
#pragma unroll
  for (int k = 0; k < W; ++k) red[at + k] = sum[k];
  __syncthreads();
  unsigned s = 1;
  while (s < lanes) s <<= 1;
  for (s >>= 1; s > 0; s >>= 1) {
    if (lane < s && lane + s < lanes) {
#pragma unroll
      for (int k = 0; k < W; ++k)
        red[at + k] = __fadd_rn(red[at + k], red[at + s * cols * W + k]);
    }
    __syncthreads();
  }
  if (lane == 0 && live) {
#pragma unroll
    for (int k = 0; k < W; ++k)
      partials[(size_t)blockIdx.x * c + unit * W + k] = red[at + k];
  }
}

// Units a thread takes of a tile of the planes kernel
constexpr int kTileSteps = 4;
constexpr unsigned kTileUnits = kTileSteps * kThreads;

// Planes of plane_units units (W elements each): with BIAS the (n, c)
// planes of an NCHW tensor (plane p = n * c + ch, planes = N * c), else
// one plane of the whole tensor. A tile is kTileUnits units of one plane
// (segs tiles a plane); block b takes tiles b, b + gridDim.x, ... Thread
// t computes units t + j * kThreads (j < kTileSteps) of a tile, all
// loaded first, and with BIAS adds their dx in order (j, then the
// elements of a unit) in one register sum; a fixed tree (shuffles within
// each warp: lane l < s adds lane l + s for s = 16 .. 1, then the same
// over the 8 warps' sums) gives the tile's partial,
// partials[(n * segs + seg) * c + ch].
template <int W, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    silu_bf16_bwd_planes_kernel(const __nv_bfloat16* __restrict__ g,
                                const __nv_bfloat16* __restrict__ x,
                                const __nv_bfloat16* __restrict__ bias,
                                __nv_bfloat16* __restrict__ dx,
                                float* __restrict__ partials,
                                unsigned plane_units, unsigned planes,
                                unsigned c, unsigned segs) {
  __shared__ __align__(16) uint32_t table[kTableEntries];
  __shared__ float warp_sums[2][kThreads / 32];
  stage_table(table);
  const unsigned tiles = planes * segs;
  const unsigned lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  bool staged = false;
  unsigned parity = 0;
  for (unsigned tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const unsigned p = tile / segs, seg = tile - p * segs;
    const unsigned begin = seg * kTileUnits;
    const unsigned end = min(plane_units, begin + kTileUnits);
    const unsigned base = p * plane_units;
    Unit<W> gv[kTileSteps], xv[kTileSteps];
#pragma unroll
    for (int j = 0; j < kTileSteps; ++j) {
      const unsigned u = begin + threadIdx.x + j * kThreads;
      if (u < end) {
        gv[j].load(g, base + u);
        xv[j].load(x, base + u);
      }
    }
    if (!staged) {
      wait_table();
      staged = true;
    }
    float b[W];
    if (BIAS) {
      const float bc = __bfloat162float(bias[p % c]);
#pragma unroll
      for (int k = 0; k < W; ++k) b[k] = bc;
    }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kTileSteps; ++j) {
      const unsigned u = begin + threadIdx.x + j * kThreads;
      if (u < end) {
        Unit<W> d;
        float e[W];
        grad_unit<BIAS>(table, gv[j], xv[j], b, d, e);
        d.store(dx, base + u);
        if (BIAS) {
#pragma unroll
          for (int k = 0; k < W; ++k) sum = __fadd_rn(sum, e[k]);
        }
      }
    }
    if (BIAS) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        sum = __fadd_rn(sum, __shfl_down_sync(0xFFFFFFFFu, sum, s));
      if (lane == 0) warp_sums[parity][warp] = sum;
      __syncthreads();
      if (warp == 0) {
        float v = lane < kThreads / 32 ? warp_sums[parity][lane] : 0.0f;
#pragma unroll
        for (int s = kThreads / 64; s > 0; s >>= 1)
          v = __fadd_rn(v, __shfl_down_sync(0xFFFFFFFFu, v, s));
        if (lane == 0)
          partials[((size_t)(p / c) * segs + seg) * c + p % c] = v;
      }
      parity ^= 1u;
    }
  }
  if (!staged) wait_table();
}

// Threads of the bias pass: kBiasChannels channels x kBiasSlices slices
constexpr int kBiasChannels = 8;
constexpr int kBiasSlices = 64;

// db[ch] = bf16 of the partial rows' sum: slice s adds rows s,
// s + kBiasSlices, ... in order, then a fixed tree over the slices
// (slice s < t adds slice s + t, t = kBiasSlices / 2 .. 1); rounded once
__global__ void __launch_bounds__(kBiasChannels * kBiasSlices)
    silu_bf16_bwd_bias_kernel(const float* __restrict__ partials,
                              unsigned rows, unsigned c,
                              __nv_bfloat16* __restrict__ db) {
  __shared__ float red[kBiasSlices][kBiasChannels + 1];
  const unsigned cl = threadIdx.x % kBiasChannels;
  const unsigned sl = threadIdx.x / kBiasChannels;
  const unsigned ch = blockIdx.x * kBiasChannels + cl;
  float sum = 0.0f;
  if (ch < c) {
    unsigned r = sl;
    for (; r + 3 * kBiasSlices < rows; r += 4 * kBiasSlices) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = partials[(size_t)(r + k * kBiasSlices) * c + ch];
#pragma unroll
      for (int k = 0; k < 4; ++k) sum = __fadd_rn(sum, v[k]);
    }
    for (; r < rows; r += kBiasSlices)
      sum = __fadd_rn(sum, partials[(size_t)r * c + ch]);
  }
  red[sl][cl] = sum;
  __syncthreads();
  for (unsigned t = kBiasSlices / 2; t > 0; t >>= 1) {
    if (sl < t) red[sl][cl] = __fadd_rn(red[sl][cl], red[sl + t][cl]);
    __syncthreads();
  }
  if (sl == 0 && ch < c) db[ch] = __float2bfloat16_rn(red[0][cl]);
}

// Builds g_grad_table once a device, on [stream] before the first
// backward's kernels. Outside a CUDA graph capture it waits for the
// build, so that every later launch on any stream finds the table; a
// build captured into a graph runs at each replay and is built again by
// the next call outside a capture.
constexpr int kMaxDevices = 64;
std::atomic<bool> g_table_built[kMaxDevices];

cudaError_t ensure_grad_table(cudaStream_t s) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && g_table_built[dev].load()) return cudaSuccess;
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  err = cudaStreamIsCapturing(s, &status);
  if (err != cudaSuccess) return err;
  silu_bf16_grad_table_kernel<<<(kTableEntries + kThreads - 1) / kThreads,
                                kThreads, 0, s>>>();
  err = cudaGetLastError();
  if (err != cudaSuccess || status != cudaStreamCaptureStatusNone)
    return err;
  err = cudaStreamSynchronize(s);
  if (err == cudaSuccess && dev < kMaxDevices) g_table_built[dev].store(true);
  return err;
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
// [partial rows, c] float32 scratch. g, x and dx share one dense layout;
// n < 2^31. The partition is ops/silu_bf16.py backward_plan's: width 8
// (16-byte vectors; g, x, dx 16-byte aligned) or 1; with a bias and
// inner == 1 the rows kernel on a (blocks, ceil(c / width / cols)) grid
// of cols * lanes threads (partial rows: blocks), else the planes kernel
// on [blocks] blocks with [segs] tiles a plane (partial rows: n / inner
// / c * segs). Launches the table's build once a device, then one kernel
// and, with a bias, the bias pass on [stream]. Returns the first CUDA
// error (0 = launched).
int md_silu_bf16_backward(const void* g, const void* x, const void* bias,
                          void* dx, void* partials, void* db, long long n,
                          int c, int inner, int width, int blocks, int cols,
                          int lanes, int segs, void* stream) {
  if (n <= 0 || blocks <= 0) return 0;
  if ((width != 1 && width != 8) || c <= 0 || inner <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = ensure_grad_table(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* dxp = static_cast<__nv_bfloat16*>(dx);
  auto* pp = static_cast<float*>(partials);
  unsigned partial_rows = 0;
  if (b != nullptr && inner == 1) {
    if (cols <= 0 || lanes <= 0 || cols * lanes > kThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned units = (unsigned)c / width;
    const dim3 grid(blocks, (units + cols - 1) / cols);
    const unsigned rows = (unsigned)(n / c);
    if (width == 8)
      silu_bf16_bwd_rows_kernel<8><<<grid, cols * lanes, 0, s>>>(
          gp, xp, b, dxp, pp, rows, (unsigned)c, (unsigned)cols,
          (unsigned)lanes);
    else
      silu_bf16_bwd_rows_kernel<1><<<grid, cols * lanes, 0, s>>>(
          gp, xp, b, dxp, pp, rows, (unsigned)c, (unsigned)cols,
          (unsigned)lanes);
    partial_rows = (unsigned)blocks;
  } else {
    if (segs <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long plane = b ? inner : n;
    const unsigned plane_units = (unsigned)(plane / width);
    const unsigned planes = (unsigned)(n / plane);
    if (b && width == 8)
      silu_bf16_bwd_planes_kernel<8, true><<<blocks, kThreads, 0, s>>>(
          gp, xp, b, dxp, pp, plane_units, planes, (unsigned)c,
          (unsigned)segs);
    else if (b)
      silu_bf16_bwd_planes_kernel<1, true><<<blocks, kThreads, 0, s>>>(
          gp, xp, b, dxp, pp, plane_units, planes, (unsigned)c,
          (unsigned)segs);
    else if (width == 8)
      silu_bf16_bwd_planes_kernel<8, false><<<blocks, kThreads, 0, s>>>(
          gp, xp, b, dxp, pp, plane_units, planes, 1u, (unsigned)segs);
    else
      silu_bf16_bwd_planes_kernel<1, false><<<blocks, kThreads, 0, s>>>(
          gp, xp, b, dxp, pp, plane_units, planes, 1u, (unsigned)segs);
    partial_rows = planes / (unsigned)c * (unsigned)segs;
  }
  if (b != nullptr) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    silu_bf16_bwd_bias_kernel<<<(c + kBiasChannels - 1) / kBiasChannels,
                                kBiasChannels * kBiasSlices, 0, s>>>(
        pp, partial_rows, (unsigned)c, static_cast<__nv_bfloat16*>(db));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
