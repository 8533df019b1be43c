// int8 implicit-GEMM convolution with the int8 chain's epilogue, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel megadetector_tpu/ops/pallas_conv.py:
// conv3x3_chain / _kernel (the 3x3 stride-1 SAME instance) and also runs
// every other conv of the int8 activation chain (1x1, 3x3 stride 2), i.e.
// megadetector_tpu/ops/quantization.py chained_conv's XLA branch:
//
//   acc[m, n] = sum_{ky, kx, ci} x[b, oy*sh - pt + ky, ox*sw - pl + kx, ci]
//                                * w[n, ky, kx, ci]        (int8 -> int32)
//   requant 0: out = acc                                   (int32)
//   requant 1: out = q(silu(acc * scale[n] + bias[n]))     (int8)
//   q(y)   = clamp(rint(y / y_scale), -127, 127)
//
// Layouts: x NHWC int8, w [Cout, kh, kw, Cin] int8 (contiguous over Cin),
// out NHWC. Cin must be a multiple of 4 (one 32-bit word holds four
// channels of one tap); any H, W, Cout. Zero padding is exact because the
// symmetric int8 zero point is 0.
//
// Design: GEMM with M = B*Ho*Wo pixels, N = Cout, K = kh*kw*Cin. A block
// computes a 64-pixel x 64-channel tile with 256 threads, 4 x 4 outputs
// each, accumulating __dp4a (four int8 products into int32) over K in
// stages of 64 bytes staged through shared memory: tap by tap, Cin in
// chunks, so the input coordinates are computed once per tap, not per
// element. Each stage costs 8 shared loads per 16 dp4a for a thread, so
// shared-memory bandwidth bounds it, not the int8 tensor cores (a later
// mma/wgmma kernel's job). The int32 accumulators never leave registers:
// the float epilogue is fused, as the TPU kernel fused it in VMEM.
//
// Float rounding matches the plain PyTorch version (and jnp) step by
// step: int -> float, *scale, +bias each rounded (__fmul_rn/__fadd_rn;
// the build also passes -fmad=false), SiLU as y * (1 / (1 + expf(-y))),
// PyTorch's CUDA sigmoid, the requant as an IEEE division (not a
// reciprocal multiply) and rintf (round half to even, like jnp.round and
// torch.round).
//
// The same tile loop, as a template, also replaces the int8 experiments'
// 3x3 conv kernels (md_conv3x3_int8_exp), which compute other functions
// than the chain conv:
//   experiments/exp_pallas_conv3x3.py  _conv3x3_kernel (E1)
//   experiments/exp_pallas_conv3x3b.py _conv_kernel    (E2)
//   experiments/exp_pallas_conv3x3c.py _conv_kernel    (E3)
//   experiments/exp_pallas_conv3x3d.py _kernel         (E4)
// Their rank3 / flat / im2col modes and band heights are TPU schedules of
// one function: a 3x3 stride-1 SAME conv of rq(x), with
//   rq(x) = clamp(rint(f32(x) * f32(in_ratio)), -127, 127)
// applied to each staged x word on its way into shared memory (skipped at
// in_ratio 1; rq(0) = 0 keeps the zero padding exact), and one of four
// epilogues, each ending in md_requant_mul (a multiply by f32(1/y_scale),
// as the experiments requantize):
//   f32         q(silu(acc * scale + bias))                 (E1-E4)
//   f32_nosilu  q(acc * scale + bias)                       (E2)
//   bf16        a = bf16(f32(acc)), y = bf16(bf16(a * bf16(scale))
//               + bf16(bias)), q(y * bf16(1 / d(y)))        (E3, E4)
//   hybrid      y = acc * scale + bias (f32),
//               q(y * (1 / d(bf16(y))))                     (E4)
// with d(y) = bf16(1 + bf16(exp(-y))), rounded at E7's points
// (bf16_epilogue.cuh), and the final product in f32: the JAX bodies
// convert it (and, in hybrid, the sigmoid) to f32 at once, and XLA drops
// the bf16 rounding before such a convert. s32 -> bf16 goes through f32
// (two roundings), as XLA converts it; a single rounding
// (__int2bfloat16_rn) differs above 2^24. The f32 affine keeps two
// roundings, as the chain's does (XLA on the CPU contracts it into one
// FMA, which moves the int8 result by 1 on rare elements). The input
// requant costs about 25 instructions per staged word, paid again for
// each tap and each block of 64 output channels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_epilogue.cuh"
#include "int8_epilogue.cuh"

namespace {

constexpr int kBM = 64;        // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBKW = 16;       // K words (4 int8 each) per stage
constexpr int kLds = kBKW + 1; // padded shared row stride, in words
constexpr int kThreads = 256;

// Epilogue kinds; kChain is the int8 chain's (int32 out when
// requant == 0), the others the experiments' (ops/conv_int8.py
// EXP_EPILOGUES holds the same codes)
enum Epilogue { kChain = 0, kF32 = 1, kF32NoSilu = 2, kBf16 = 3, kHybrid = 4 };

struct ConvArgs {
  const int8_t* x;
  const int8_t* wt;
  const float* scale;
  const float* bias;
  void* out;
  int batch, h, w, cin, cout, kh, kw, sh, sw, pt, pl, ho, wo;
  float y_scale;
  int requant;
  float in_ratio;  // kRequantIn only
  float inv_y;     // the experiments' epilogues only
};

// The experiments' epilogue of one int32 accumulator
template <int kEpi>
__device__ __forceinline__ int8_t exp_epilogue(int acc, float scale,
                                               float bias, float inv_y) {
  float y;
  if constexpr (kEpi == kBf16) {
    const float a = md_bf16_round(__int2float_rn(acc));
    y = md_bf16_round(__fmul_rn(a, md_bf16_round(scale)));
    y = md_bf16_round(__fadd_rn(y, md_bf16_round(bias)));
    y = __fmul_rn(y, md_sigmoid_bf16(y));
  } else {
    y = md_affine(acc, scale, bias);
    if constexpr (kEpi == kF32) {
      y = md_silu(y);
    } else if constexpr (kEpi == kHybrid) {
      y = __fmul_rn(y, __fdiv_rn(1.0f, md_sigmoid_denominator_bf16(
                               md_bf16_round(y))));
    }
  }
  return md_requant_mul(y, inv_y);
}

template <bool kRequantIn, int kEpi>
__global__ void __launch_bounds__(kThreads)
    conv_int8_kernel(const ConvArgs a) {
  __shared__ int As[kBM][kLds];
  __shared__ int Bs[kBN][kLds];

  const int t = threadIdx.x;
  const int tx = t & 15;  // compute: channels tx + 16 j; load: word
  const int ty = t >> 4;  // compute and load: rows ty + 16 i
  const long long m_total = (long long)a.batch * a.ho * a.wo;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int cin_words = a.cin >> 2;
  const int taps = a.kh * a.kw;

  // The four output pixels whose A rows this thread loads
  int pb[4], piy[4], pix[4];
  bool pok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    pok[i] = m < m_total;
    const long long mm = pok[i] ? m : 0;
    const int hw = a.ho * a.wo;
    pb[i] = (int)(mm / hw);
    const int rem = (int)(mm - (long long)pb[i] * hw);
    piy[i] = (rem / a.wo) * a.sh - a.pt;
    pix[i] = (rem % a.wo) * a.sw - a.pl;
  }

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int tap = 0; tap < taps; ++tap) {
    const int ky = tap / a.kw;
    const int kx = tap - ky * a.kw;
    const int* xrow[4];
    const int* wrow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = piy[i] + ky;
      const int ix = pix[i] + kx;
      const bool in = pok[i] && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
      xrow[i] = in ? reinterpret_cast<const int*>(
                         a.x + (((size_t)pb[i] * a.h + iy) * a.w + ix) *
                                   (size_t)a.cin)
                   : nullptr;
      const int n = n0 + ty + 16 * i;
      wrow[i] = n < a.cout ? reinterpret_cast<const int*>(
                                 a.wt + ((size_t)n * taps + tap) *
                                           (size_t)a.cin)
                           : nullptr;
    }
    for (int c0 = 0; c0 < cin_words; c0 += kBKW) {
      const int cw = c0 + tx;
      const bool cok = cw < cin_words;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kRequantIn) {
          As[ty + 16 * i][tx] = (cok && xrow[i])
                                    ? md_requant_x4(__ldg(xrow[i] + cw),
                                                    a.in_ratio)
                                    : 0;
        } else {
          As[ty + 16 * i][tx] = (cok && xrow[i]) ? __ldg(xrow[i] + cw) : 0;
        }
        Bs[ty + 16 * i][tx] = (cok && wrow[i]) ? __ldg(wrow[i] + cw) : 0;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBKW; ++k) {
        int av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= a.cout) continue;
      const size_t o = (size_t)m * a.cout + n;
      if constexpr (kEpi != kChain) {
        static_cast<int8_t*>(a.out)[o] =
            exp_epilogue<kEpi>(acc[i][j], a.scale[n], a.bias[n], a.inv_y);
      } else if (a.requant) {
        static_cast<int8_t*>(a.out)[o] = md_requant(
            md_silu(md_affine(acc[i][j], a.scale[n], a.bias[n])),
            a.y_scale);
      } else {
        static_cast<int*>(a.out)[o] = acc[i][j];
      }
    }
  }
}

template <bool kRequantIn, int kEpi>
int launch(const ConvArgs& a, cudaStream_t stream) {
  const long long m_total = (long long)a.batch * a.ho * a.wo;
  if (m_total <= 0 || a.cout <= 0) return 0;
  const dim3 grid((unsigned)((m_total + kBM - 1) / kBM),
                  (unsigned)((a.cout + kBN - 1) / kBN));
  conv_int8_kernel<kRequantIn, kEpi><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRequantIn>
int launch_exp(const ConvArgs& a, int epilogue, cudaStream_t stream) {
  switch (epilogue) {
    case kF32: return launch<kRequantIn, kF32>(a, stream);
    case kF32NoSilu: return launch<kRequantIn, kF32NoSilu>(a, stream);
    case kBf16: return launch<kRequantIn, kBf16>(a, stream);
    case kHybrid: return launch<kRequantIn, kHybrid>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on [stream]. Returns cudaGetLastError() (0 = launched).
int md_conv_int8(const int8_t* x, const int8_t* w, const float* scale,
                 const float* bias, void* out, int batch, int h, int w_,
                 int cin, int cout, int kh, int kw, int sh, int sw, int pt,
                 int pl, int ho, int wo, float y_scale, int requant,
                 void* stream) {
  ConvArgs a{x,  w,  scale,   bias,    out,  batch, h,  w_, cin, cout,
             kh, kw, sh,      sw,      pt,   pl,    ho, wo, y_scale,
             requant, 1.0f, 1.0f};
  return launch<false, kChain>(a, static_cast<cudaStream_t>(stream));
}

// The experiments' conv: 3x3, stride 1, SAME (pads 1), int8 out.
// requant_in != 0 requantizes x at in_ratio on the way in; inv_y is
// f32(1 / y_scale); epilogue is kF32, kF32NoSilu, kBf16 or kHybrid.
// Launches on [stream]. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an unknown epilogue.
int md_conv3x3_int8_exp(const int8_t* x, const int8_t* w, const float* scale,
                        const float* bias, void* out, int batch, int h,
                        int w_, int cin, int cout, int requant_in,
                        float in_ratio, float inv_y, int epilogue,
                        void* stream) {
  ConvArgs a{x,  w, scale, bias, out, batch, h, w_, cin, cout, 3,
             3,  1, 1,     1,    1,   h,     w_, 0.0f, 1,   in_ratio,
             inv_y};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return requant_in ? launch_exp<true>(a, epilogue, s)
                    : launch_exp<false>(a, epilogue, s);
}

}  // extern "C"
