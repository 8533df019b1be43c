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

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"

namespace {

constexpr int kBM = 64;        // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBKW = 16;       // K words (4 int8 each) per stage
constexpr int kLds = kBKW + 1; // padded shared row stride, in words
constexpr int kThreads = 256;

struct ConvArgs {
  const int8_t* x;
  const int8_t* wt;
  const float* scale;
  const float* bias;
  void* out;
  int batch, h, w, cin, cout, kh, kw, sh, sw, pt, pl, ho, wo;
  float y_scale;
  int requant;
};

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
        As[ty + 16 * i][tx] = (cok && xrow[i]) ? __ldg(xrow[i] + cw) : 0;
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
      if (a.requant) {
        static_cast<int8_t*>(a.out)[o] = md_requant(
            md_silu(md_affine(acc[i][j], a.scale[n], a.bias[n])),
            a.y_scale);
      } else {
        static_cast<int*>(a.out)[o] = acc[i][j];
      }
    }
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
  const long long m_total = (long long)batch * ho * wo;
  if (m_total <= 0 || cout <= 0) return 0;
  ConvArgs a{x,  w,  scale, bias, out, batch, h,  w_, cin, cout,
             kh, kw, sh,    sw,   pt,  pl,    ho, wo, y_scale, requant};
  const dim3 grid((unsigned)((m_total + kBM - 1) / kBM),
                  (unsigned)((cout + kBN - 1) / kBN));
  conv_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
