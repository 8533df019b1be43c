// Fused int8 CSP bottleneck for Hopper (sm_90a): 1x1 C->C conv, 3x3 C->C
// SAME conv, optional residual add, in one kernel.
//
// Replaces the TPU kernel megadetector_tpu/ops/pallas_bottleneck.py:
// bottleneck_chain / _kernel (its 'taps' schedule), and computes exactly
// the unfused chain of megadetector_tpu/ops/quantization.py
// (chained_conv 1x1 -> chained_conv 3x3 -> qt_add):
//
//   h1  = q(silu(conv1x1(x) * scale1 + bias1), mid_scale)
//   h2  = q(silu(conv3x3(h1) * scale2 + bias2), cv2_scale)
//   out = q(x * s_in + h2 * cv2_scale, s_in + cv2_scale)   (shortcut)
//   out = h2                                               (no shortcut)
//   q(y, s) = clamp(rint(y / s), -127, 127)
//
// x, out NHWC int8 [B, H, W, C]; w1 [C, C] and w2 [C, 3, 3, C] int8
// ([Cout, kh, kw, Cin]); C a multiple of 4; any H and W.
//
// Design. A block owns an 8 x 16 tile of output pixels of one image and
// all C output channels, 256 threads.
//   Phase 1 runs the 1x1 over the tile plus a one-pixel halo (10 x 18 =
//   180 pixels), as a 180 x C x C GEMM in 64 x 64 sub-tiles (__dp4a over
//   K staged through shared memory), and writes h1 as int8 into shared
//   memory ([180][C], padded to an odd word stride). Halo pixels outside
//   the image get h1 = 0: SAME padding pads the 3x3's input h1 with
//   zeros, not x (running the 1x1 on zero x would give
//   q(silu(bias1)) there instead).
//   Phase 2 runs the 3x3 as nine shifted taps over the h1 tile, the
//   weights of each (tap, 64 input channels) stage staged through shared
//   memory, 64 output channels at a time; each thread holds 8 pixels x 4
//   channels of int32 accumulators, then applies the epilogue and the
//   residual (reading x from global memory) and writes int8.
// h1 never reaches global memory: per bottleneck the kernel reads x (and
// its halo) and writes out, where the unfused chain also writes and
// re-reads h1 and h2. At C = 512 the h1 tile is 180 * 516 B = 93 KB of the
// 227 KB a block may use. The 1x1 is recomputed on the halo (180 / 128 =
// 1.4x of its work); like the conv kernel, the inner loop is bound by
// shared-memory loads (12 per 32 dp4a here), not by the tensor cores.
//
// Rounding follows the unfused plain version step by step (see
// int8_epilogue.cuh); the residual is x * s_in + h2 * cv2_scale with each
// product and the sum rounded separately (no FMA, -fmad=false), then an
// IEEE division by s_in + cv2_scale: bit-identical to the unfused chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"

namespace {

constexpr int kTH = 8;                         // tile rows
constexpr int kTW = 16;                        // tile columns
constexpr int kHH = kTH + 2;                   // halo rows
constexpr int kHW = kTW + 2;                   // halo columns
constexpr int kHalo = kHH * kHW;               // 180 halo pixels
constexpr int kBKW = 16;                       // K words per stage
constexpr int kLds = kBKW + 1;
constexpr int kThreads = 256;

struct BottleneckArgs {
  const int8_t* x;
  const int8_t* w1;
  const float* scale1;
  const float* bias1;
  const int8_t* w2;
  const float* scale2;
  const float* bias2;
  int8_t* out;
  float mid_scale, cv2_scale, s_in, out_scale;
  int shortcut;
  int h, w, c;
  int h1_stride;  // words per h1 pixel in shared memory (odd)
};

__global__ void __launch_bounds__(kThreads)
    bottleneck_int8_kernel(const BottleneckArgs a) {
  extern __shared__ int h1w[];  // [kHalo][h1_stride] words
  __shared__ int As[64][kLds];
  __shared__ int Bs[64][kLds];

  const int t = threadIdx.x;
  const int tx = t & 15;
  const int ty = t >> 4;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const int b = blockIdx.z;
  const int c = a.c;
  const int cw_total = c >> 2;
  const int stride = a.h1_stride;
  int8_t* h1b = reinterpret_cast<int8_t*>(h1w);
  const size_t img = (size_t)b * a.h * a.w;

  // ---- Phase 1: h1 over the tile and its halo ----
  for (int mc = 0; mc < kHalo; mc += 64) {
    const int* xrow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = mc + ty + 16 * i;
      const int iy = y0 - 1 + p / kHW;
      const int ix = x0 - 1 + p % kHW;
      const bool in = p < kHalo && iy >= 0 && iy < a.h && ix >= 0 &&
                      ix < a.w;
      xrow[i] = in ? reinterpret_cast<const int*>(
                         a.x + (img + (size_t)iy * a.w + ix) * (size_t)c)
                   : nullptr;
    }
    for (int nc = 0; nc < c; nc += 64) {
      const int* wrow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = nc + ty + 16 * i;
        wrow[i] = n < c ? reinterpret_cast<const int*>(a.w1 + (size_t)n * c)
                        : nullptr;
      }
      int acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
      for (int c0 = 0; c0 < cw_total; c0 += kBKW) {
        const int cw = c0 + tx;
        const bool cok = cw < cw_total;
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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = mc + ty + 16 * i;
        if (p >= kHalo) continue;
        const bool in = xrow[i] != nullptr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nc + tx + 16 * j;
          if (n >= c) continue;
          h1b[(size_t)p * stride * 4 + n] =
              in ? md_requant(md_silu(md_affine(acc[i][j], a.scale1[n],
                                                a.bias1[n])),
                              a.mid_scale)
                 : (int8_t)0;
        }
      }
    }
  }
  __syncthreads();

  // ---- Phase 2: 3x3 over h1, epilogue, residual ----
  // Thread (tx, ty) computes pixels (row i, column ty) for i < 8 and
  // channels nc + tx + 16 j for j < 4.
  for (int nc = 0; nc < c; nc += 64) {
    int acc[kTH][4];
#pragma unroll
    for (int i = 0; i < kTH; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    const int8_t* wrow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = nc + ty + 16 * i;
      wrow[i] = n < c ? a.w2 + (size_t)n * 9 * c : nullptr;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap - dy * 3;
      const int* arow = h1w + (dy * kHW + ty + dx) * stride;
      for (int c0 = 0; c0 < cw_total; c0 += kBKW) {
        const int cw = c0 + tx;
        const bool cok = cw < cw_total;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Bs[ty + 16 * i][tx] =
              (cok && wrow[i])
                  ? __ldg(reinterpret_cast<const int*>(
                              wrow[i] + (size_t)tap * c) + cw)
                  : 0;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kBKW; ++k) {
          int av[kTH], bv[4];
#pragma unroll
          for (int i = 0; i < kTH; ++i) av[i] = arow[i * kHW * stride + c0 + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][k];
#pragma unroll
          for (int i = 0; i < kTH; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
    const int ox = x0 + ty;
#pragma unroll
    for (int i = 0; i < kTH; ++i) {
      const int oy = y0 + i;
      if (oy >= a.h || ox >= a.w) continue;
      const size_t pix = (img + (size_t)oy * a.w + ox) * (size_t)c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nc + tx + 16 * j;
        if (n >= c) continue;
        const int8_t h2 = md_requant(
            md_silu(md_affine(acc[i][j], a.scale2[n], a.bias2[n])),
            a.cv2_scale);
        int8_t o = h2;
        if (a.shortcut) {
          const float y = __fadd_rn(
              __fmul_rn(__int2float_rn(a.x[pix + n]), a.s_in),
              __fmul_rn(__int2float_rn(h2), a.cv2_scale));
          o = md_requant(y, a.out_scale);
        }
        a.out[pix + n] = o;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on [stream]. Returns cudaGetLastError() (0 = launched), or the
// error of raising the dynamic shared memory to the h1 tile's size (it
// fits up to C = 1216).
int md_bottleneck_int8(const int8_t* x, const int8_t* w1, const float* scale1,
                       const float* bias1, float mid_scale, const int8_t* w2,
                       const float* scale2, const float* bias2,
                       float cv2_scale, float s_in, float out_scale,
                       int shortcut, int8_t* out, int batch, int h, int w,
                       int c, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  const int cw = c / 4;
  const int stride = ((cw + kBKW - 1) / kBKW) * kBKW + 1;
  const size_t dyn = (size_t)kHalo * stride * 4;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  BottleneckArgs a{x,         w1,        scale1, bias1,     w2,
                   scale2,    bias2,     out,    mid_scale, cv2_scale,
                   s_in,      out_scale, shortcut, h,       w,
                   c,         stride};
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, batch);
  bottleneck_int8_kernel<<<grid, kThreads, dyn,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
