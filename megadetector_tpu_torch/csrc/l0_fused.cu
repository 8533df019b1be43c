// Fused YOLOv5 stem for Hopper (sm_90a): raw uint8 pixels -> /255 -> 6x6
// stride-2 conv (pad 2) -> bias -> SiLU -> bf16, in one pass.
//
// Replaces the TPU kernel megadetector_tpu/ops/pallas_l0.py _l0_kernel /
// l0_fused (with prepare_l0_weights), whose contract is l0's conv + bias +
// SiLU on images normalised to [0, 1]:
//
//   acc[b, oy, ox, n] = sum over t = (ky * 6 + kx) * 3 + c of
//                       x[b, 2*oy - 2 + ky, 2*ox - 2 + kx, c] * w[t, n]
//   out = bf16(silu(acc + bias[n]))        (f32 throughout, one rounding)
//
// x is uint8 NHWC [B, H, W, 3] (zero outside the image), w = bf16(w_l0 /
// 255) as [108, C] (the /255 folded into the weights, as on the TPU), bias
// f32 [C], out bf16 NHWC [B, H/2, W/2, C]. The TPU kernel computed the
// width-folded view ([B, H, W/4, 12] input, 216 taps of which half are
// zero, one MXU matmul per band) to fit its 128-lane tiles; none of that
// carries over. Here the stem is computed straight from the NHWC bytes
// with its 108 real taps.
//
// Rounding: a uint8 (8 significant bits) times a bf16 (8 bits) is exact in
// f32, so each tap is one exactly-rounded add, and __fmaf_rn gives the
// same bits as acc + x * w. The taps are summed in the fixed (ky, kx, c)
// order, starting from 0, then the bias is added; SiLU is y * (1 / (1 +
// expf(-y))) (int8_epilogue.cuh md_silu, PyTorch's CUDA sigmoid). The
// plain version (ops/l0_fused.py l0_fused_reference) walks the same order,
// so kernel and plain version agree bit for bit.
//
// Design: a block owns kTW = 32 output columns of R = 256 / C output rows
// (one row group) and walks kRowIters row groups, so the weights, staged
// once per block in shared memory as f32 ([108, C]), serve 4R rows. For
// each row group the block stages the input patch it needs (2R + 4 rows x
// 68 columns x 3 channels, converted to f32) in shared memory. Thread
// (ry, pq, cg) computes 4 output pixels (columns pq + 8j of row ry) x 8
// channels (8cg .. 8cg + 7): per tap 4 input loads (broadcast across cg)
// and two float4 weight loads for 32 FMAs, and one 16-byte store per pixel.
// What bounds it: the f32 FMAs on the CUDA cores (17.0 G MAC at 960x1280,
// batch 8, C = 64: about 0.51 ms at 67 TFLOP/s), against a memory bound of
// about 0.1 ms; moving the taps onto the tensor cores (wgmma, K = 108
// padded to 112) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"

namespace {

constexpr int kTW = 32;        // output columns per block
constexpr int kInCols = 2 * kTW + 4;
constexpr int kTaps = 108;
constexpr int kRowIters = 4;   // row groups per block

struct StemArgs {
  const uint8_t* x;
  const __nv_bfloat16* w;
  const float* bias;
  __nv_bfloat16* out;
  int batch, h, w_in, ho, wo, c, rows;  // rows = R, output rows per group
};

__global__ void __launch_bounds__(256) l0_fused_kernel(const StemArgs a) {
  extern __shared__ float smem[];
  float* sw = smem;                      // [108][C]
  float* sin = smem + kTaps * a.c;       // [2R + 4][kInCols][3]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int groups = a.c >> 3;
  const int cg = tid % groups;
  const int pq = (tid / groups) & 7;
  const int ry = tid / (groups * 8);
  const int b = blockIdx.z;
  const int ox0 = blockIdx.x * kTW;
  const int in_rows = 2 * a.rows + 4;

  for (int i = tid; i < kTaps * a.c; i += nthreads)
    sw[i] = __bfloat162float(a.w[i]);

  const float4* wv = reinterpret_cast<const float4*>(sw);
  const int wstride = a.c >> 2;  // float4s per tap row

  for (int it = 0; it < kRowIters; ++it) {
    const int oy0 = (blockIdx.y * kRowIters + it) * a.rows;
    if (oy0 >= a.ho) break;
    __syncthreads();  // the previous group's reads of sin are done
    const int ix0 = 2 * ox0 - 2;
    for (int i = tid; i < in_rows * kInCols * 3; i += nthreads) {
      const int r = i / (kInCols * 3);
      const int f = i - r * (kInCols * 3);
      const int iy = 2 * oy0 - 2 + r;
      const int ix = ix0 + f / 3;
      float v = 0.0f;
      if (iy >= 0 && iy < a.h && ix >= 0 && ix < a.w_in)
        v = (float)a.x[(((size_t)b * a.h + iy) * a.w_in) * 3 +
                       (size_t)ix0 * 3 + f];
      sin[i] = v;
    }
    __syncthreads();

    const int oy = oy0 + ry;
    if (ry >= a.rows || oy >= a.ho) continue;

    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[j][k] = 0.0f;

    for (int ky = 0; ky < 6; ++ky) {
      const float* row = sin + (2 * ry + ky) * (kInCols * 3);
      for (int kx = 0; kx < 6; ++kx) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const int t = (ky * 6 + kx) * 3 + ch;
          const float4 w0 = wv[t * wstride + 2 * cg];
          const float4 w1 = wv[t * wstride + 2 * cg + 1];
          const float wk[8] = {w0.x, w0.y, w0.z, w0.w,
                               w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xv = row[(2 * (pq + 8 * j) + kx) * 3 + ch];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              acc[j][k] = __fmaf_rn(xv, wk[k], acc[j][k]);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ox = ox0 + pq + 8 * j;
      if (ox >= a.wo) continue;
      uint4 packed;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float y = __fadd_rn(acc[j][k], a.bias[8 * cg + k]);
        o[k] = __float2bfloat16_rn(md_silu(y));
      }
      *reinterpret_cast<uint4*>(
          a.out + (((size_t)b * a.ho + oy) * a.wo + ox) * a.c + 8 * cg) =
          packed;
    }
  }
}

}  // namespace

extern "C" {

// x [B, H, W, 3] uint8, w [108, C] bf16, bias [C] f32, out [B, H/2, W/2, C]
// bf16, all contiguous; H and W even, C a multiple of 8 and at most 256,
// out 16-byte aligned. Launches on [stream]. Returns cudaGetLastError().
int md_l0_fused(const void* x, const void* w, const float* bias, void* out,
                int batch, int h, int w_in, int c, void* stream) {
  const int ho = h / 2, wo = w_in / 2;
  if (batch <= 0 || ho <= 0 || wo <= 0) return 0;
  int rows = 256 / c;
  if (rows < 1) rows = 1;
  StemArgs a{static_cast<const uint8_t*>(x),
             static_cast<const __nv_bfloat16*>(w), bias,
             static_cast<__nv_bfloat16*>(out), batch, h, w_in, ho, wo, c,
             rows};
  const size_t smem = sizeof(float) *
                      ((size_t)kTaps * c + (size_t)(2 * rows + 4) * kInCols * 3);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        l0_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int row_block = rows * kRowIters;
  const dim3 grid((unsigned)((wo + kTW - 1) / kTW),
                  (unsigned)((ho + row_block - 1) / row_block),
                  (unsigned)batch);
  l0_fused_kernel<<<grid, rows * c, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
