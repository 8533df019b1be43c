// Greedy non-maximum suppression for Hopper (sm_90a), as a bitmask NMS.
//
// Replaces the TPU kernel megadetector_tpu/ops/pallas_nms.py:
// pallas_greedy_nms / _nms_kernel, and computes the same keep mask as
// megadetector_tpu/ops/nms.py _greedy_suppress / _fixpoint_suppress:
// boxes arrive class-offset and score-sorted descending; box i, while
// still kept, suppresses every j > i with IoU(i, j) > thresh; the
// initial keep mask is `valid`.
//
// The TPU form (one program per image, one-hot lane reductions over a
// VMEM row per step) does not carry over. Here the work splits in two:
//   (a) nms_mask_kernel: grid (K/64 column blocks, K/64 row blocks, B),
//       64 threads. Thread t of block (cb, rb) owns row i = 64*rb + t and
//       writes one 64-bit word: bit c is set when j = 64*cb + c > i and
//       IoU(i, j) > thresh. Blocks with cb < rb hold only j < i and
//       write nothing; the sweep never reads those words. This pass is
//       bounded by its K^2/2 IoU evaluations and writes B*K^2/8 bytes.
//   (b) nms_sweep_kernel: one warp per image walks i in order over a
//       `removed` bitmask in shared memory (K/64 words, 128 at K = 8192).
//       When i is kept, the warp ORs row i's words (from word i/64 on)
//       into `removed`. The serial chain is K steps; the design keeps
//       each step to one shared-memory bit test, plus one coalesced row
//       load and one word-OR per lane for a kept box.
//
// IoU is bit-identical to the JAX formula: area = max(x1-x0,0) *
// max(y1-y0,0), inter likewise, union = area_i + area_j - inter,
// iou = inter / max(union, 1e-9f), strict '>'. Every operation uses the
// round-to-nearest intrinsics so no FMA contraction changes the rounding
// (the build also passes -fmad=false; never --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;

__device__ __forceinline__ float box_area(float x0, float y0, float x1,
                                          float y1) {
  return __fmul_rn(fmaxf(__fsub_rn(x1, x0), 0.0f),
                   fmaxf(__fsub_rn(y1, y0), 0.0f));
}

__device__ __forceinline__ float iou_xyxy(float ax0, float ay0, float ax1,
                                          float ay1, float area_a,
                                          float bx0, float by0, float bx1,
                                          float by1, float area_b) {
  const float ix0 = fmaxf(ax0, bx0);
  const float iy0 = fmaxf(ay0, by0);
  const float ix1 = fminf(ax1, bx1);
  const float iy1 = fminf(ay1, by1);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix1, ix0), 0.0f),
                                fmaxf(__fsub_rn(iy1, iy0), 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

// boxes [B, K, 4] f32 xyxy; mask [B, K, words] u64
__global__ void nms_mask_kernel(const float* __restrict__ boxes, int k,
                                int words, float thresh,
                                unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  if (col_block < row_block) return;  // only j < i here: never read
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const float* img = boxes + (size_t)b * k * 4;

  __shared__ float cols[kBlock * 4];
  __shared__ float col_area[kBlock];
  const int j = col_block * kBlock + t;
  if (j < k) {
    const float4 bj = reinterpret_cast<const float4*>(img)[j];
    cols[t * 4 + 0] = bj.x;
    cols[t * 4 + 1] = bj.y;
    cols[t * 4 + 2] = bj.z;
    cols[t * 4 + 3] = bj.w;
    col_area[t] = box_area(bj.x, bj.y, bj.z, bj.w);
  }
  __syncthreads();

  const int i = row_block * kBlock + t;
  if (i >= k) return;
  const float4 bi = reinterpret_cast<const float4*>(img)[i];
  const float area_i = box_area(bi.x, bi.y, bi.z, bi.w);
  const int n_cols = min(kBlock, k - col_block * kBlock);
  const int start = (col_block == row_block) ? t + 1 : 0;
  unsigned long long bits = 0ULL;
  for (int c = start; c < n_cols; ++c) {
    const float iou = iou_xyxy(bi.x, bi.y, bi.z, bi.w, area_i,
                               cols[c * 4 + 0], cols[c * 4 + 1],
                               cols[c * 4 + 2], cols[c * 4 + 3],
                               col_area[c]);
    if (iou > thresh) bits |= 1ULL << c;
  }
  mask[((size_t)b * k + i) * words + col_block] = bits;
}

// One warp per image. valid/keep are [B, K] bytes (torch.bool).
__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ valid, int k,
                                 int words, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned full = 0xffffffffu;
  const uint8_t* v = valid + (size_t)b * k;

  // removed starts as ~valid (slots past K count as removed)
  for (int w = 0; w < words; ++w) {
    const int j0 = w * kBlock + lane;
    const int j1 = j0 + 32;
    const unsigned lo = __ballot_sync(full, j0 >= k || !v[j0]);
    const unsigned hi = __ballot_sync(full, j1 >= k || !v[j1]);
    if (lane == 0) {
      removed[w] = ((unsigned long long)hi << 32) | lo;
    }
  }
  __syncwarp();

  const unsigned long long* rows = mask + (size_t)b * k * words;
  for (int i = 0; i < k; ++i) {
    const int wi = i >> 6;
    const bool alive = !((removed[wi] >> (i & 63)) & 1ULL);
    // every lane has read bit i before any lane writes word wi
    __syncwarp();
    if (alive) {
      const unsigned long long* row = rows + (size_t)i * words;
      for (int w = wi + lane; w < words; w += 32) {
        removed[w] |= row[w];
      }
    }
    __syncwarp();
  }

  uint8_t* out = keep + (size_t)b * k;
  for (int j = lane; j < k; j += 32) {
    out[j] = ((removed[j >> 6] >> (j & 63)) & 1ULL) ? 0 : 1;
  }
}

}  // namespace

extern "C" {

// Launches both passes on [stream]. mask is caller-allocated scratch of
// batch * k * ceil(k/64) words. Returns cudaGetLastError() (0 = launched).
int md_greedy_nms(const float* boxes, const uint8_t* valid,
                  unsigned long long* mask, uint8_t* keep, int batch, int k,
                  float thresh, void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + kBlock - 1) / kBlock;
  const dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(boxes, k, words, thresh, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<batch, 32, words * sizeof(unsigned long long), s>>>(
      mask, valid, k, words, keep);
  return static_cast<int>(cudaGetLastError());
}

const char* md_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
