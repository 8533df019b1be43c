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
// VMEM row per step) does not carry over. Here the work splits in two
// passes over a bitmask mask[b][i][w] (K rows of row_words 64-bit words,
// row_words = ceil(K / 64) rounded up to even so every row starts on 16
// bytes); bit c of word w of row i is set when j = 64 w + c > i and
// IoU(i, j) > thresh.
//
//   (a) nms_mask_kernel, bounded by its K(K-1)/2 IoU tests on the CUDA
//       cores (268 M at B = 8, K = 8192: their 14 float32 operations take
//       ~0.06 ms at peak, their ~30 instructions ~0.27 ms). Only the
//       upper triangle of 256 x 256 tiles is launched: block p of an
//       image decodes its (row tile, column tile) pair from a triangular
//       index. 128 threads each hold two rows in registers (t and t +
//       128), so every column, read once from shared memory as a float4
//       plus its area (a broadcast), serves two IoU tests. Words left of
//       a row's own 64-box block are never written, and never read.
//   (b) nms_sweep_kernel, one block of 256 threads per image, chunked by
//       64-box words. removed[c] is final once chunks < c are applied:
//       thread 0 then resolves chunk c's kept set from its 64 diagonal
//       words: each row in order, if still alive, clears the rows it
//       suppresses. That is 64 steps of a bit test and a predicated
//       AND-NOT, and the 64 word loads do not depend on the chain, so
//       they run ahead of it (a walk from one lowest alive bit to the
//       next, with __ffsll, puts a shared-memory load on every step and
//       is slower: experiments/nms_sweep_breakdown.py). Then all
//       threads OR the kept rows' words w > c into removed (two threads a
//       word, each over 32 rows, atomicOr). The 64 x (row_words - c) word
//       tile of chunk c does not depend on the sweep's state, so it is
//       prefetched with cp.async into a two-stage ring in shared memory:
//       warps 1-7 issue the next unit's copies while thread 0 resolves,
//       and the copies land while the chunk is applied. A stage holds at
//       most kSegWords words a row (64 KB); a chunk whose tile is wider is
//       walked in segments of that width. The over-fetch to an even start
//       copies the word left of an odd chunk's diagonal, which is never
//       written and never used.
//
// IoU is bit-identical to the JAX formula: area = max(x1-x0,0) *
// max(y1-y0,0), inter likewise, union = area_i + area_j - inter, iou =
// RN(inter / max(union, 1e-9f)), strict '>'. Every float operation uses
// the round-to-nearest intrinsics so no FMA contraction changes the
// rounding (the build also passes -fmad=false; never --use_fast_math).
// The division is replaced by an exact predicate: with t+ the next float
// after thresh and m = (thresh + t+) / 2 (exact in double), RN(q) > thresh
// holds exactly when q > m, or q == m and t+ has an even mantissa (round
// half to even then rounds up). In double, m * u is exact (25 + 24 bits),
// so one fma gives inter - m * u with its sign exact. Most tests are
// decided without double arithmetic: float32 bounds m_lo < m < m_hi, 2^-19
// apart from m, settle every pair whose inter lies outside [uni * m_lo,
// uni * m_hi] (a float32 product is off by at most 2^-24), and only the
// rest take the exact test. The wrapper (ops/cuda_nms.py threshold_split)
// computes m, the bounds and the tie rule.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_int8.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kWord = 64;
constexpr int kTile = 256;                 // mask block: rows and columns
constexpr int kTileWords = kTile / kWord;
constexpr int kMaskThreads = 128;          // two rows a thread
constexpr int kSweepThreads = 256;
constexpr int kSegWords = 128;             // words a row in one ring stage

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// inter and max(union, 1e-9) of two boxes, in the JAX formula's roundings
__device__ __forceinline__ void inter_union(float4 a, float area_a, float4 b,
                                            float area_b, float& inter,
                                            float& uni) {
  const float ix0 = fmaxf(a.x, b.x);
  const float iy0 = fmaxf(a.y, b.y);
  const float ix1 = fminf(a.z, b.z);
  const float iy1 = fminf(a.w, b.w);
  inter = __fmul_rn(fmaxf(__fsub_rn(ix1, ix0), 0.0f),
                    fmaxf(__fsub_rn(iy1, iy0), 0.0f));
  uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
}

// RN(inter / uni) > thresh exactly: the sign of inter - m * uni in double
template <bool kTieUp>
__device__ __forceinline__ bool over_exact(float inter, float uni,
                                           double m) {
  const double d = __fma_rn(-m, (double)uni, (double)inter);
  return kTieUp ? d >= 0.0 : d > 0.0;
}

// Pair p of the n x n upper triangle of tiles (row tile r <= column tile
// c), counted row by row: counted from the end, reversed row rr = n-1-r
// holds rr + 1 tiles and starts at rr (rr + 1) / 2
__device__ __forceinline__ void triangle_tile(int p, int n, int& r, int& c) {
  const long long q = (long long)n * (n + 1) / 2 - 1 - p;
  int rr = (int)((sqrt(8.0 * (double)q + 1.0) - 1.0) * 0.5);
  while ((long long)(rr + 1) * (rr + 2) / 2 <= q) ++rr;
  while ((long long)rr * (rr + 1) / 2 > q) --rr;
  r = n - 1 - rr;
  c = n - 1 - (int)(q - (long long)rr * (rr + 1) / 2);
}

// boxes [B, K, 4] f32 xyxy; mask [B, K, row_words] u64; grid (pairs, B).
// m_hi > m and m_lo < m are float32 bounds with a 2^-19 relative margin
// (+inf / -inf where |m| is too small for one): inter > uni * m_hi proves
// an overlap and inter < uni * m_lo its absence despite the product's
// rounding, and only the rare test in between takes the exact double path.
template <bool kTieUp>
__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float* __restrict__ boxes, int k, int row_words,
                    int n_tiles, double m, float m_hi, float m_lo,
                    u64* __restrict__ mask) {
  int tile_r, tile_c;
  triangle_tile(blockIdx.x, n_tiles, tile_r, tile_c);
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const float4* img = reinterpret_cast<const float4*>(boxes) + (size_t)b * k;

  __shared__ float4 cols[kTile];
  __shared__ float col_area[kTile];
  for (int c = t; c < kTile; c += kMaskThreads) {
    const int j = tile_c * kTile + c;
    const float4 bj = j < k ? img[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    cols[c] = bj;
    col_area[c] = box_area(bj);
  }

  int row[2];
  float4 a[2];
  float area[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = tile_r * kTile + t + h * kMaskThreads;
    a[h] = row[h] < k ? img[row[h]] : make_float4(0.f, 0.f, 0.f, 0.f);
    area[h] = box_area(a[h]);
  }
  __syncthreads();

  for (int cw = 0; cw < kTileWords; ++cw) {
    const int w = tile_c * kTileWords + cw;
    if (w * kWord >= k) break;
    // A warp's 32 rows share one 64-row block, so this is warp-uniform
    bool need[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) need[h] = row[h] < k && (row[h] >> 6) <= w;
    if (!need[0] && !need[1]) continue;
    u64 bits[2] = {0ULL, 0ULL};
    u64 unsure[2] = {0ULL, 0ULL};
    const float4* cw_cols = cols + cw * kWord;
    const float* cw_area = col_area + cw * kWord;
#pragma unroll
    for (int c = 0; c < kWord; ++c) {
      const float4 bj = cw_cols[c];
      const float area_j = cw_area[c];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float inter, uni;
        inter_union(a[h], area[h], bj, area_j, inter, uni);
        const bool over = inter > __fmul_rn(uni, m_hi);
        const bool under = inter < __fmul_rn(uni, m_lo);
        bits[h] |= (u64)over << c;
        unsure[h] |= (u64)(!over && !under) << c;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      while (unsure[h]) {
        const int c = __ffsll((long long)unsure[h]) - 1;
        unsure[h] &= unsure[h] - 1ULL;
        float inter, uni;
        inter_union(a[h], area[h], cw_cols[c], cw_area[c], inter, uni);
        if (over_exact<kTieUp>(inter, uni, m)) bits[h] |= 1ULL << c;
      }
    }
    const int n_cols = k - w * kWord;
    const u64 col_mask = n_cols >= kWord ? ~0ULL : ((1ULL << n_cols) - 1ULL);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!need[h]) continue;
      u64 v = bits[h] & col_mask;
      if ((row[h] >> 6) == w) v &= (~0ULL << (row[h] & 63)) << 1;  // j > i
      mask[((size_t)b * k + row[h]) * row_words + w] = v;
    }
  }
}

// Rows c*64 .. c*64+63 (those < K), words [s0, s0 + n), into a stage with
// rows of n words (n even, s0 even: 16-byte pieces on both sides). Warps
// first_warp .. 7 issue the copies, a row a warp at a time.
__device__ __forceinline__ void sweep_prefetch(u64* stage, const u64* rows,
                                               int k, int row_words, int c,
                                               int s0, int n, int first_warp) {
  const int pieces = n >> 1;
  const int row0 = c * kWord;
  const int lane = threadIdx.x & 31;
  const uint32_t dst0 = md_smem_addr(stage);
  for (int r = (threadIdx.x >> 5) - first_warp; r < kWord;
       r += kSweepThreads / 32 - first_warp) {
    if (row0 + r >= k) break;  // rows past K are never kept: never read
    const u64* src = rows + (size_t)(row0 + r) * row_words + s0;
    for (int p = lane; p < pieces; p += 32)
      md_cp_async16(dst0 + (uint32_t)((r * n + 2 * p) * 8), src + 2 * p, 16);
  }
}

// One block per image. valid/keep are [B, K] bytes (torch.bool).
__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep_kernel(const u64* __restrict__ mask,
                     const uint8_t* __restrict__ valid, int k, int words,
                     int row_words, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) u64 sweep_smem[];
  const int seg = min(kSegWords, row_words);
  u64* removed = sweep_smem + 2 * kWord * seg;  // after the two stages
  __shared__ u64 kept_chunk;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const u64* rows = mask + (size_t)b * k * row_words;

  // The first unit's tile, then removed = ~valid (slots past K removed)
  sweep_prefetch(sweep_smem, rows, k, row_words, 0, 0, seg, 0);
  md_cp_async_commit();
  const uint8_t* v = valid + (size_t)b * k;
  for (int w = tid >> 5; w < words; w += kSweepThreads / 32) {
    const int j0 = w * kWord + lane;
    const int j1 = j0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, j0 >= k || !v[j0]);
    const unsigned hi = __ballot_sync(0xffffffffu, j1 >= k || !v[j1]);
    if (lane == 0) removed[w] = ((u64)hi << 32) | lo;
  }

  // Units (chunk c, segment start s0): s0 runs from c rounded down to
  // even, in steps of seg, while it holds a word < words
  int c = 0, s0 = 0, st = 0;
  while (true) {
    md_cp_async_wait<0>();
    __syncthreads();  // this unit's tile landed; removed is current; the
                      // other stage is free

    int nc = c, ns = s0 + seg;
    if (ns >= words) {
      nc = c + 1;
      ns = nc & ~1;
    }
    const bool more = nc < words;
    u64* next = sweep_smem + (st ^ 1) * kWord * seg;
    const int n = min(seg, row_words - s0);
    const u64* tile = sweep_smem + st * kWord * seg;
    if (s0 == (c & ~1)) {
      // Resolve chunk c (removed[c] is final) on thread 0, while warps 1-7
      // issue the next unit's copies. Each row in order, if still alive,
      // clears the later rows it suppresses; the word loads do not wait
      // on the chain. Rows past K are never alive, so their stale words
      // are never used.
      if (tid == 0) {
        const u64* diag = tile + (c - s0);
        u64 d[kWord];
#pragma unroll
        for (int r = 0; r < kWord; ++r) d[r] = diag[r * n];
        u64 kept = ~removed[c];
#pragma unroll
        for (int r = 0; r < kWord; ++r)
          if ((kept >> r) & 1ULL) kept &= ~d[r];
        removed[c] = ~kept;
        kept_chunk = kept;
      } else if (tid >= 32 && more) {
        sweep_prefetch(next, rows, k, row_words, nc, ns,
                       min(seg, row_words - ns), 1);
      }
      md_cp_async_commit();
      __syncthreads();
    } else {
      if (more)
        sweep_prefetch(next, rows, k, row_words, nc, ns,
                       min(seg, row_words - ns), 0);
      md_cp_async_commit();
    }
    const u64 kept = kept_chunk;
    if (kept) {
      // Apply: word s0 + wi (wi < seg <= 128), rows 32 * half .. + 31
      const int wi = tid & (kSegWords - 1);
      const int half = tid / kSegWords;
      const int w = s0 + wi;
      if (wi < n && w > c && w < words) {
        // All 32 rows loaded, each masked by its kept bit, so no load
        // waits on a branch (rows not kept, stale past K, add nothing)
        const unsigned bits = (unsigned)(kept >> (32 * half));
        const u64* col = tile + 32 * half * n + wi;
        u64 acc = 0ULL;
#pragma unroll
        for (int r = 0; r < 32; ++r)
          acc |= col[r * n] & (0ULL - (u64)((bits >> r) & 1u));
        if (acc) atomicOr(&removed[w], acc);
      }
    }
    if (!more) break;
    c = nc;
    s0 = ns;
    st ^= 1;
  }
  __syncthreads();

  uint8_t* out = keep + (size_t)b * k;
  for (int j = tid; j < k; j += kSweepThreads)
    out[j] = ((removed[j >> 6] >> (j & 63)) & 1ULL) ? 0 : 1;
}

}  // namespace

extern "C" {

// Launches both passes on [stream]. mask is caller-allocated scratch of
// batch * k * row_words words (row_words = ceil(k / 64) rounded up to
// even), 16-byte aligned. m and tie_up come from the threshold (see the
// note above). Returns cudaGetLastError() (0 = launched).
int md_greedy_nms(const float* boxes, const uint8_t* valid,
                  unsigned long long* mask, uint8_t* keep, int batch, int k,
                  double m, float m_hi, float m_lo, int tie_up,
                  void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + kWord - 1) / kWord;
  const int row_words = (words + 1) & ~1;
  const int n_tiles = (k + kTile - 1) / kTile;
  const dim3 grid((unsigned)(n_tiles * (n_tiles + 1) / 2), (unsigned)batch);
  if (tie_up)
    nms_mask_kernel<true><<<grid, kMaskThreads, 0, s>>>(
        boxes, k, row_words, n_tiles, m, m_hi, m_lo, mask);
  else
    nms_mask_kernel<false><<<grid, kMaskThreads, 0, s>>>(
        boxes, k, row_words, n_tiles, m, m_hi, m_lo, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int seg = row_words < kSegWords ? row_words : kSegWords;
  const size_t smem = sizeof(u64) * ((size_t)2 * kWord * seg + words);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sweep_kernel<<<batch, kSweepThreads, smem, s>>>(mask, valid, k, words,
                                                      row_words, keep);
  return static_cast<int>(cudaGetLastError());
}

const char* md_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
