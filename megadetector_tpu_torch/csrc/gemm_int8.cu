// int8 GEMM for Hopper (sm_90a): [M, K] s8 @ [K, N] s8 -> [M, N] s32, or
// s8 through a fixed-scale requant.
//
// Replaces the TPU kernels of the int8 GEMM experiments:
//   experiments/exp_pallas_int8_chain.py  _mm_kernel, _mm_kernel_fused (E5)
//   experiments/exp_pallas_int8_matmul.py _mm_kernel, _mm_kernel_acc   (E6)
// Full-K blocks and the k-loop with a VMEM accumulator are TPU schedules
// of one function; the fused kernel adds
//   out = clamp(rint(f32(acc) * scale), -127, 127)   (int8)
// with scale the float32 requant scale (3e-4 in E5), a multiply, as the
// experiment computes it. int -> float is __int2float_rn (|acc| passes
// 2^24 for K >= 1152, so the conversion rounds, as XLA's does).
//
// Layouts: a and b row-major, as the TPU kernels take them. Any M, N, K.
//
// Design: the int8 tensor cores through mma.sync m16n8k32 (s8 x s8 ->
// s32), not yet wgmma. A block of 8 warps computes a 128 x 128 output
// tile, each warp 64 x 32 (4 x 4 mma tiles, 64 accumulators a thread),
// over K in stages of 64 bytes staged through shared memory; the next
// stage's global loads are issued before the current stage's mma, into
// registers. mma's B operand wants four consecutive k of one column in a
// word, and b is [K, N] row-major, so each stage transposes b's 64 x 128
// byte tile on the way into shared memory: a thread loads one word (four
// n) from each of four consecutive k rows and regroups the 16 bytes with
// __byte_perm into four words of four k (one per n). Nothing is packed
// outside the call. Shared rows are padded to 20 words, so the fragment
// loads (8 rows x 4 words a warp) hit 32 distinct banks. When K and N are
// multiples of 4 and a and b are 4-byte aligned, global loads are 32-bit
// words; otherwise bytes, masked at every edge (zeros add nothing).
// What bounds it: the int8 tensor cores' rate (or, for thin N, the s32
// output's bytes) is the floor; this kernel sits well above it, limited
// by shared-memory traffic (the staging stores and fragment loads, about
// three wavefronts per mma) and by one stage in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"

namespace {

constexpr int kBM = 128;        // output rows per block
constexpr int kBN = 128;        // output columns per block
constexpr int kBKW = 16;        // K words (4 int8 each) per stage
constexpr int kLds = kBKW + 4;  // padded shared row stride, in words
constexpr int kThreads = 256;

struct GemmArgs {
  const int8_t* a;
  const int8_t* b;
  void* out;
  int m, n, k;
  int requant;
  float scale;
};

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) |
         ((b3 & 0xff) << 24);
}

// Four int8 at p (the first always in range; [left] of them valid)
template <bool kVec>
__device__ __forceinline__ int load_word(const int8_t* p, int left) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const int*>(p));
  } else {
    return pack4(p[0], left > 1 ? p[1] : 0, left > 2 ? p[2] : 0,
                 left > 3 ? p[3] : 0);
  }
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    gemm_int8_kernel(const GemmArgs g) {
  __shared__ int As[kBM][kLds];
  __shared__ int Bs[kBN][kLds];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int k_words = (g.k + 3) >> 2;

  // A staging: rows (t >> 4) + 16 i, word t & 15
  const int a_word = t & 15;
  // B staging, two units: K word kq[u] and column quad nq[u] (a warp
  // covers 4 K words x 8 quads, so its loads read 32-byte row segments)
  int kq[2], nq[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int combo = warp + 8 * u;
    kq[u] = 4 * (combo & 3) + (lane & 3);
    nq[u] = 8 * (combo >> 2) + (lane >> 2);
  }

  int a_reg[8], b_reg[2][4];
  auto load_stage = [&](int kw0) {
    const int kw = kw0 + a_word;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long row = m0 + (t >> 4) + 16 * i;
      a_reg[i] = (row < g.m && kw < k_words)
                     ? load_word<kVec>(g.a + row * g.k + 4 * kw,
                                       g.k - 4 * kw)
                     : 0;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kb = 4 * (kw0 + kq[u]);
      const int nb = n0 + 4 * nq[u];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        b_reg[u][r] = (kb + r < g.k && nb < g.n)
                          ? load_word<kVec>(g.b + (long long)(kb + r) * g.n +
                                                nb,
                                            g.n - nb)
                          : 0;
      }
    }
  };

  // Warp tile: rows wm .. wm + 63, columns wn .. wn + 31
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const int gq = lane >> 2;  // fragment row (A, C) or column (B)
  const int tq = lane & 3;   // fragment K word (A, B) or column pair (C)

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

  load_stage(0);
  for (int kw0 = 0; kw0 < k_words; kw0 += kBKW) {
#pragma unroll
    for (int i = 0; i < 8; ++i) As[(t >> 4) + 16 * i][a_word] = a_reg[i];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      // b_reg[u][r] byte c = b[k r][n c]; column c's word wants byte r
      const int* w = b_reg[u];
      const int lo01 = __byte_perm(w[0], w[1], 0x5140);  // c 0, 1; k 0, 1
      const int hi01 = __byte_perm(w[0], w[1], 0x7362);  // c 2, 3; k 0, 1
      const int lo23 = __byte_perm(w[2], w[3], 0x5140);
      const int hi23 = __byte_perm(w[2], w[3], 0x7362);
      Bs[4 * nq[u] + 0][kq[u]] = __byte_perm(lo01, lo23, 0x5410);
      Bs[4 * nq[u] + 1][kq[u]] = __byte_perm(lo01, lo23, 0x7632);
      Bs[4 * nq[u] + 2][kq[u]] = __byte_perm(hi01, hi23, 0x5410);
      Bs[4 * nq[u] + 3][kq[u]] = __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();
    if (kw0 + kBKW < k_words) load_stage(kw0 + kBKW);
#pragma unroll
    for (int ks = 0; ks < kBKW; ks += 8) {
      int af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + 16 * mi + gq;
        af[mi][0] = As[r][ks + tq];
        af[mi][1] = As[r + 8][ks + tq];
        af[mi][2] = As[r][ks + 4 + tq];
        af[mi][3] = As[r + 8][ks + 4 + tq];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + 8 * ni + gq;
        bf[ni][0] = Bs[c][ks + tq];
        bf[ni][1] = Bs[c][ks + 4 + tq];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // acc[mi][ni][2 h + q]: row wm + 16 mi + gq + 8 h, column
  // wn + 8 ni + 2 tq + q
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm + 16 * mi + gq + 8 * h;
      if (row >= g.m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = n0 + wn + 8 * ni + 2 * tq + q;
          if (col >= g.n) continue;
          const long long o = row * g.n + col;
          const int v = acc[mi][ni][2 * h + q];
          if (g.requant) {
            static_cast<int8_t*>(g.out)[o] =
                md_requant_mul(__int2float_rn(v), g.scale);
          } else {
            static_cast<int*>(g.out)[o] = v;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// out: [m, n] int32 (requant == 0) or int8 at clamp(rint(f32(acc) *
// scale)). Launches on [stream]. Returns cudaGetLastError() (0 =
// launched).
int md_gemm_int8(const int8_t* a, const int8_t* b, void* out, int m, int n,
                 int k, int requant, float scale, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  GemmArgs g{a, b, out, m, n, k, requant, scale};
  const bool vec = k % 4 == 0 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 4 == 0;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM),
                  (unsigned)((n + kBN - 1) / kBN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    gemm_int8_kernel<true><<<grid, kThreads, 0, s>>>(g);
  } else {
    gemm_int8_kernel<false><<<grid, kThreads, 0, s>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
