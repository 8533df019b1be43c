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
// Design. int8 wgmma reads both operands K-major from shared memory (its
// transpose bits exist for 16-bit types only), and b arrives [K, N]. So a
// call runs up to three kernels on its stream:
//   1. transpose_kernel writes bt [N, Kp] = b^T, K zero-padded to Kp (K
//      rounded up to 16, at least 16), into scratch the caller allocates
//      (1.3 MB at E5's 1152 x 1152: about 1 % of the GEMM's bytes);
//   2. pad_kernel copies a into a zero-padded [M, Kp] scratch, only when
//      TMA cannot read a in place (K % 16 != 0: its row stride must be a
//      multiple of 16 bytes; or a base that is not 16-byte aligned);
//   3. gemm_int8_kernel, persistent and warp-specialised. A block (384
//      threads, one an SM: it uses 213 KB of shared memory) walks the
//      128 x 128 output tiles in the order tile = blockIdx.x + i *
//      gridDim.x, tile -> (row band tile / tiles_n, column tile %
//      tiles_n): the N index varies fastest, so the blocks in flight
//      share a few A row panels (E5's 128 x 1152 panel serves 9 tiles
//      from L2).
//      - Warpgroup 0 is the producer (setmaxnreg 40). One thread issues,
//        for each 128-byte K stage of each tile, two TMA loads
//        (cp.async.bulk.tensor) into a ring of 6 stages of 32 KB in
//        dynamic shared memory: A's box [128 rows x 128 K bytes] and bt's
//        [128 rows x 128 K bytes], both CU_TENSOR_MAP_SWIZZLE_128B, i.e.
//        the 128-byte swizzled K-major layout md_smem_desc<128> describes
//        (wgmma_int8.cuh). Each stage has a full mbarrier (one arrival,
//        expect-tx = both boxes' bytes: TMA zero-fills the out-of-bounds
//        part of a box, which makes the M, N and K tails, and still counts
//        its bytes) and an empty mbarrier (4 arrivals, one a warp of the
//        consumer warpgroup that read it). The producer runs ahead into
//        the next tile; the phase bits carry across tiles: the block's
//        L-th load uses stage L % 6 with parity (L / 6) & 1.
//      - Warpgroups 1 and 2 are consumers (setmaxnreg 232) that take the
//        block's tiles in turn (ping-pong): consumer c computes the
//        block's tiles c, c + 2, ..., each whole, as two m64 blocks (128
//        s32 accumulators a thread). For each stage of a tile: wait on
//        full, eight wgmma m64n128k32 s8 (two m64 blocks x four k32 steps,
//        A and B from shared memory, descriptor + 2 a step, the first
//        step of a tile with scale-d 0), one commit group, wait until one
//        group is left in flight, then release the previous stage (whose
//        group has now retired) on its empty barrier. Named barriers
//        order the two consumers' MMA loops: consumer c starts tile i
//        once the other has issued tile i - 1's MMAs, so the tensor cores
//        serve one consumer at a time while the other runs its epilogue;
//        and every earlier load has landed before a consumer waits on a
//        stage, so no wait can pass on an older phase of the same parity.
//      - Epilogue, per consumer and m64 block, through the consumer's own
//        10 KB of staging. The int8 output, where its rows are 16-byte
//        multiples (N % 16 == 0): the accumulators (wgmma's register
//        layout, wgmma_int8.cuh), requantized (md_requant_mul), are
//        written into a [64 rows x 128 bytes] box under the 128-byte
//        swizzle, fenced for the async proxy, and one thread issues its
//        TMA store (cp.async.bulk.tensor, which clips the M and N tails);
//        the consumer goes on to its next tile while it drains, and waits
//        for its reads only before it writes the staging again. The
//        int32 output and other widths go 32 columns at a time through a
//        [64][40] int32 tile (a pitch of 8 mod 32 words: each half-warp's
//        8-byte stores hit 32 banks), read back 16 bytes a thread and
//        stored as 16-byte int32 rows or 4-byte words of int8 (element
//        stores where N % 4 != 0), masked at the tails.
//      The roles are taken from a warp-uniform warpgroup index (a
//      shuffle), a consumer issues every wgmma of its tiles (rows past M
//      multiply zeros), and the accumulators are read only after
//      wait_group 0: ptxas then serialises no wgmma (its C7520 / C7514).
// What bounds it (H100 SXM): at E5's 65536 x 1152 x 1152, the s32 output
// (302 MB of the 379 MB moved: 0.113 ms at 3.35 TB/s) or, with the fused
// requant, the 174 G int8 operations (0.088 ms at 1,979 TOP/s); at E6's
// 38400 x 2304 x 256 the bytes (128 MB, 0.038 ms). Each 128 x 128 tile
// reads its A and B panels from L2 (1.4 GB at E5), and a grid of whole
// tiles leaves the last round partly empty. Measured on the H100
// (experiments/gemm_breakdown.py; PERF.md): E5's int32 stores hold it at
// ~0.16 ms (0.11 without them; TMA stores of its 32 KB int32 blocks were
// slower still, so it keeps the element stores); fused int8 E5 lands ~0.02
// ms above both its variant without loads and its variant without stores.
//
// md_gemm_int8_breakdown (compiled only with -DMD_GEMM_BREAKDOWN, by
// experiments/gemm_breakdown.py) launches the same kernel with one part
// removed, to attribute its time.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "wgmma_int8.cuh"

namespace {

constexpr int kBM = 128;          // output rows of a tile (two m64 blocks)
constexpr int kBN = 128;          // output columns of a tile
constexpr int kBK = 128;          // K bytes of a stage (one swizzled row)
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kChunk = 32;        // output columns a staging step
constexpr int kPitch = kChunk + 8;  // staging row pitch, in words
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

// A consumer's staging: the element-store epilogue's [64][kPitch] int32
// tile, or the TMA store's [64 rows][128 bytes] int8 box within it
constexpr int kStaging = 64 * kPitch * 4;
// The ring takes what shared memory is left after the two consumers'
// staging, the barriers and the 1024 bytes the base may be rounded up by
// (the swizzle's atom)
constexpr int kAStage = kBM * kBK;
constexpr int kBStage = kBN * kBK;
constexpr int kStage = kAStage + kBStage;
constexpr int kStages = (kSmemMax - 1024 - 2 * kStaging - 256) / kStage;
constexpr int kSmem = 1024 + kStages * kStage + 2 * kStaging + 16 * kStages;
static_assert(kStages >= 3 && kSmem <= kSmemMax, "ring");

// Named barriers: 1 + c, consumer c's staging; 3 + c, consumer c may
// start its next tile's MMAs
constexpr int kStagingBarrier = 1;
constexpr int kOrderBarrier = 3;

// Parts of the kernel a breakdown variant leaves out (0: none)
enum Variant {
  kFull = 0,
  kNoMma = 1,       // consumers wait and release, but issue no wgmma
  kNoStores = 2,    // the epilogue's global stores are not issued
  kNoEpilogue = 3,  // no staging and no stores
  kNoLoads = 4,     // the producer arrives on full without TMA loads
};

struct GemmArgs {
  void* out;
  int m, n;
  int nk;         // K stages: Kp / 128 rounded up
  int tiles_n;    // column tiles, N / 128 rounded up
  int tiles;      // all tiles
  int requant;
  int tma_store;  // int8 rows of 16-byte multiples: TMA stores
  float scale;
};

// bt [n, kp] = b^T for b [k, n], zeros at k <= column < kp; 64 x 64 byte
// tiles through shared memory, coalesced on both sides
__global__ void __launch_bounds__(256)
    transpose_kernel(const int8_t* __restrict__ b, int8_t* __restrict__ bt,
                     int k, int n, int kp) {
  __shared__ int8_t tile[64][68];  // 17 words a row: column reads hit
                                   // distinct banks
  const int n0 = blockIdx.x * 64;
  const int k0 = blockIdx.y * 64;
  for (int i = threadIdx.x; i < 64 * 64; i += 256) {
    const int r = i / 64, c = i % 64;  // r: k, c: n
    const int kk = k0 + r, nn = n0 + c;
    tile[r][c] = kk < k && nn < n ? b[(long long)kk * n + nn] : 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 64; i += 256) {
    const int r = i / 64, c = i % 64;  // r: n, c: k
    const int nn = n0 + r, kk = k0 + c;
    if (nn < n && kk < kp) bt[(long long)nn * kp + kk] = tile[c][r];
  }
}

// ap [m, kp] = a [m, k], zeros at k <= column < kp
__global__ void __launch_bounds__(256)
    pad_kernel(const int8_t* __restrict__ a, int8_t* __restrict__ ap,
               long long m, int k, int kp) {
  const long long total = m * kp;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    const long long r = i / kp;
    const int c = (int)(i - r * kp);
    ap[i] = c < k ? a[r * k + c] : 0;
  }
}

// Four outputs of row m from column n on: int32, or int8 at the requant
__device__ __forceinline__ void store4(const GemmArgs& g, long long m, int n,
                                       int4 v) {
  const size_t o = (size_t)m * g.n + n;
  const bool whole = (g.n & 3) == 0;  // 4 columns in range and aligned
  const int acc[4] = {v.x, v.y, v.z, v.w};
  const int left = g.n - n;
  if (g.requant) {
    int8_t* out = static_cast<int8_t*>(g.out) + o;
    if (whole) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= (uint32_t)(uint8_t)md_requant_mul(__int2float_rn(acc[j]),
                                                  g.scale)
                << (8 * j);
      *reinterpret_cast<uint32_t*>(out) = word;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < left) out[j] = md_requant_mul(__int2float_rn(acc[j]), g.scale);
    }
  } else {
    int* out = static_cast<int*>(g.out) + o;
    if (whole) {
      *reinterpret_cast<int4*>(out) = v;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < left) out[j] = acc[j];
    }
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_int8_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_out,
                     const GemmArgs g) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzle acts on shared address bits 4-9: start on 1024 bytes
  const uint32_t raw = md_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t ring_a = base;
  const uint32_t ring_b = base + kStages * kAStage;
  const uint32_t staging = base + kStages * kStage;
  const uint32_t full = staging + 2 * kStaging;  // kStages x 8 bytes
  const uint32_t empty = full + 8 * kStages;

  const int t = threadIdx.x;
  // The warpgroup, warp-uniform to the compiler
  const int wg = __shfl_sync(0xffffffffu, t / 128, 0);
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      md_mbarrier_init(full + 8 * s, 1);
      md_mbarrier_init(empty + 8 * s, 4);
    }
    md_fence_mbarrier_init();
  }
  __syncthreads();
  // This block's tiles: blockIdx.x + i * gridDim.x, i < n_local
  const int n_local =
      (int)blockIdx.x < g.tiles
          ? (g.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;

  if (wg == 0) {
    // ---- Producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t == 0) {
      md_prefetch_tensor_map(&map_a);
      md_prefetch_tensor_map(&map_b);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_local; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        const int m0 = tile / g.tiles_n * kBM;
        const int n0 = tile % g.tiles_n * kBN;
        for (int kb = 0; kb < g.nk; ++kb) {
          md_mbarrier_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          if constexpr (kVariant == kNoLoads) {
            md_mbarrier_arrive(bar);
          } else {
            md_mbarrier_arrive_expect_tx(bar, kStage);
            md_tma_load_2d(ring_a + stage * kAStage, &map_a, bar, kb * kBK,
                           m0);
            md_tma_load_2d(ring_b + stage * kBStage, &map_b, bar, kb * kBK,
                           n0);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- Consumer c: the block's tiles c, c + 2, ... ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int lt = t % 128;
    const int lane = t % 32;
    const uint32_t stg_addr = staging + c * kStaging;
    uint8_t* const stg_bytes = smem + (stg_addr - base);
    int* const stg = reinterpret_cast<int*>(stg_bytes);
    // wgmma's accumulators: d[4 j + 2 h + q] is row 16 warp + lane / 4 +
    // 8 h, column 8 j + 2 (lane % 4) + q of an m64 x 128 block
    const int acc_row = 16 * (lt / 32) + lane / 4;
    const int acc_col = 2 * (lane % 4);
    const int rd_col = 4 * (lt % 8);
    int acc[2][kBN / 2];  // written by wgmma only
    if constexpr (kVariant == kNoMma) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < kBN / 2; ++j) acc[mi][j] = 0;
    }
    for (int i = c; i < n_local; i += 2) {
      const int tile = blockIdx.x + i * gridDim.x;
      const int m0 = tile / g.tiles_n * kBM;
      const int n0 = tile % g.tiles_n * kBN;
      // The other consumer has issued tile i - 1's MMAs, so every load
      // before this tile's has landed
      if (i > 0) md_named_barrier(kOrderBarrier + c, 256);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) md_fence_acc(acc[mi]);
      int prev = 0;
      for (int kb = 0; kb < g.nk; ++kb) {
        const int load = i * g.nk + kb;
        const int stage = load % kStages;
        md_mbarrier_wait(full + 8 * stage, (load / kStages) & 1);
        if constexpr (kVariant != kNoMma) {
          const uint32_t a0 = ring_a + stage * kAStage;
          const uint64_t db = md_smem_desc<kBK>(ring_b + stage * kBStage);
          md_wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 32; ++kk)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              MdWgmmaS8<kBN>::mma(
                  acc[mi], md_smem_desc<kBK>(a0 + mi * 64 * kBK) + 2 * kk,
                  db + 2 * kk, kb > 0 || kk > 0);
          md_wgmma_commit();
          md_wgmma_wait<1>();
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) md_fence_acc(acc[mi]);
        }
        // The previous stage's MMAs have retired: its slot is free
        if (kb > 0 && lane == 0) md_mbarrier_arrive(empty + 8 * prev);
        prev = stage;
      }
      // Let the other consumer start the next tile's MMAs
      if (i + 1 < n_local) md_named_arrive(kOrderBarrier + 1 - c, 256);
      md_wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) md_fence_acc(acc[mi]);
      if (lane == 0) md_mbarrier_arrive(empty + 8 * prev);

      if constexpr (kVariant == kNoEpilogue) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row0 = m0 + 64 * mi;
        if (g.tma_store) {
          // The staging is free once the last TMA store has read it
          if (lt == 0) md_bulk_wait_read();
          md_named_barrier(kStagingBarrier + c, 128);
          // Row r, column x of the m64 x 128 int8 block at byte
          // md_swizzle<128>(128 r + x) of the box
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t q =
                  (uint32_t)(uint8_t)md_requant_mul(
                      __int2float_rn(acc[mi][4 * j + 2 * h]), g.scale) |
                  (uint32_t)(uint8_t)md_requant_mul(
                      __int2float_rn(acc[mi][4 * j + 2 * h + 1]), g.scale)
                      << 8;
              *reinterpret_cast<uint16_t*>(
                  stg_bytes +
                  md_swizzle<128>(128 * (acc_row + 8 * h) + 8 * j +
                                  acc_col)) = (uint16_t)q;
            }
          }
          md_fence_proxy_async();  // for the TMA store's reads
          md_named_barrier(kStagingBarrier + c, 128);
          if (kVariant != kNoStores && lt == 0) {
            md_tma_store_2d(&map_out, stg_addr, n0, row0);
            md_bulk_commit();
          }
          continue;
        }
        // Element stores: 32 columns at a time through [64][kPitch]
#pragma unroll
        for (int ch = 0; ch < kBN / kChunk; ++ch) {
          // the last step's reads are done
          md_named_barrier(kStagingBarrier + c, 128);
#pragma unroll
          for (int jj = 0; jj < kChunk / 8; ++jj) {
            const int j = ch * (kChunk / 8) + jj;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<int2*>(stg + (acc_row + 8 * h) * kPitch +
                                       8 * jj + acc_col) =
                  make_int2(acc[mi][4 * j + 2 * h],
                            acc[mi][4 * j + 2 * h + 1]);
          }
          md_named_barrier(kStagingBarrier + c, 128);
          const int n = n0 + ch * kChunk + rd_col;
#pragma unroll
          for (int pass = 0; pass < 4; ++pass) {
            const int r = lt / 8 + 16 * pass;
            const int4 v =
                *reinterpret_cast<const int4*>(stg + r * kPitch + rd_col);
            if constexpr (kVariant != kNoStores) {
              if (row0 + r < g.m && n < g.n) store4(g, row0 + r, n, v);
            } else {
              asm volatile("" ::"r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
            }
          }
        }
      }
    }
    // The stores have read the staging before the block's shared memory
    // goes
    if (lt == 0) md_bulk_wait_read();
  }
}

// cuTensorMapEncodeTiled, a driver API function, through the runtime's
// entry point query (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major [rows, kp] int8 matrix read in boxes of
// [box_rows rows x 128 K bytes], 128-byte swizzled, zeros out of bounds
bool encode(EncodeTiled fn, CUtensorMap* map, const int8_t* p, int rows,
            int kp, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<int8_t*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The int8 output's map, for TMA stores of [64 rows x 128 columns] boxes
// from 128-byte swizzled staging; rows and columns out of bounds are not
// written
bool encode_out(EncodeTiled fn, CUtensorMap* map, const GemmArgs& g) {
  const cuuint64_t dims[2] = {(cuuint64_t)g.n, (cuuint64_t)g.m};
  const cuuint64_t strides[1] = {(cuuint64_t)g.n};
  const cuuint32_t box[2] = {128, 64};
  const cuuint32_t ones[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, g.out, dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kVariant>
int launch_gemm(const int8_t* a, const int8_t* bt, const GemmArgs& g,
                int kp, int grid, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map_a, map_b, map_out{};
  if (!encode(fn, &map_a, a, g.m, kp, kBM) ||
      !encode(fn, &map_b, bt, g.n, kp, kBN) ||
      (g.tma_store && !encode_out(fn, &map_out, g)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = gemm_int8_kernel<kVariant>;
  // The shared-memory attribute, once a card (a call on the host costs
  // about as much as the pre-passes at small shapes)
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = true;
  }
  kernel<<<grid, kThreads, kSmem, stream>>>(map_a, map_b, map_out, g);
  return static_cast<int>(cudaGetLastError());
}

// The pre-passes, then the GEMM as variant kVariant; see md_gemm_int8
template <int kVariant>
int run(const int8_t* a, const int8_t* b, void* out, int8_t* bt, int8_t* ap,
        int m, int n, int k, int requant, float scale, int grid,
        void* stream, bool gemm) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || grid <= 0 || bt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = k <= 16 ? 16 : (k + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ap != nullptr) {
    const long long total = (long long)m * kp;
    const long long blocks = (total + 255) / 256;
    pad_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        a, ap, m, k, kp);
    a = ap;
  } else if (k != kp || reinterpret_cast<uintptr_t>(a) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 tgrid((unsigned)((n + 63) / 64), (unsigned)((kp + 63) / 64));
  transpose_kernel<<<tgrid, 256, 0, s>>>(b, bt, k, n, kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !gemm) return static_cast<int>(err);
  GemmArgs g{};
  g.out = out;
  g.m = m;
  g.n = n;
  g.nk = (kp + kBK - 1) / kBK;
  g.tiles_n = (n + kBN - 1) / kBN;
  g.tiles = (int)(((long long)m + kBM - 1) / kBM * g.tiles_n);
  g.requant = requant;
  // The int8 output goes out through TMA stores where its rows are
  // 16-byte multiples (the base is 16-byte aligned: the caller's
  // allocation). The int32 output goes element by element: TMA stores of
  // its 4x larger boxes measured slower (PERF.md)
  g.tma_store = requant && n % 16 == 0 &&
                reinterpret_cast<uintptr_t>(out) % 16 == 0;
  g.scale = scale;
  return launch_gemm<kVariant>(a, bt, g, kp, grid, s);
}

}  // namespace

extern "C" {

// out: [m, n] int32 (requant == 0) or int8 at clamp(rint(f32(acc) *
// scale)). bt: scratch of n * Kp bytes (Kp = k rounded up to 16, at least
// 16); ap: null when a can be read in place (k % 16 == 0 and a 16-byte
// aligned), else scratch of m * Kp bytes. grid: the persistent blocks
// (ops/gemm_int8.py gemm_tiling). Launches on [stream]. Returns
// cudaGetLastError() (0 = launched), or an error for arguments the kernel
// does not take or a tensor map it cannot encode.
int md_gemm_int8(const int8_t* a, const int8_t* b, void* out, int8_t* bt,
                 int8_t* ap, int m, int n, int k, int requant, float scale,
                 int grid, void* stream) {
  return run<kFull>(a, b, out, bt, ap, m, n, k, requant, scale, grid,
                    stream, true);
}

#ifdef MD_GEMM_BREAKDOWN
// md_gemm_int8 with the GEMM kernel's part [variant] (Variant) left out;
// variant -1 runs the pre-passes alone
int md_gemm_int8_breakdown(const int8_t* a, const int8_t* b, void* out,
                           int8_t* bt, int8_t* ap, int m, int n, int k,
                           int requant, float scale, int grid, int variant,
                           void* stream) {
#define MD_RUN(v, gemm) \
  run<v>(a, b, out, bt, ap, m, n, k, requant, scale, grid, stream, gemm)
  switch (variant) {
    case -1:
      return MD_RUN(kFull, false);
    case kFull:
      return MD_RUN(kFull, true);
    case kNoMma:
      return MD_RUN(kNoMma, true);
    case kNoStores:
      return MD_RUN(kNoStores, true);
    case kNoEpilogue:
      return MD_RUN(kNoEpilogue, true);
    case kNoLoads:
      return MD_RUN(kNoLoads, true);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MD_RUN
}
#endif

}  // extern "C"
