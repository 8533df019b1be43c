// Hopper (sm_90a) primitives for int8 tensor-core tile loops: cp.async
// zero-fill copies into a shared-memory ring, the async-proxy fence, the
// wgmma shared-memory descriptor and the s8 x s8 -> s32 warpgroup MMA
// (N = 64, 128), and TMA tile loads with the mbarriers that track
// them.
//
// Tiles are K-major (each row of M or N holds [row_bytes] consecutive K
// bytes), as int8 wgmma requires, in the 64- or 128-byte swizzled layout
// the descriptor names: row r of a tile lies at r * row_bytes, and its
// 16-byte chunk c at chunk c ^ (address bits 7.. of the row), i.e.
//   128-byte rows: c ^ (r & 7)          (8-row atom of 1024 bytes)
//    64-byte rows: c ^ ((r >> 1) & 3)   (8-row atom of 512 bytes)
// on the absolute shared address, so every tile starts on a 1024-byte
// boundary. md_swizzle computes it; the hardware applies the same
// function when wgmma reads through a descriptor. A tile that is read
// through windows shifted by whole rows (bottleneck_int8.cu's h1) uses
// the layout without swizzle instead (md_smem_desc_interleave).
//
// wgmma's accumulators: in an m64nN tile, warp w (0-3) of the warpgroup
// and lane l hold, for j < N / 8, d[4 j + 2 h + q] = D[16 w + l / 4 +
// 8 h][8 j + 2 (l % 4) + q] (h, q in {0, 1}).

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t md_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of byte [offset] of a K-major tile with [kRowBytes]-byte
// rows (64 or 128) after the swizzle (Swizzle<log2(kRowBytes / 16), 4, 3>
// on the byte address: bits 4.. ^= bits 7..)
template <int kRowBytes>
__device__ __forceinline__ uint32_t md_swizzle(uint32_t offset) {
  static_assert(kRowBytes == 64 || kRowBytes == 128, "64 or 128 bytes");
  return offset ^ ((offset >> 3) & (uint32_t)((kRowBytes / 16 - 1) << 4));
}

// The wgmma shared-memory descriptor of a K-major tile with [kRowBytes]-
// byte rows starting at shared address [addr]: start address >> 4 (bits
// 0-13), leading byte offset 1 (unused by swizzled K-major tiles, bits
// 16-29), stride byte offset = one 8-row atom, 8 * kRowBytes, >> 4 (bits
// 32-45), base offset 0, layout (bits 62-63) 1 = 128-byte swizzle, 2 =
// 64-byte swizzle. Adding 2 advances it by one k32 step (32 bytes).
template <int kRowBytes>
__device__ __forceinline__ uint64_t md_smem_desc(uint32_t addr) {
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  constexpr uint64_t kSbo = (8 * kRowBytes) >> 4;
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         (kSbo << 32) | (kLayout << 62);
}

// The descriptor of a K-major tile without swizzle (layout 0, PTX's
// "interleave" mode) at shared address [addr]: core matrices of 8 rows x
// 16 K bytes, each 128 contiguous bytes (row r at r * 16); the core
// matrix of the next 16 K bytes lies [lbo] bytes on (leading byte offset,
// bits 16-29), that of the next 8 rows [sbo] bytes on (stride byte
// offset, bits 32-45). In CuTe's terms the tile is ((8, m), (16, 2)) :
// ((16, sbo), (1, lbo)) in bytes. No address bits are XORed, so the start
// may be any 16-byte boundary: a window shifted by whole rows is again a
// valid tile. One k32 step covers two core matrices in K, so the next
// step starts 2 * lbo bytes on.
__device__ __forceinline__ uint64_t md_smem_desc_interleave(uint32_t addr,
                                                            uint32_t lbo,
                                                            uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// cp.async of 16 (or 4) bytes global -> shared; src_bytes 0 writes zeros
// and reads nothing (the tails and the conv's padding)
__device__ __forceinline__ void md_cp_async16(uint32_t dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void md_cp_async4(uint32_t dst, const void* src,
                                             int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void md_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in
// flight; the landed bytes are then visible to this thread
template <int kPending>
__device__ __forceinline__ void md_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Makes this thread's shared-memory writes (ordinary stores and landed
// cp.async bytes) visible to the async proxy, which wgmma reads through;
// a barrier must follow before another thread's wgmma reads them
__device__ __forceinline__ void md_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void md_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void md_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void md_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accumulator accesses across the async
// MMAs that write them
template <int kN>
__device__ __forceinline__ void md_fence_acc(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N, s32) += A (64 x 32, s8, K-major) * B (N x 32, s8, K-major)^T,
// both read from shared memory through descriptors; with accumulate 0,
// d = A * B^T (wgmma's scale-d), which starts a sum without writing the
// accumulators outside wgmma
template <int kN>
struct MdWgmmaS8;

template <>
struct MdWgmmaS8<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct MdWgmmaS8<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// ---- TMA loads and mbarriers (gemm_int8.cu's ring) ----

// Initialise the mbarrier at shared address [bar] for [count] arrivals a
// phase; one thread, then md_fence_mbarrier_init and a block barrier
__device__ __forceinline__ void md_mbarrier_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void md_fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void md_mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and add [bytes] to the phase's expected transaction count: the
// phase completes once the arrivals are in and that many bytes have landed
__device__ __forceinline__ void md_mbarrier_arrive_expect_tx(uint32_t bar,
                                                             uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity [parity] has completed (the barrier's
// current phase has the other parity). A fresh barrier is in phase 0, so
// a wait on parity 1 passes at once: a ring's producer waits on its empty
// barriers with the parity of its pass through the ring flipped
__device__ __forceinline__ void md_mbarrier_wait(uint32_t bar,
                                                 uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box of a 2-D tensor map (a CUtensorMap kernel parameter) at
// element coordinates (c0 innermost, c1) into shared memory at [dst],
// completing [bytes of the box] on the mbarrier [bar]; out-of-bounds
// elements land as zeros and still count
__device__ __forceinline__ void md_tma_load_2d(uint32_t dst,
                                               const void* tensor_map,
                                               uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(bar), "r"(c0),
      "r"(c1)
      : "memory");
}

// TMA store: the box of a 2-D tensor map at (c0, c1) from shared memory
// at [src] (laid out as the map's swizzle says), in this thread's current
// bulk group; elements out of bounds are not written
__device__ __forceinline__ void md_tma_store_2d(const void* tensor_map,
                                                uint32_t src, int c0,
                                                int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(
                                      tensor_map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void md_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void md_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void md_prefetch_tensor_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Named barrier [id] (1-15) over [threads] threads (a multiple of 32):
// wait until that many threads have arrived
__device__ __forceinline__ void md_named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at named barrier [id] without waiting (the other threads of its
// count wait there with md_named_barrier)
__device__ __forceinline__ void md_named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
