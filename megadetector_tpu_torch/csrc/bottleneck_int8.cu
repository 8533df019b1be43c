// Fused int8 CSP bottleneck for Hopper (sm_90a), on the int8 tensor cores
// (wgmma): 1x1 C->C conv, 3x3 C->C SAME conv, optional residual add, in
// one kernel.
//
// Replaces the TPU kernel megadetector_tpu/ops/pallas_bottleneck.py:
// bottleneck_chain / _kernel (its 'taps' schedule), and computes exactly
// the unfused chain of megadetector_tpu/ops/quantization.py
// (chained_conv 1x1 -> chained_conv 3x3 -> qt_add):
//
//   h1  = q(silu(conv1x1(x) * scale1 + bias1), mid_scale)   (0 off-image)
//   h2  = q(silu(conv3x3(h1) * scale2 + bias2), cv2_scale)
//   out = q(x * s_in + h2 * cv2_scale, s_in + cv2_scale)   (shortcut)
//   out = h2                                               (no shortcut)
//   q(y, s) = clamp(rint(y / s), -127, 127)
//
// x, out NHWC int8 [B, H, W, C]; w1 [C, C] and w2 [C, 3, 3, C] int8
// ([Cout, kh, kw, Cin]); C a multiple of 4 (K and N tails zero-filled);
// any H and W.
//
// Design. A block owns a 16 x 8 tile of output pixels of one image and all
// C output channels: two warpgroups (256 threads), warpgroup g the tile
// rows 8 g .. 8 g + 7, so each 8-row group of its 64 MMA rows is one tile
// row.
//   Phase 1 runs the 1x1 over the tile and its one-pixel halo (18 x 10 =
//   180 pixels, as two 128-row chunks; the second one's upper warpgroup
//   multiplies zero rows) as a GEMM on wgmma: x's halo pixels
//   (A) and w1's rows (B) come through a cp.async ring of 64-byte K
//   stages in the 64-byte swizzled K-major layout, as in conv_int8.cu;
//   out-of-image pixels and the K and N tails copy zeros. Its epilogue
//   writes int8 h1 into shared memory, 0 at halo pixels outside the
//   image: SAME padding pads h1 with zeros, not x (running the 1x1 on
//   zero x would give q(silu(bias1)) there).
//   The h1 tile is K-major without swizzle: [C / 16][180 pixels][16 B],
//   core matrices of 8 consecutive pixels x 16 channels. A tap (dy, dx)
//   of warpgroup g reads the 64 x 32 A tile of a k32 step through one
//   descriptor (md_smem_desc_interleave): start at pixel (8 g + dy) * 10 +
//   dx, 8-row groups (tile rows) SBO = 10 * 16 = 160 bytes apart, the
//   next 16 channels LBO = 180 * 16 = 2880 bytes on. So the shifted
//   windows of all nine taps read h1 in place; a swizzled h1 could not be
//   shifted, since the swizzle XORs absolute address bits.
//   Phase 2 runs the 3x3 from the h1 tile: per N chunk of BN (64 or 128)
//   output channels, 9 taps x C / 64 units of w2's tap slice (B, through
//   the same ring, now B only, 16 KB stages of two or four units, so 4 or
//   8 MMAs a warpgroup share a barrier). At the end of a chunk the ring is
//   drained, the accumulators go through the epilogue to int8 h2 in a
//   staging tile [128][BN + 16] at the ring's start, and the block reads
//   it back 16 (or 4) bytes a thread, applies the residual with x read
//   from device memory (L2 hits: phase 1 read the same pixels) and stores
//   coalesced.
// Shared memory: the 64 KB ring and h1, 180 * C bytes (C rounded up to
// 64): 110 KB at C = 256, so two blocks share an SM up to there.
// h1 never reaches device memory: per bottleneck the kernel reads x (and
// its halo) and writes out, where the unfused chain also writes and
// re-reads h1 and h2. What bounds it: the int8 tensor cores (10 C^2 MACs
// a pixel; C = 256 at [8,60,80] is 25.2 G MAC, 0.0254 ms at 1,979 TOP/s),
// plus the 1x1 on the halo and its padding (256 MMA rows a block for 128
// pixels: twice its tenth) and the float epilogues of both convs, which
// run on the CUDA cores. The
// tile is picked in Python (ops/bottleneck_int8.py kernel_tiling, from C
// and alignment) and passed as an instance code; routing
// (bottleneck_tiling) sends grids that would leave the card mostly idle
// to the unfused convs instead.
//
// Rounding follows the unfused plain version step by step (see
// int8_epilogue.cuh); the residual is x * s_in + h2 * cv2_scale with each
// product and the sum rounded separately (no FMA, -fmad=false), then an
// IEEE division by s_in + cv2_scale: bit-identical to the unfused chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "wgmma_int8.cuh"

namespace {

constexpr int kTH = 16;                 // tile rows (8 a warpgroup)
constexpr int kTW = 8;                  // tile columns (an 8-row group)
constexpr int kHW = kTW + 2;            // halo columns
constexpr int kHalo = (kTH + 2) * kHW;  // 180 halo pixels
constexpr int kThreads = 256;           // two warpgroups
constexpr int kBM1 = 128;               // phase-1 A rows (halo pixels) a stage
constexpr int kBK = 64;                 // K bytes a stage
constexpr int kChunks = kBK / 16;       // 16-byte chunks of a stage row
constexpr int kRowStep = kThreads / kChunks;
constexpr int kRing = 64 * 1024;
constexpr int kLbo = kHalo * 16;        // h1: next 16 channels
constexpr int kSbo = kHW * 16;          // h1: next tile row
constexpr int kAlign = 1024;            // the ring's swizzle atom

// Instance code bits (ops/bottleneck_int8.py kernel_tiling builds it)
enum Instance {
  kInstVec16 = 1,  // 16-byte copies and stores (else 4-byte words)
  kInstBn128 = 2,  // BN 128 (else 64)
};

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
};

// The block's shared memory for BN: the ring, then h1. Phase 1's stages
// hold A (128 x 64) and B (BN x 64); phase 2's hold kUnits2 units of B
// (BN x 64 each, one tap's 64 channels), so every stage issues 4 (BN 128)
// or 8 (BN 64) MMAs a warpgroup under one barrier. The staging tile of
// phase 2's epilogue takes the ring's start once a group's stages are
// drained.
template <int kBN_>
struct Geometry {
  static constexpr int kBN = kBN_;
  static constexpr int kSlotA = kBM1 * kBK;
  static constexpr int kSlot1 = kSlotA + kBN * kBK;
  static constexpr int kSlots1 = kRing / kSlot1;  // 4 (BN 128) or 5
  static constexpr int kUnit2 = kBN * kBK;
  static constexpr int kSlot2 = 16 * 1024;
  static constexpr int kUnits2 = kSlot2 / kUnit2;  // 2 or 4
  static constexpr int kSlots2 = kRing / kSlot2;   // 4
  static constexpr int kBRows = kBN / kRowStep;    // B rows a thread copies
  static constexpr int kPitch = kBN + 16;          // staging bytes a row
  static constexpr int kH1 = kRing;                // h1's offset
  static_assert(kSlots1 >= 3 && kSlotA % 512 == 0 && kSlot1 % 512 == 0 &&
                    kUnit2 % 512 == 0,
                "ring");
  static_assert(kBM1 * kPitch <= kRing, "staging");
  static_assert(kBN % kRowStep == 0 && kBM1 % kRowStep == 0, "tile");
};

// Bytes of shared memory a block takes at C channels (ops/bottleneck_int8
// .py smem_bytes computes the same)
size_t smem_bytes(int c) {
  return (size_t)kAlign + kRing +
         (size_t)kHalo * (((c + kBK - 1) / kBK) * kBK);
}

// Runs [groups] groups of [group] stages through a ring of kSlots slots
// as conv_int8.cu's loop does: load(g, i, slot) issues stage i's
// cp.asyncs kSlots - 2 stages ahead, mma(g, i, slot) its wgmmas (the
// group's first starts the sum with scale-d 0), one commit group a stage
// with one left in flight. After a group's last stage its MMAs and copies
// are drained and epilogue(g) takes the accumulators and may use the
// ring. So the accumulators are only written by wgmma and only read after
// wait_group 0, outside the loop that issues the MMAs: otherwise ptxas
// serializes every wgmma of the kernel.
template <int kSlots, int kN, class Load, class Mma, class Epilogue>
__device__ __forceinline__ void run_stages(int groups, int group,
                                           int (&acc)[kN], Load load,
                                           Mma mma, Epilogue epilogue) {
  constexpr int kAhead = kSlots - 2;
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    int next = 0, next_slot = 0;
    auto load_next = [&]() {
      if (next < group) load(g, next, next_slot);
      ++next;
      next_slot = next_slot + 1 == kSlots ? 0 : next_slot + 1;
      md_cp_async_commit();  // one group a stage, empty past the end
    };
#pragma unroll 1
    for (int i = 0; i < kAhead; ++i) load_next();
    int slot = 0;
#pragma unroll 1
    for (int i = 0; i < group; ++i) {
      md_cp_async_wait<kAhead - 1>();  // this thread's copies of stage i
      md_fence_proxy_async();
      __syncthreads();
      load_next();
      md_wgmma_fence();
      mma(g, i, slot);
      md_wgmma_commit();
      md_wgmma_wait<1>();
      md_fence_acc(acc);
      slot = slot + 1 == kSlots ? 0 : slot + 1;
    }
    md_wgmma_wait<0>();
    md_fence_acc(acc);
    md_cp_async_wait<0>();
    __syncthreads();  // both warpgroups are done with the ring
    epilogue(g);
    __syncthreads();  // the epilogue is done with the ring
  }
}

// The chain epilogue q(silu(acc * scale + bias), y_scale) of every
// accumulator of an m64nN tile, two channels (columns n0 + 8 j, + 1) a
// 16-bit word: v[2 j + h] for rows h = 0, 1. Every accumulator is read in
// uniform code, and the words are pinned before the caller's stores,
// which depend on the thread: ptxas serializes the wgmmas of a kernel
// that reads their registers in divergent code. Channels past C read
// channel 0's scale and bias (their words are not stored).
template <int kN>
__device__ __forceinline__ void pack_epilogue(const int (&acc)[kN],
                                              int (&v)[kN / 2], int n0,
                                              const float* scale,
                                              const float* bias, float y_scale,
                                              int c) {
#pragma unroll
  for (int j = 0; j < kN / 4; ++j) {
    const int n = n0 + 8 * j < c ? n0 + 8 * j : 0;
    const float sc0 = __ldg(scale + n), sc1 = __ldg(scale + n + 1);
    const float bi0 = __ldg(bias + n), bi1 = __ldg(bias + n + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int8_t v0 =
          md_requant(md_silu(md_affine(acc[4 * j + 2 * h], sc0, bi0)),
                     y_scale);
      const int8_t v1 =
          md_requant(md_silu(md_affine(acc[4 * j + 2 * h + 1], sc1, bi1)),
                     y_scale);
      v[2 * j + h] = (int)((uint32_t)(uint8_t)v0 |
                           ((uint32_t)(uint8_t)v1 << 8));
    }
  }
  md_fence_acc(v);
}

// The residual of four packed int8 lanes: q(x * s_in + h2 * cv2_scale,
// out_scale), each product and the sum rounded
__device__ __forceinline__ uint32_t residual4(uint32_t xv, uint32_t hv,
                                              const BottleneckArgs& a) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xk = (int)(int8_t)(xv >> (8 * k));
    const int hk = (int)(int8_t)(hv >> (8 * k));
    const float y = __fadd_rn(__fmul_rn(__int2float_rn(xk), a.s_in),
                              __fmul_rn(__int2float_rn(hk), a.cv2_scale));
    r |= (uint32_t)(uint8_t)md_requant(y, a.out_scale) << (8 * k);
  }
  return r;
}

template <int kBN, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2)
    bottleneck_int8_kernel(const BottleneckArgs a) {
  using G = Geometry<kBN>;
  extern __shared__ uint8_t smem_raw[];
  // The swizzle acts on shared address bits 4-8: start on 1024 bytes
  const uint32_t raw = md_smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  uint8_t* const smem = smem_raw + (base - raw);
  uint8_t* const h1 = smem + G::kH1;
  const uint32_t h1_addr = base + G::kH1;

  const int t = threadIdx.x;
  const int wg = t / 128;
  const int warp = (t % 128) / 32;
  const int lane = t % 32;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const size_t img = (size_t)blockIdx.z * a.h * a.w;
  const int c = a.c;
  const int nk = (c + kBK - 1) / kBK;     // K stages of one pass
  const int nn = (c + kBN - 1) / kBN;     // N chunks

  // This thread copies chunk cc of stage rows r0 + kRowStep i
  const int cc = t % kChunks;
  const int r0 = t / kChunks;

  // One chunk: [left] bytes remain in the row from src (<= 0: zeros)
  auto copy_chunk = [&](uint32_t dst, const int8_t* src, const int8_t* any,
                        int left) {
    if constexpr (kVec16) {
      md_cp_async16(dst, left > 0 ? src : any, left > 0 ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        md_cp_async4(dst + 4 * j, left > 4 * j ? src + 4 * j : any,
                     left > 4 * j ? 4 : 0);
    }
  };
  // Halo pixel p (row-major over 18 x 10) -> its image offset in pixels,
  // or -1 outside the image or past the halo
  auto halo_pixel = [&](int p) -> long long {
    const int hy = p / kHW;
    const int iy = y0 - 1 + hy;
    const int ix = x0 - 1 + (p - hy * kHW);
    if (p >= kHalo || (unsigned)iy >= (unsigned)a.h ||
        (unsigned)ix >= (unsigned)a.w)
      return -1;
    return (long long)img + (long long)iy * a.w + ix;
  };

  int acc[kBN / 2];  // written by wgmma only (run_stages)
  // wgmma's accumulators: d[4 j + 2 h + q] is row 16 warp + lane / 4 +
  // 8 h, column 8 j + 2 (lane % 4) + q of the warpgroup's 64 x BN tile
  const int acc_row = 16 * warp + lane / 4;
  const int acc_col = 2 * (lane % 4);

  // ---- Phase 1: h1 over the tile and its halo ----
  // Group g: (128-row chunk mc = g / nn, N chunk nc = g % nn); stage i:
  // K stage i
  auto load1 = [&](int g, int kc, int slot) {
    const int nc = g % nn;
    const int mc = g / nn;
    const int ch = kc * kBK + 16 * cc;
    const int left = c - ch;
    const uint32_t slot_a = base + slot * G::kSlot1;
    const uint32_t slot_b = slot_a + G::kSlotA;
#pragma unroll
    for (int i = 0; i < kBM1 / kRowStep; ++i) {
      const int r = r0 + kRowStep * i;
      const long long pix = halo_pixel(kBM1 * mc + r);
      copy_chunk(slot_a + md_swizzle<kBK>(r * kBK + 16 * cc),
                 pix >= 0 ? a.x + pix * c + ch : a.x, a.x,
                 pix >= 0 ? left : 0);
    }
#pragma unroll
    for (int i = 0; i < G::kBRows; ++i) {
      const int r = r0 + kRowStep * i;
      const int n = nc * kBN + r;
      copy_chunk(slot_b + md_swizzle<kBK>(r * kBK + 16 * cc),
                 n < c ? a.w1 + (size_t)n * c + ch : a.w1, a.w1,
                 n < c ? left : 0);
    }
  };
  // Every warpgroup issues its MMAs at every stage, also the upper one of
  // the second chunk, whose rows lie past the halo (zeros): ptxas
  // serializes all wgmmas of a kernel that issues one in divergent code
  auto mma1 = [&](int, int kc, int slot) {
    const uint32_t slot_a = base + slot * G::kSlot1;
    const uint64_t da = md_smem_desc<kBK>(slot_a + wg * 64 * kBK);
    const uint64_t db = md_smem_desc<kBK>(slot_a + G::kSlotA);
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      MdWgmmaS8<kBN>::mma(acc, da + 2 * kk, db + 2 * kk, kc > 0 || kk > 0);
  };
  // h1 = q(silu(acc * scale1 + bias1)) into [n / 16][p][n % 16], two
  // channels a store; 0 at halo pixels outside the image. The MMAs are
  // drained, so a warpgroup whose rows all lie past the halo skips it.
  auto epilogue1 = [&](int g) {
    const int nc = g % nn;
    const int mc = g / nn;
    if (kBM1 * mc + 64 * wg >= kHalo) return;
    int v[kBN / 4];
    pack_epilogue(acc, v, nc * kBN + acc_col, a.scale1, a.bias1,
                  a.mid_scale, c);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = nc * kBN + 8 * j + acc_col;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = kBM1 * mc + 64 * wg + acc_row + 8 * hh;
        if (n < c && p < kHalo)
          *reinterpret_cast<uint16_t*>(h1 + (n / 16) * kLbo + p * 16 +
                                       n % 16) =
              halo_pixel(p) >= 0 ? (uint16_t)v[2 * j + hh] : 0;
      }
    }
  };
  run_stages<G::kSlots1>(2 * nn, nk, acc, load1, mma1, epilogue1);
  // h1's stores (generic proxy) before phase 2's wgmmas read them
  md_fence_proxy_async();
  __syncthreads();

  // ---- Phase 2: 3x3 over h1, epilogue, residual ----
  // Group g: N chunk g; stage i: units u = kUnits2 i + q, each one tap's
  // 64 channels, (tap, kc) = (u / nk, u % nk), while u < 9 nk
  const int units = 9 * nk;
  auto load2 = [&](int g, int i, int slot) {
#pragma unroll
    for (int q = 0; q < G::kUnits2; ++q) {
      const int u = G::kUnits2 * i + q;
      if (u >= units) break;
      const int tap = u / nk;
      const int ch = (u - tap * nk) * kBK + 16 * cc;
      const int left = c - ch;
      const uint32_t unit_b = base + slot * G::kSlot2 + q * G::kUnit2;
#pragma unroll
      for (int j = 0; j < G::kBRows; ++j) {
        const int r = r0 + kRowStep * j;
        const int n = g * kBN + r;
        copy_chunk(unit_b + md_swizzle<kBK>(r * kBK + 16 * cc),
                   n < c ? a.w2 + ((size_t)n * 9 + tap) * c + ch : a.w2,
                   a.w2, n < c ? left : 0);
      }
    }
  };
  auto mma2 = [&](int, int i, int slot) {
    const uint64_t db = md_smem_desc<kBK>(base + slot * G::kSlot2);
#pragma unroll
    for (int q = 0; q < G::kUnits2; ++q) {
      const int u = G::kUnits2 * i + q;
      if (u >= units) break;
      const int tap = u / nk;
      const int kc = u - tap * nk;
      const int dy = tap / 3;
      const int dx = tap - 3 * dy;
      const uint32_t a0 = h1_addr + ((8 * wg + dy) * kHW + dx) * 16 +
                          (kBK / 16) * kc * kLbo;
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        MdWgmmaS8<kBN>::mma(
            acc, md_smem_desc_interleave(a0 + 2 * kk * kLbo, kLbo, kSbo),
            db + q * (G::kUnit2 >> 4) + 2 * kk, (i | q | kk) != 0);
    }
  };
  uint8_t* const staging = smem;  // the drained ring
  auto epilogue2 = [&](int nc) {
    // h2 = q(silu(acc * scale2 + bias2)) into the staging tile, row =
    // 64 wg + MMA row (tile pixel (row / 8, row % 8)); columns past C
    // are never read back
    int v[kBN / 4];
    pack_epilogue(acc, v, nc * kBN + acc_col, a.scale2, a.bias2,
                  a.cv2_scale, c);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint16_t*>(
            staging + (64 * wg + acc_row + 8 * hh) * G::kPitch + 8 * j +
            acc_col) = (uint16_t)v[2 * j + hh];
    }
    __syncthreads();
    // Read back [unit] bytes a thread, residual, coalesced stores
    constexpr int kUnit = kVec16 ? 16 : 4;
    constexpr int kUnits = kBN / kUnit;  // a row's units
#pragma unroll 1
    for (int u = t; u < kBM1 * kUnits; u += kThreads) {
      const int row = u / kUnits;
      const int col = (u % kUnits) * kUnit;
      const int oy = y0 + row / kTW;
      const int ox = x0 + row % kTW;
      const int n = nc * kBN + col;
      if (oy >= a.h || ox >= a.w || n >= c) continue;
      const size_t o = (img + (size_t)oy * a.w + ox) * c + n;
      const uint8_t* hp = staging + row * G::kPitch + col;
      if constexpr (kVec16) {
        uint4 h2 = *reinterpret_cast<const uint4*>(hp);
        if (a.shortcut) {
          const uint4 xv = __ldg(reinterpret_cast<const uint4*>(a.x + o));
          h2.x = residual4(xv.x, h2.x, a);
          h2.y = residual4(xv.y, h2.y, a);
          h2.z = residual4(xv.z, h2.z, a);
          h2.w = residual4(xv.w, h2.w, a);
        }
        *reinterpret_cast<uint4*>(a.out + o) = h2;
      } else {
        uint32_t h2 = *reinterpret_cast<const uint32_t*>(hp);
        if (a.shortcut)
          h2 = residual4(__ldg(reinterpret_cast<const uint32_t*>(a.x + o)),
                         h2, a);
        *reinterpret_cast<uint32_t*>(a.out + o) = h2;
      }
    }
  };
  run_stages<G::kSlots2>(nn, (units + G::kUnits2 - 1) / G::kUnits2, acc,
                         load2, mma2, epilogue2);
}

template <int kBN, bool kVec16>
int launch(const BottleneckArgs& a, int batch, cudaStream_t stream) {
  const auto kernel = bottleneck_int8_kernel<kBN, kVec16>;
  const size_t smem = smem_bytes(a.c);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.w + kTW - 1) / kTW, (a.h + kTH - 1) / kTH, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// [instance]: ops/bottleneck_int8.py kernel_tiling's code (Instance bits).
// Launches on [stream]. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an instance the data does not allow (C not a
// multiple of 4, 16-byte copies of C % 16 != 0 or of a pointer off 16
// bytes) or a C whose h1 tile does not fit shared memory.
int md_bottleneck_int8(const int8_t* x, const int8_t* w1, const float* scale1,
                       const float* bias1, float mid_scale, const int8_t* w2,
                       const float* scale2, const float* bias2,
                       float cv2_scale, float s_in, float out_scale,
                       int shortcut, int8_t* out, int batch, int h, int w,
                       int c, int instance, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  if (instance < 0 || instance > 3 || c % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec16 = instance & kInstVec16;
  if (vec16 && (c % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(w1) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(w2) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  BottleneckArgs a{x,     w1,        scale1,    bias1, w2,        scale2,
                   bias2, out,       mid_scale, cv2_scale, s_in,  out_scale,
                   shortcut, h,      w,         c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance & kInstBn128)
    return vec16 ? launch<128, true>(a, batch, s)
                 : launch<128, false>(a, batch, s);
  return vec16 ? launch<64, true>(a, batch, s) : launch<64, false>(a, batch, s);
}

}  // extern "C"
