// int8 implicit-GEMM convolution with the int8 chain's epilogue, for
// Hopper (sm_90a), on the int8 tensor cores (wgmma).
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
// out NHWC. Cin must be a multiple of 4; any H, W, Cout, kernel size,
// strides and pads. Zero padding is exact because the symmetric int8 zero
// point is 0.
//
// Design: GEMM with M = B*Ho*Wo pixels, N = Cout, K = kh*kw*Cin. Both
// operands are already K-major (x holds a pixel's Cin contiguously for
// each tap, w an output channel's), as int8 wgmma requires, so nothing is
// transposed. A block computes a BM x BN tile (BM 64 or 128: one
// warpgroup of 128 threads per 64 rows; BN 64 or 128) over K in stages of
// one tap's BK bytes of Cin (BK 128 when Cin % 128 == 0, else 64):
//   - producer: every thread cp.asyncs its 16-byte chunks of the stage's
//     A rows (pixels, at this tap) and B rows (output channels) into a
//     ring of shared-memory stages (3 of 128 bytes or 6 of 64), in
//     the swizzled K-major layout the wgmma descriptor reads
//     (wgmma_int8.cuh); out-of-image taps and the K and N tails copy 0
//     source bytes, i.e. zeros. Stages s + 1 .. s + kAhead are in flight
//     while stage s multiplies. Where Cin % 16 != 0 or x or w is not
//     16-byte aligned, the 4-byte instance copies each chunk as four
//     4-byte words (kVec16 false; Cin % 4 == 0 keeps every word inside
//     one pixel).
//   - consumer: each warpgroup issues BK / 32 wgmma m64nBNk32 s8 MMAs per
//     stage on its 64 rows, A and B both from shared memory, with one
//     commit group per stage and wait_group 1, so one stage's MMAs run
//     across the next stage's barrier. Before the barrier every thread
//     waits for its own copies and issues fence.proxy.async: shared
//     memory written by cp.async or by stores is otherwise not visible
//     to wgmma, which reads through the async proxy. A 128 x 128 block
//     needs under 113 KB, so two blocks share an SM.
//   - epilogue: the int32 accumulators (wgmma's layout: wgmma_int8.cuh)
//     go to shared memory once (the ring is free by then), and the block
//     reads them back four channels to a thread, so each output row's
//     int8 (one 32-bit word) or int32 (16 bytes) stores coalesce. The
//     epilogue kind is a template chosen per launch (store_tile).
// The tile is picked in Python (ops/conv_int8.py conv_tiling) from the
// grid it gives (BM 64 when BM 128 would leave SMs idle) and passed as an
// instance code. No split-K: the float epilogue needs the whole sum.
// What bounds it: the int8 tensor cores for the 3x3 convs (22.6 G MAC at
// [8,120,160,128] -> 128 is 0.023 ms at 1,979 TOP/s) and the output
// bytes for the int32 1x1 case; one stage's barrier per BK bytes and the
// unhidden epilogue keep it above both.
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
// applied in shared memory: once a stage has landed, each thread rewrites
// the A chunks it copied (skipped at in_ratio 1; rq(0) = 0 keeps the zero
// padding exact) before its proxy fence. One of four epilogues follows,
// each ending in md_requant_mul (a multiply by f32(1/y_scale), as the
// experiments requantize):
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
// FMA, which moves the int8 result by 1 on rare elements).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_epilogue.cuh"
#include "int8_epilogue.cuh"
#include "wgmma_int8.cuh"

namespace {

// Epilogue kinds; kChain is the int8 chain's (int32 out when
// requant == 0), the others the experiments' (ops/conv_int8.py
// EXP_EPILOGUES holds the same codes)
enum Epilogue { kChain = 0, kF32 = 1, kF32NoSilu = 2, kBf16 = 3, kHybrid = 4 };

// Instance code bits (ops/conv_int8.py conv_tiling builds the code)
enum Instance {
  kInstVec16 = 1,   // 16-byte copies (else four 4-byte words a chunk)
  kInstBk128 = 2,   // BK 128 (else 64); needs kInstVec16
  kInstBm128 = 4,   // BM 128, two warpgroups (else 64, one)
  kInstBn128 = 8,   // BN 128 (else 64)
};

struct ConvArgs {
  const int8_t* x;
  const int8_t* wt;
  const float* scale;
  const float* bias;
  void* out;
  int batch, h, w, cin, cout, kh, kw, sh, sw, pt, pl, ho, wo;
  float y_scale;
  int requant;
  int epilogue;
  float in_ratio;  // kRequantIn only
  float inv_y;     // the experiments' epilogues only
};

// A block's geometry: BM x BN outputs, BK K bytes a stage. The ring of
// 3 stages of 128 bytes or 6 of 64 keeps a 128 x 128 block under 113 KB
// of shared memory, so two blocks share an SM and one's epilogue and
// barriers overlap the other's MMAs, which a deeper ring at one block an
// SM does not
template <int kBM_, int kBN_, int kBK_>
struct Tile {
  static constexpr int kBM = kBM_, kBN = kBN_, kBK = kBK_;
  static constexpr int kStages = kBK == 128 ? 3 : 6;
  static constexpr int kThreads = 2 * kBM;  // a warpgroup per 64 rows
  // Stages loaded ahead: each stage leaves its MMAs running across the
  // next barrier (wait_group 1), so the slot of stage s + kAhead is the
  // one of stage s - 2, which every warpgroup has finished with before
  // the barrier of stage s
  static constexpr int kAhead = kStages - 2;
  static constexpr int kChunks = kBK / 16;  // 16-byte chunks of a row
  static constexpr int kRowStep = kThreads / kChunks;
  static constexpr int kARows = kBM / kRowStep;  // A rows a thread copies
  static constexpr int kBRows = kBN / kRowStep;  // B rows a thread copies
  static constexpr int kAStage = kBM * kBK;
  static constexpr int kBStage = kBN * kBK;
  static constexpr int kRing = kStages * (kAStage + kBStage);
  // Accumulator staging: [kBM][kPitch] int32; a pitch of 8 mod 32 words
  // keeps each half-warp's 8-byte stores on distinct banks
  static constexpr int kPitch = kBN + 8;
  static constexpr int kOut = kBM * kPitch * 4;
  // + 1024: the base is rounded up to the swizzle's 1024-byte atom
  static constexpr int kSmem = (kRing > kOut ? kRing : kOut) + 1024;
  // Two blocks an SM where shared memory allows (registers then capped
  // at 128 for 256 threads)
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= 232448 ? 2 : 1;
  static_assert(kBN % kRowStep == 0 && kBM % kRowStep == 0, "tile");
  static_assert(kAhead >= 1, "ring");
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

// The int8 output of one accumulator under epilogue kEpi, with its
// channel's scale and bias
template <int kEpi>
__device__ __forceinline__ int8_t epilogue_one(const ConvArgs& a, int acc,
                                               float scale, float bias) {
  if constexpr (kEpi == kChain) {
    return md_requant(md_silu(md_affine(acc, scale, bias)), a.y_scale);
  } else {
    return exp_epilogue<kEpi>(acc, scale, bias, a.inv_y);
  }
}

// Writes the block's [bm][pitch] int32 tile from shared memory, four
// channels per thread and step: int32 (kEpi < 0) or int8 through kEpi.
// The block size is a multiple of bn / 4, so a thread keeps its four
// channels (and their scale and bias) over all its rows. Rows past M and
// channels past Cout are not stored.
template <int kEpi>
__device__ void store_tile(const ConvArgs& a, const int* tile, int bm,
                           int bn, int pitch, long long m0, int n0,
                           long long m_total) {
  const int units = bn / 4;
  const int col = 4 * (threadIdx.x % units);
  const int n = n0 + col;
  if (n >= a.cout) return;
  const int left = a.cout - n;
  const bool whole = (a.cout & 3) == 0;  // 4-channel stores stay aligned
  float scale[4], bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kEpi >= 0) {
      scale[j] = j < left ? __ldg(a.scale + n + j) : 0.0f;
      bias[j] = j < left ? __ldg(a.bias + n + j) : 0.0f;
    }
  }
  for (int row = threadIdx.x / units; row < bm;
       row += blockDim.x / units) {
    const long long m = m0 + row;
    if (m >= m_total) break;
    const int4 v = *reinterpret_cast<const int4*>(tile + row * pitch + col);
    const int acc[4] = {v.x, v.y, v.z, v.w};
    const size_t o = (size_t)m * a.cout + n;
    if constexpr (kEpi < 0) {
      int* out = static_cast<int*>(a.out) + o;
      if (whole) {
        *reinterpret_cast<int4*>(out) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < left) out[j] = acc[j];
      }
    } else {
      int8_t* out = static_cast<int8_t*>(a.out) + o;
      if (whole) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= (uint32_t)(uint8_t)epilogue_one<kEpi>(a, acc[j], scale[j],
                                                        bias[j])
                  << (8 * j);
        *reinterpret_cast<uint32_t*>(out) = word;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < left)
            out[j] = epilogue_one<kEpi>(a, acc[j], scale[j], bias[j]);
      }
    }
  }
}

template <class T, bool kVec16, bool kRequantIn>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    conv_int8_kernel(const ConvArgs a) {
  constexpr int kBM = T::kBM, kBN = T::kBN, kBK = T::kBK;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  // The swizzle acts on shared address bits 4-9: start on 1024 bytes
  const uint32_t raw = md_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t ring_a = base;
  const uint32_t ring_b = base + kStages * T::kAStage;

  const int t = threadIdx.x;
  const long long m_total = (long long)a.batch * a.ho * a.wo;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int taps = a.kh * a.kw;
  const int nk = taps * ((a.cin + kBK - 1) / kBK);

  // This thread copies chunk cc of rows r0 + kRowStep i of A and B
  const int cc = t % T::kChunks;
  const int r0 = t / T::kChunks;

  // Its A rows' pixels: image offset and top-left input coordinates
  // (rows past M get coordinates that no tap brings into the image)
  long long xoff[T::kARows];
  int iy0[T::kARows], ix0[T::kARows];
#pragma unroll
  for (int i = 0; i < T::kARows; ++i) {
    const long long m = m0 + r0 + T::kRowStep * i;
    const int hw = a.ho * a.wo;
    const long long mm = m < m_total ? m : 0;
    const int b = (int)(mm / hw);
    const int rem = (int)(mm - (long long)b * hw);
    xoff[i] = (long long)b * a.h * a.w * a.cin;
    iy0[i] = m < m_total ? (rem / a.wo) * a.sh - a.pt : -(1 << 29);
    ix0[i] = (rem % a.wo) * a.sw - a.pl;
  }

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

  // Issue the copies of stage (tap, c0) into ring slot [slot]
  auto load = [&](int tap, int c0, int slot) {
    const int ky = tap / a.kw;
    const int kx = tap - ky * a.kw;
    const int c = c0 + 16 * cc;
    const int left = a.cin - c;
#pragma unroll
    for (int i = 0; i < T::kARows; ++i) {
      const int r = r0 + T::kRowStep * i;
      const int iy = iy0[i] + ky;
      const int ix = ix0[i] + kx;
      const bool in = (unsigned)iy < (unsigned)a.h &&
                      (unsigned)ix < (unsigned)a.w;
      const int8_t* src =
          in ? a.x + xoff[i] + ((long long)iy * a.w + ix) * a.cin + c : a.x;
      copy_chunk(ring_a + slot * T::kAStage + md_swizzle<kBK>(r * kBK +
                                                               16 * cc),
                 src, a.x, in ? left : 0);
    }
#pragma unroll
    for (int i = 0; i < T::kBRows; ++i) {
      const int r = r0 + T::kRowStep * i;
      const int n = n0 + r;
      const bool ok = n < a.cout;
      const int8_t* src =
          ok ? a.wt + ((long long)n * taps + tap) * a.cin + c : a.wt;
      copy_chunk(ring_b + slot * T::kBStage + md_swizzle<kBK>(r * kBK +
                                                               16 * cc),
                 src, a.wt, ok ? left : 0);
    }
  };

  // The input requant on this thread's landed A chunks of [slot]
  auto requant = [&](int slot) {
#pragma unroll
    for (int i = 0; i < T::kARows; ++i) {
      const int r = r0 + T::kRowStep * i;
      int4* p = reinterpret_cast<int4*>(
          smem + slot * T::kAStage + md_swizzle<kBK>(r * kBK + 16 * cc));
      int4 v = *p;
      v.x = md_requant_x4(v.x, a.in_ratio);
      v.y = md_requant_x4(v.y, a.in_ratio);
      v.z = md_requant_x4(v.z, a.in_ratio);
      v.w = md_requant_x4(v.w, a.in_ratio);
      *p = v;
    }
  };

  // The next stage to load, as (tap, first channel)
  int ld_stage = 0, ld_tap = 0, ld_c = 0;
  auto load_next = [&]() {
    if (ld_stage < nk) {
      load(ld_tap, ld_c, ld_stage % kStages);
      ld_c += kBK;
      if (ld_c >= a.cin) {
        ld_c = 0;
        ++ld_tap;
      }
      ++ld_stage;
    }
    md_cp_async_commit();  // one group per stage, empty past the end
  };

  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  const int wg = t / 128;

  // Stages 0 .. kAhead - 1 first, then stage s + kAhead at stage s
#pragma unroll
  for (int s = 0; s < T::kAhead; ++s) load_next();
  md_fence_acc(acc);
  for (int s = 0; s < nk; ++s) {
    const int slot = s % kStages;
    md_cp_async_wait<T::kAhead - 1>();  // this thread's copies of stage s
    if constexpr (kRequantIn) requant(slot);
    md_fence_proxy_async();
    __syncthreads();
    load_next();
    const uint64_t da =
        md_smem_desc<kBK>(ring_a + slot * T::kAStage + wg * 64 * kBK);
    const uint64_t db = md_smem_desc<kBK>(ring_b + slot * T::kBStage);
    md_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      MdWgmmaS8<kBN>::mma(acc, da + 2 * kk, db + 2 * kk);
    md_wgmma_commit();
    md_wgmma_wait<1>();
    md_fence_acc(acc);
  }
  md_wgmma_wait<0>();
  md_fence_acc(acc);
  md_cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring

  // Accumulators to shared memory: warp w, lane l of warpgroup wg hold
  // rows 64 wg + 16 w + l / 4 (+ 8), columns 8 j + 2 (l % 4) (+ 1)
  int* tile = reinterpret_cast<int*>(smem);
  const int lane = t % 32;
  const int row = wg * 64 + 16 * ((t % 128) / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<int2*>(tile + (row + 8 * h) * T::kPitch + 8 * j +
                               2 * (lane % 4)) =
          make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  __syncthreads();

  switch (a.epilogue) {
    case kChain:
      if (a.requant) {
        store_tile<kChain>(a, tile, kBM, kBN, T::kPitch, m0, n0, m_total);
      } else {
        store_tile<-1>(a, tile, kBM, kBN, T::kPitch, m0, n0, m_total);
      }
      break;
    case kF32:
      store_tile<kF32>(a, tile, kBM, kBN, T::kPitch, m0, n0, m_total);
      break;
    case kF32NoSilu:
      store_tile<kF32NoSilu>(a, tile, kBM, kBN, T::kPitch, m0, n0, m_total);
      break;
    case kBf16:
      store_tile<kBf16>(a, tile, kBM, kBN, T::kPitch, m0, n0, m_total);
      break;
    default:
      store_tile<kHybrid>(a, tile, kBM, kBN, T::kPitch, m0, n0, m_total);
      break;
  }
}

template <class T, bool kVec16, bool kRequantIn>
int launch(const ConvArgs& a, cudaStream_t stream) {
  const auto kernel = conv_int8_kernel<T, kVec16, kRequantIn>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m_total = (long long)a.batch * a.ho * a.wo;
  const dim3 grid((unsigned)((m_total + T::kBM - 1) / T::kBM),
                  (unsigned)((a.cout + T::kBN - 1) / T::kBN));
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kBK, bool kVec16, bool kRequantIn>
int launch_tile(const ConvArgs& a, int instance, cudaStream_t stream) {
  if (instance & kInstBm128) {
    return instance & kInstBn128
               ? launch<Tile<128, 128, kBK>, kVec16, kRequantIn>(a, stream)
               : launch<Tile<128, 64, kBK>, kVec16, kRequantIn>(a, stream);
  }
  return instance & kInstBn128
             ? launch<Tile<64, 128, kBK>, kVec16, kRequantIn>(a, stream)
             : launch<Tile<64, 64, kBK>, kVec16, kRequantIn>(a, stream);
}

// Launches the instance [instance] names; refuses a code it does not
// know and 16-byte copies of data they would misread
template <bool kRequantIn>
int launch_instance(const ConvArgs& a, int instance, cudaStream_t stream) {
  const long long m_total = (long long)a.batch * a.ho * a.wo;
  if (m_total <= 0 || a.cout <= 0) return 0;
  if (instance < 0 || instance > 15 || a.cin % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(instance & kInstVec16)) {
    if (instance & kInstBk128) return static_cast<int>(cudaErrorInvalidValue);
    return launch_tile<64, false, kRequantIn>(a, instance, stream);
  }
  if (a.cin % 16 != 0 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.wt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return instance & kInstBk128
             ? launch_tile<128, true, kRequantIn>(a, instance, stream)
             : launch_tile<64, true, kRequantIn>(a, instance, stream);
}

ConvArgs make_args(const int8_t* x, const int8_t* w, const float* scale,
                   const float* bias, void* out, int batch, int h, int w_,
                   int cin, int cout) {
  ConvArgs a{};
  a.x = x;
  a.wt = w;
  a.scale = scale;
  a.bias = bias;
  a.out = out;
  a.batch = batch;
  a.h = h;
  a.w = w_;
  a.cin = cin;
  a.cout = cout;
  a.in_ratio = 1.0f;
  a.inv_y = 1.0f;
  return a;
}

}  // namespace

extern "C" {

// [instance]: ops/conv_int8.py conv_tiling's code (Instance bits).
// Launches on [stream]. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an instance the data does not allow.
int md_conv_int8(const int8_t* x, const int8_t* w, const float* scale,
                 const float* bias, void* out, int batch, int h, int w_,
                 int cin, int cout, int kh, int kw, int sh, int sw, int pt,
                 int pl, int ho, int wo, float y_scale, int requant,
                 int instance, void* stream) {
  ConvArgs a = make_args(x, w, scale, bias, out, batch, h, w_, cin, cout);
  a.kh = kh;
  a.kw = kw;
  a.sh = sh;
  a.sw = sw;
  a.pt = pt;
  a.pl = pl;
  a.ho = ho;
  a.wo = wo;
  a.y_scale = y_scale;
  a.requant = requant;
  a.epilogue = kChain;
  return launch_instance<false>(a, instance,
                                static_cast<cudaStream_t>(stream));
}

// The experiments' conv: 3x3, stride 1, SAME (pads 1), int8 out.
// requant_in != 0 requantizes x at in_ratio on the way in; inv_y is
// f32(1 / y_scale); epilogue is kF32, kF32NoSilu, kBf16 or kHybrid;
// [instance] as for md_conv_int8. Launches on [stream]. Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for an
// unknown epilogue or instance.
int md_conv3x3_int8_exp(const int8_t* x, const int8_t* w, const float* scale,
                        const float* bias, void* out, int batch, int h,
                        int w_, int cin, int cout, int requant_in,
                        float in_ratio, float inv_y, int epilogue,
                        int instance, void* stream) {
  if (epilogue < kF32 || epilogue > kHybrid)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a = make_args(x, w, scale, bias, out, batch, h, w_, cin, cout);
  a.kh = a.kw = 3;
  a.sh = a.sw = 1;
  a.pt = a.pl = 1;
  a.ho = h;
  a.wo = w_;
  a.requant = 1;
  a.epilogue = epilogue;
  a.in_ratio = in_ratio;
  a.inv_y = inv_y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return requant_in ? launch_instance<true>(a, instance, s)
                    : launch_instance<false>(a, instance, s);
}

}  // extern "C"
