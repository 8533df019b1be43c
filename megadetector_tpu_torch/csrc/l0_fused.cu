// Fused YOLOv5 stem for Hopper (sm_90a): raw uint8 pixels -> /255 -> 6x6
// stride-2 conv (pad 2) -> bias -> SiLU -> bf16, in one pass.
//
// Replaces the TPU kernel megadetector_tpu/ops/pallas_l0.py _l0_kernel /
// l0_fused (with prepare_l0_weights), whose contract is l0's conv + bias +
// SiLU on images normalised to [0, 1]:
//
//   acc[b, oy, ox, n] = sum over t = (ky * 6 + kx) * 3 + c of
//                       x[b, 2*oy - 2 + ky, 2*ox - 2 + kx, c] * w[t, n]
//   out = bf16(silu(acc + bias[n]))
//
// x is uint8 NHWC [B, H, W, 3] (zero outside the image), w = bf16(w_l0 /
// 255) as [108, C] (the /255 folded into the weights, as on the TPU), bias
// f32 [C], out bf16 NHWC [B, H/2, W/2, C]. The TPU kernel computed the
// width-folded view ([B, H, W/4, 12] input, 216 taps of which half are
// zero, one MXU matmul per band) to fit its 128-lane tiles; none of that
// carries over. Here the stem is a GEMM straight from the NHWC bytes: M =
// output pixels, N = C, K = the 108 real taps padded to 112 (seven k16
// steps; the weights of taps 108-111 are zero).
//
// What bounds it on this card: bytes and the epilogue, not the MMAs. At
// [8, 960, 1280, 3] -> [8, 480, 640, 64] it reads 29.5 MB and writes 314.6
// MB (0.103 ms at 3.35 TB/s), and SiLU costs an expf and an IEEE division
// for each of 157 M outputs (~0.1-0.2 ms of issue); the 17.0 G MAC take
// ~0.03 ms on the tensor cores. The design:
//   - The taps run on mma.sync m16n8k16 bf16 -> f32 (not wgmma: the A
//     operand is gathered per thread from a shifted input patch, which
//     mma.sync takes from registers with no shared-memory layout to meet,
//     and the MMA rate is not what bounds the kernel). A uint8 is exact in
//     bf16 and each product is exact in f32; only the order of the f32
//     sums differs from the plain version's sequential (ky, kx, c) order.
//   - A persistent block (256 threads, two an SM) walks tiles of 4 output
//     rows x 64 output columns. The input patch of a tile (12 rows x 132
//     pixels x 3 bytes) is fetched with 16-byte cp.async into a two-stage
//     ring, over-fetching each row to a 16-byte start, while the tile
//     before it is computed; then it is converted once to bf16 in shared
//     memory (zeros outside the image), so no fragment converts a byte.
//   - Tap t = 18 ky + r (r = 3 kx + c) of an output pixel lies r elements
//     past the pixel's base in patch row ky. The K order is the kernel's
//     own (the sums' order is free): k16 step s < 6 holds taps r = 0..15
//     of row ky = s, and step 6 the six pairs r = 16, 17 of rows 0-5 and
//     two zero-weight pairs. So every pair of taps an A fragment register
//     holds (2q, 2q + 1 and 2q + 8, 2q + 9 of a step) is one aligned 32-bit
//     load from one patch row: per thread, 14 tap offsets are computed
//     once, and an A register is one ld.shared of base + offset. Patch
//     rows are 216 words apart (396 elements used): 216 = 24 mod 32 keeps
//     step 6, whose lanes read four rows, free of bank conflicts.
//   - The weights, rearranged once per block into B-fragment order ([7]
//     [C/8][32 lanes] x 8 bytes, zero past C and for the pad pairs), stay in
//     shared memory; each warp computes 32 pixels x 64 channels at a time
//     (two m16 tiles share every B load).
//   - The epilogue is md_silu (int8_epilogue.cuh) on __fadd_rn(acc,
//     bias), rounded to bf16, staged per warp in shared memory (pixel
//     rows of 144 bytes: no bank conflicts) and written out with
//     coalesced 16-byte stores.
// The plain version (ops/l0_fused.py l0_fused_reference) sums in the
// sequential order; the two agree within 1 bf16 ulp (or 1e-5) on a small
// share of elements (ops/l0_fused.py plain_bar).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "wgmma_int8.cuh"

namespace {

constexpr int kTR = 4;                          // output rows a tile
constexpr int kTC = 64;                         // output columns a tile
constexpr int kThreads = 256;                   // warp w: row w / 2, 32 columns
constexpr int kSteps = 7;                       // k16 steps, K = 112
constexpr int kGroup = 64;                      // channels a pass (8 n8 tiles)
constexpr int kPatchRows = 2 * kTR + 4;         // 12 input rows
constexpr int kPatchElems = (2 * kTC + 4) * 3;  // 396 bf16 a patch row
constexpr int kPatchWords = kPatchElems / 2;    // 198 bf16 pairs used
constexpr int kPatchStride = 216;               // words a patch row
constexpr int kRawPieces = 26;                  // 16-byte pieces a raw row
constexpr int kRawStride = 16 * kRawPieces;     // covers 396 from any start
constexpr int kStageWords = kGroup / 2 + 4;     // 36 words a staged pixel

struct StemArgs {
  const uint8_t* x;
  const __nv_bfloat16* w;
  const float* bias;
  __nv_bfloat16* out;
  int batch, h, w_in, ho, wo, c, cp;  // cp = C rounded up to kGroup
  int tiles_x, tiles_y, n_tiles;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// First tap (18 ky + r) of the pair that register half j (0: k 2q, 2q + 1;
// 1: k 2q + 8, 2q + 9) of k16 step s holds, or -1 for a pad pair
__device__ __forceinline__ int step_tap(int s, int j, int q) {
  if (s < 6) return 18 * s + 8 * j + 2 * q;
  const int pair = 4 * j + q;
  return pair < 6 ? 18 * pair + 16 : -1;
}

__device__ __forceinline__ void tile_origin(const StemArgs& a, int tile,
                                            int& b, int& oy0, int& ox0) {
  const int per_image = a.tiles_y * a.tiles_x;
  b = tile / per_image;
  const int rem = tile - b * per_image;
  oy0 = (rem / a.tiles_x) * kTR;
  ox0 = (rem % a.tiles_x) * kTC;
}

// Byte offset (from x) of patch row r's first byte, and its distance past
// the 16-byte boundary below it (the raw row starts there)
__device__ __forceinline__ long long patch_row_start(const StemArgs& a,
                                                     int b, int iy, int ox0,
                                                     int& lead) {
  const long long g0 =
      ((long long)(b * a.h + iy) * a.w_in + 2 * ox0 - 2) * 3;
  lead = (int)(((long long)(uintptr_t)a.x + g0) & 15);
  return g0;
}

// The raw bytes of a tile's patch rows inside the image, into one ring
// stage. A piece that is only partly inside the tensor is copied byte by
// byte; bytes outside the image are zeroed later by coordinates.
__device__ void stem_prefetch(const StemArgs& a, int tile, uint8_t* raw) {
  int b, oy0, ox0;
  tile_origin(a, tile, b, oy0, ox0);
  const long long total = (long long)a.batch * a.h * a.w_in * 3;
  for (int i = threadIdx.x; i < kPatchRows * kRawPieces; i += kThreads) {
    const int r = i / kRawPieces;
    const int p = i - r * kRawPieces;
    const int iy = 2 * oy0 - 2 + r;
    if (iy < 0 || iy >= a.h) continue;
    int lead;
    const long long src = patch_row_start(a, b, iy, ox0, lead) - lead + 16 * p;
    if (16 * p >= lead + kPatchElems) continue;  // past the row's span
    uint8_t* dst = raw + r * kRawStride + 16 * p;
    if (src >= 0 && src + 16 <= total) {
      md_cp_async16(md_smem_addr(dst), a.x + src, 16);
    } else {
      for (int e = 0; e < 16; ++e)
        if (src + e >= 0 && src + e < total) dst[e] = a.x[src + e];
    }
  }
}

// The raw stage -> the bf16 patch (pairs of elements as 32-bit words)
__device__ void stem_convert(const StemArgs& a, int tile, const uint8_t* raw,
                             uint32_t* patch) {
  int b, oy0, ox0;
  tile_origin(a, tile, b, oy0, ox0);
  for (int i = threadIdx.x; i < kPatchRows * kPatchWords; i += kThreads) {
    const int r = i / kPatchWords;
    const int p = i - r * kPatchWords;
    const int iy = 2 * oy0 - 2 + r;
    uint32_t packed = 0;
    if (iy >= 0 && iy < a.h) {
      int lead;
      patch_row_start(a, b, iy, ox0, lead);
      const uint8_t* row = raw + r * kRawStride + lead;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * p + h;
        const int ix = 2 * ox0 - 2 + e / 3;
        // a byte is exact in bf16: the f32's low 16 bits are zero
        if (ix >= 0 && ix < a.w_in)
          packed |= (__float_as_uint((float)row[e]) >> 16) << (16 * h);
      }
    }
    patch[r * kPatchStride + p] = packed;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    l0_fused_kernel(const StemArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n8 = a.cp / 8;  // n8 tiles of all channels
  uint32_t* bfrag = reinterpret_cast<uint32_t*>(smem);  // [7][n8][32][2]
  float* bias_s = reinterpret_cast<float*>(smem + kSteps * n8 * 256);
  uint32_t* patch = reinterpret_cast<uint32_t*>(bias_s + a.cp);
  uint8_t* raw = reinterpret_cast<uint8_t*>(patch + kPatchRows * kPatchStride);
  uint32_t* staged = reinterpret_cast<uint32_t*>(
      raw + 2 * kPatchRows * kRawStride);  // [8 warps][32 pixels][36]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;

  int tile = blockIdx.x;
  stem_prefetch(a, tile, raw);
  md_cp_async_commit();

  // Weights in B-fragment order: lane (g, q) of n8 tile j at step s holds
  // the taps of step_tap(s, 0, q) and step_tap(s, 1, q) (and the tap after
  // each) of channel 8 j + g
  for (int i = tid; i < kSteps * n8 * 32; i += kThreads) {
    const int s = i / (n8 * 32);
    const int rem = i - s * n8 * 32;
    const int n = 8 * (rem >> 5) + ((rem & 31) >> 2);
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t0 = step_tap(s, e >> 1, rem & 3);
      v[e] = (t0 >= 0 && n < a.c)
                 ? (uint32_t)__bfloat16_as_ushort(a.w[(t0 + (e & 1)) * a.c + n])
                 : 0u;
    }
    bfrag[2 * i] = v[0] | (v[1] << 16);
    bfrag[2 * i + 1] = v[2] | (v[3] << 16);
  }
  for (int n = tid; n < a.cp; n += kThreads)
    bias_s[n] = n < a.c ? a.bias[n] : 0.0f;

  // This thread's 14 tap-pair offsets (32-bit words into the patch); a
  // pad pair reads lane (g, q - 2)'s word (a broadcast) under zero weights
  int toff[kSteps][2];
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int t = step_tap(s, j, q);
      if (t < 0) t = step_tap(s, j, q - 2);
      toff[s][j] = (t / 18) * kPatchStride + (t % 18) / 2;
    }
  // Word of pixel column ocol + 16 mi + g + 8 h of tile row orow
  const int orow = warp >> 1;
  const int ocol = (warp & 1) * 32;
  int pbase[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pbase[mi][h] = 2 * orow * kPatchStride + 3 * (ocol + 16 * mi + g + 8 * h);

  const uint2* bf2 = reinterpret_cast<const uint2*>(bfrag);
  uint32_t* my_stage = staged + warp * 32 * kStageWords;

  for (int it = 0; tile < a.n_tiles; ++it) {
    const int next = tile + gridDim.x;
    if (next < a.n_tiles)
      stem_prefetch(a, next, raw + ((it + 1) & 1) * kPatchRows * kRawStride);
    md_cp_async_commit();
    md_cp_async_wait<1>();
    __syncthreads();  // this tile's bytes landed; the patch is free
    stem_convert(a, tile, raw + (it & 1) * kPatchRows * kRawStride, patch);
    __syncthreads();

    int b, oy0, ox0;
    tile_origin(a, tile, b, oy0, ox0);
    const int oy = oy0 + orow;
    for (int grp = 0; grp * kGroup < a.c; ++grp) {
      float acc[2][8][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;

#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          af[mi][0] = patch[pbase[mi][0] + toff[s][0]];
          af[mi][1] = patch[pbase[mi][1] + toff[s][0]];
          af[mi][2] = patch[pbase[mi][0] + toff[s][1]];
          af[mi][3] = patch[pbase[mi][1] + toff[s][1]];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint2 bb = bf2[(s * n8 + grp * 8 + j) * 32 + lane];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][j], af[mi], bb);
        }
      }

      // Epilogue: D[g (+8)][2q (+1)] of each m16n8 tile -> staged pixels
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = grp * kGroup + 8 * j + 2 * q;
        const float b0 = bias_s[n];
        const float b1 = bias_s[n + 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(
                md_silu(__fadd_rn(acc[mi][j][2 * h], b0))));
            const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(
                md_silu(__fadd_rn(acc[mi][j][2 * h + 1], b1))));
            my_stage[(16 * mi + g + 8 * h) * kStageWords + 4 * j + q] =
                lo | (hi << 16);
          }
      }
      __syncwarp();
      const int pieces = min(kGroup, a.c - grp * kGroup) / 8;
      for (int i = lane; i < 32 * pieces; i += 32) {
        const int p = i / pieces;
        const int j = i - p * pieces;
        const int ox = ox0 + ocol + p;
        if (ox < a.wo && oy < a.ho)
          *reinterpret_cast<uint4*>(
              a.out + (((size_t)b * a.ho + oy) * a.wo + ox) * a.c +
              grp * kGroup + 8 * j) =
              *reinterpret_cast<const uint4*>(my_stage + p * kStageWords +
                                              4 * j);
      }
      __syncwarp();
    }
    tile = next;
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
  StemArgs a{static_cast<const uint8_t*>(x),
             static_cast<const __nv_bfloat16*>(w), bias,
             static_cast<__nv_bfloat16*>(out), batch, h, w_in, ho, wo, c,
             (c + kGroup - 1) / kGroup * kGroup, 0, 0, 0};
  a.tiles_x = (wo + kTC - 1) / kTC;
  a.tiles_y = (ho + kTR - 1) / kTR;
  a.n_tiles = batch * a.tiles_y * a.tiles_x;
  // B fragments, bias, bf16 patch, two raw stages, eight warps' staging
  const size_t smem = (size_t)kSteps * (a.cp / 8) * 256 + 4 * a.cp +
                      4 * kPatchRows * kPatchStride +
                      2 * kPatchRows * kRawStride +
                      4 * 8 * 32 * kStageWords;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(l0_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, l0_fused_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = a.n_tiles < slots ? a.n_tiles : slots;
  l0_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
