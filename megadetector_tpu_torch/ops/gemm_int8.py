"""
int8 GEMM of the int8 experiments: the CUDA kernel (csrc/gemm_int8.cu)
and its plain PyTorch version.

Replaces experiments/exp_pallas_int8_chain.py _mm_kernel and
_mm_kernel_fused (E5) and experiments/exp_pallas_int8_matmul.py
_mm_kernel and _mm_kernel_acc (E6): [M, K] int8 @ [K, N] int8 -> int32,
or int8 through clamp(round(f32(acc) * f32(requant_scale)), -127, 127).
Full-K blocks and the k-loop are TPU schedules of that one function. The
kernel is persistent and warp-specialised: one producer thread fills a
ring of shared-memory stages with TMA loads, and two consumer warpgroups
take the block's 128 x 128 output tiles in turn, each running wgmma s8
on its tile's stages while the other stores its last tile through
shared memory (TMA stores from swizzled staging for the int8 output
where its rows are 16-byte multiples, element stores otherwise);
gemm_tiling gives the
padding and the grid of each call. See the source note for what bounds
it.

int8 wgmma reads b K-major, so a call also runs a transpose pre-pass
(b -> bt [N, Kp], K zero-padded to Kp) and, where TMA cannot read a in
place (K % 16 != 0, or a not 16-byte aligned), a pad pre-pass (a -> [M,
Kp]), both into scratch this module allocates. The profiler therefore
shows two or three kernels a call; `launches` counts the call once.

gemm_int8 takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises.
"""

import collections

import numpy as np
import torch

from megadetector_tpu_torch.ops import _build
from megadetector_tpu_torch.ops.conv_int8 import SMS, multiply_to_int8

# Kernel launches made by gemm_int8, one a call, pre-passes included (the
# plain version never counts)
launches = 0

# csrc/gemm_int8.cu's output tile
BM = 128
BN = 128

GemmTiling = collections.namedtuple('GemmTiling', 'kp pad_a tiles_n tiles grid')


def padded_k(k):
    """Kp: K rounded up to 16 bytes (TMA's row stride), at least 16."""

    return max(16, -(-k // 16) * 16)


def gemm_tiling(m, k, n, aligned=True):
    """
    The GEMM kernel's launch for [M, K] @ [K, N]:

        kp     padded_k(K), the K extent of bt and of the padded A
        pad_a  a goes through the pad pre-pass: Kp != K (K % 16 != 0,
               or K = 0), or a not 16-byte aligned ([aligned] False)
        tiles_n, tiles  the 128 x 128 output tiles, N index fastest
        grid   the persistent blocks: min(tiles, SMS), one an SM

    Returns a GemmTiling.
    """

    kp = padded_k(k)
    tiles_n = -(-n // BN)
    tiles = -(-m // BM) * tiles_n
    return GemmTiling(kp, kp != k or not aligned, tiles_n, tiles,
                      min(tiles, SMS))


def gemm_int8_reference(a, b, requant_scale=None):
    """Plain version of gemm_int8: the product in float64, exact below
    2^53 (|acc| <= K * 128^2), then the requant in float32."""

    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)
    if requant_scale is None:
        return acc
    return multiply_to_int8(acc.to(torch.float32), requant_scale)


def gemm_int8(a, b, requant_scale=None):
    """
    Args:
        a: [M, K] int8, row-major
        b: [K, N] int8, row-major
        requant_scale: None for int32 out, or a Python float: int8 out at
            clamp(round(f32(acc) * f32(requant_scale)), -127, 127)

    Returns:
        [M, N] int32, or int8 when requant_scale is given

    CPU tensors run the plain version. CUDA tensors run the kernel (built
    at first use); anything else raises.
    """

    global launches

    if a.device.type == 'cpu' and b.device.type == 'cpu':
        return gemm_int8_reference(a, b, requant_scale)
    if a.device.type != 'cuda' or b.device != a.device:
        raise ValueError('gemm_int8: a on {}, b on {}; need both on the CPU '
                         'or on one CUDA device'.format(a.device, b.device))
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError('gemm_int8: need int8 a and b, got {} and {}'.format(
            a.dtype, b.dtype))
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError('gemm_int8: need a [M, K] and b [K, N], got {} and '
                         '{}'.format(tuple(a.shape), tuple(b.shape)))
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError('gemm_int8: a and b must be contiguous')
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), device=a.device, dtype=torch.int32
                      if requant_scale is None else torch.int8)
    if out.numel() == 0:
        return out
    scale = 0.0 if requant_scale is None else float(np.float32(requant_scale))
    tiling = gemm_tiling(m, k, n, a.data_ptr() % 16 == 0)
    bt = torch.empty((n, tiling.kp), device=a.device, dtype=torch.int8)
    ap = (torch.empty((m, tiling.kp), device=a.device, dtype=torch.int8)
          if tiling.pad_a else None)

    lib = _build.load_library()
    with torch.cuda.device(a.device):
        err = lib.md_gemm_int8(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bt.data_ptr(),
            None if ap is None else ap.data_ptr(), m, n, k,
            int(requant_scale is not None), scale, tiling.grid,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, 'md_gemm_int8')
    launches += 1
    return out
