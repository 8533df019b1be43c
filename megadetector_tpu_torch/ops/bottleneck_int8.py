"""
Fused int8 CSP bottleneck (1x1 C->C, 3x3 C->C SAME, optional residual):
the CUDA kernel (csrc/bottleneck_int8.cu) and its plain PyTorch version.

Replaces megadetector_tpu/ops/pallas_bottleneck.py bottleneck_chain /
_kernel ('taps' schedule). The kernel runs both convs on the int8 tensor
cores (wgmma) and keeps the int8 h1 tile (with its one-pixel halo) in
shared memory, so h1 never reaches device memory; see the source note for
the design and what bounds it. Its output is the unfused chain's, bit for
bit: the plain version IS the unfused chain (conv_int8_reference twice,
then qt_add's dequant-add-requant).

kernel_tiling picks the kernel's instance from C and alignment, or None
where the kernel cannot run (C not a multiple of 4, or an h1 tile too
large for shared memory). bottleneck_tiling adds the grid: None also where
the 16 x 8 pixel tiles would leave most of the card idle. The model
(models/yolov5.py Bottleneck) runs the unfused convs wherever
bottleneck_tiling is None, decided from the shape before any launch.

bottleneck_int8 takes the plain version only for tensors on the CPU. For
CUDA tensors it launches the kernel or raises. It calls the custom
operator mdtorch::bottleneck_int8, one node of a traced graph.
"""

import collections

import torch

from megadetector_tpu_torch.ops import _build
from megadetector_tpu_torch.ops.conv_int8 import (SMS, conv_int8_reference,
                                                  round_to_int8,
                                                  scalar_like)

# Kernel launches made by bottleneck_int8 (the plain version never counts)
launches = 0

# csrc/bottleneck_int8.cu: the output tile (rows, columns) a block owns,
# its halo's pixels, the ring's bytes, the K bytes of a stage, the
# 1024-byte alignment slack, and the shared memory a block may use on sm_90
TILE = (16, 8)
HALO_PIXELS = (TILE[0] + 2) * (TILE[1] + 2)
RING_BYTES = 64 * 1024
BK = 64
_ALIGN = 1024
MAX_SMEM = 232448

# csrc/bottleneck_int8.cu's instance bits
INST_VEC16, INST_BN128 = 1, 2

# Fewer blocks than this leave more than half the SMs idle for the whole
# launch; bottleneck_tiling routes such shapes to the unfused convs, whose
# grids split the same pixels into 64-row tiles
MIN_BLOCKS = SMS // 2

BottleneckTiling = collections.namedtuple('BottleneckTiling',
                                          'bn vec smem code')


def smem_bytes(c):
    """Shared memory of one block at C channels: the ring (whose start
    also holds phase 2's staging tile) and h1 [180 pixels][C rounded up to
    BK] (csrc/bottleneck_int8.cu smem_bytes)."""

    return _ALIGN + RING_BYTES + HALO_PIXELS * (-(-c // BK) * BK)


def kernel_tiling(c, aligned16=True):
    """
    The kernel's instance for C channels:

        vec 16 (16-byte copies and stores) when C % 16 == 0 and the
            tensors are 16-byte aligned ([aligned16]), else 4
        bn  64 when C <= 64, else 128 (output channels an N chunk)

    Returns a BottleneckTiling (with the block's shared memory and the
    kernel's instance code), or None where the kernel cannot run: C not a
    positive multiple of 4, or a block over MAX_SMEM (C above 896).
    """

    if c <= 0 or c % 4:
        return None
    vec = 16 if c % 16 == 0 and aligned16 else 4
    bn = 64 if c <= 64 else 128
    smem = smem_bytes(c)
    if smem > MAX_SMEM:
        return None
    code = ((INST_VEC16 if vec == 16 else 0) |
            (INST_BN128 if bn == 128 else 0))
    return BottleneckTiling(bn, vec, smem, code)


def bottleneck_grid(b, h, w):
    """Blocks of the kernel's grid for a [b, h, w] image batch."""

    return b * -(-h // TILE[0]) * -(-w // TILE[1])


def bottleneck_tiling(b, h, w, c):
    """The kernel's tiling for a [b, h, w, c] bottleneck, or None where it
    cannot beat the two unfused conv launches: kernel_tiling is None, or
    the grid has fewer than MIN_BLOCKS blocks (at 960x1280 and 768x1280,
    batch 8: the C = 512 level, 24 blocks). Splitting N over blocks would
    recompute h1 once per split, so small grids are routed, not split."""

    tiling = kernel_tiling(c)
    if tiling is None or bottleneck_grid(b, h, w) < MIN_BLOCKS:
        return None
    return tiling


def residual_requant(x_q, s_in, h_q, h_scale):
    """qt_add's arithmetic: x * s_in + h * h_scale, each product rounded to
    float32, requantized at the bound scale s_in + h_scale (the Python-float
    sum). Returns (int8 tensor, scale)."""

    out_scale = s_in + h_scale
    y = x_q.to(torch.float32) * scalar_like(s_in, x_q) + \
        h_q.to(torch.float32) * scalar_like(h_scale, h_q)
    return round_to_int8(y, out_scale), out_scale


def bottleneck_int8_reference(x_q, w1, scale1, bias1, mid_scale, w2, scale2,
                              bias2, cv2_scale, s_in, shortcut):
    """Plain version of bottleneck_int8 (same arguments): the unfused
    chain."""

    h1 = conv_int8_reference(x_q, w1, scale1, bias1, (1, 1), (0, 0, 0, 0),
                             mid_scale)
    h2 = conv_int8_reference(h1, w2, scale2, bias2, (1, 1), (1, 1, 1, 1),
                             cv2_scale)
    if not shortcut:
        return h2, cv2_scale
    return residual_requant(x_q, s_in, h2, cv2_scale)


def bottleneck_int8(x_q, w1, scale1, bias1, mid_scale, w2, scale2, bias2,
                    cv2_scale, s_in, shortcut):
    """
    Fused int8 bottleneck: h = silu-conv1x1(x) at mid_scale; h =
    silu-conv3x3(h) at cv2_scale; out = qt_add(x, h) or h.

    Args:
        x_q: [B, H, W, C] int8 at scale s_in (on the card C a multiple
            of 4 that kernel_tiling takes: up to 896)
        w1: [C, 1, 1, C] int8; scale1 [C] f32 = w1_scale * s_in; bias1 [C]
        mid_scale: cv1's y_scale (Python float)
        w2: [C, 3, 3, C] int8; scale2 [C] f32 = w2_scale * mid_scale;
            bias2 [C]
        cv2_scale: cv2's y_scale; s_in: x's scale; shortcut: bool

    Returns:
        ([B, H, W, C] int8, scale): scale is s_in + cv2_scale with the
        shortcut, else cv2_scale (qt_add's bound scale)

    CPU tensors run the plain version. CUDA tensors run the kernel (built
    at first use); anything else raises.
    """

    if x_q.device.type not in ('cpu', 'cuda'):
        raise ValueError('bottleneck_int8: tensors on {}; need the CPU or '
                         'one CUDA device'.format(x_q.device))
    out_scale = (s_in + cv2_scale) if shortcut else cv2_scale
    out = torch.ops.mdtorch.bottleneck_int8(
        x_q, w1, scale1, bias1, float(mid_scale), w2, scale2, bias2,
        float(cv2_scale), float(s_in), bool(shortcut))
    return out, out_scale


@torch.library.custom_op('mdtorch::bottleneck_int8', mutates_args=(),
                         device_types='cpu')
def _bottleneck_int8_op(x_q: torch.Tensor, w1: torch.Tensor,
                        scale1: torch.Tensor, bias1: torch.Tensor,
                        mid_scale: float, w2: torch.Tensor,
                        scale2: torch.Tensor, bias2: torch.Tensor,
                        cv2_scale: float, s_in: float,
                        shortcut: bool) -> torch.Tensor:
    return bottleneck_int8_reference(x_q, w1, scale1, bias1, mid_scale, w2,
                                     scale2, bias2, cv2_scale, s_in,
                                     shortcut)[0]


@_bottleneck_int8_op.register_fake
def _bottleneck_int8_fake(x_q, w1, scale1, bias1, mid_scale, w2, scale2,
                          bias2, cv2_scale, s_in, shortcut):
    return torch.empty_like(x_q)


@_bottleneck_int8_op.register_kernel('cuda')
def _bottleneck_int8_cuda(x_q, w1, scale1, bias1, mid_scale, w2, scale2,
                          bias2, cv2_scale, s_in, shortcut):
    global launches

    args = (x_q, w1, scale1, bias1, w2, scale2, bias2)
    if x_q.device.type != 'cuda' or any(t.device != x_q.device
                                        for t in args):
        raise ValueError('bottleneck_int8: tensors on {}; need the CPU or '
                         'one CUDA device'.format(
                             [str(t.device) for t in args]))
    b, h, w, c = x_q.shape
    if x_q.dtype != torch.int8 or w1.dtype != torch.int8 or \
            w2.dtype != torch.int8:
        raise ValueError('bottleneck_int8: x, w1 and w2 must be int8')
    if tuple(w1.shape) != (c, 1, 1, c) or tuple(w2.shape) != (c, 3, 3, c):
        raise ValueError('bottleneck_int8: need w1 [C, 1, 1, C] and w2 [C, '
                         '3, 3, C] for C={}, got {} and {}'.format(
                             c, tuple(w1.shape), tuple(w2.shape)))
    for t in (scale1, bias1, scale2, bias2):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError('bottleneck_int8: scales and biases must be '
                             'float32 [C]')
    if c % 4 != 0:
        raise ValueError('bottleneck_int8: C={} is not a multiple of 4'
                         .format(c))
    if not all(t.is_contiguous() for t in args):
        raise ValueError('bottleneck_int8: inputs must be contiguous')
    if x_q.data_ptr() % 4 or w1.data_ptr() % 4 or w2.data_ptr() % 4:
        raise ValueError('bottleneck_int8: x, w1 and w2 must be 4-byte '
                         'aligned')
    tiling = kernel_tiling(c, all(t.data_ptr() % 16 == 0
                                  for t in (x_q, w1, w2)))
    if tiling is None:
        raise ValueError('bottleneck_int8: C={} does not fit the h1 tile in '
                         'shared memory ({} bytes a block, {} allowed)'
                         .format(c, smem_bytes(c), MAX_SMEM))

    out_scale = (s_in + cv2_scale) if shortcut else cv2_scale
    out = torch.empty_like(x_q)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x_q.device):
        err = lib.md_bottleneck_int8(
            x_q.data_ptr(), w1.data_ptr(), scale1.data_ptr(),
            bias1.data_ptr(), float(mid_scale), w2.data_ptr(),
            scale2.data_ptr(), bias2.data_ptr(), float(cv2_scale),
            float(s_in), float(out_scale), int(bool(shortcut)),
            out.data_ptr(), b, h, w, c, tiling.code,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, 'md_bottleneck_int8')
    launches += 1
    return out
