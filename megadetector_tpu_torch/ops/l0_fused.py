"""
Fused YOLOv5 stem from raw pixels: the CUDA kernel (csrc/l0_fused.cu) and
its plain PyTorch version.

Replaces megadetector_tpu/ops/pallas_l0.py _l0_kernel / l0_fused /
prepare_l0_weights: uint8 images -> /255 -> l0's 6x6 stride-2 conv (pad 2)
-> f32 bias -> SiLU -> bf16, with the /255 folded into bf16 weights. The
TPU kernel works on the width-folded layout ([B, H, W/4, 12] input, a
216-wide im2col with half its taps zero, a folded [B, H/2, W/4, 2C]
output); this one computes the unfolded stem from NHWC bytes as a GEMM on
the tensor cores (mma.sync bf16, K = 108 taps padded to 112) and returns
[B, H/2, W/2, C]. The constants below restate the kernel's tiling for the
CPU tests (tests/test_torch_l0_tiling.py).

The tensor cores sum the 108 products in another order than the plain
version, so kernel and plain version agree within plain_bar, not bit for
bit.

l0_fused takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. It calls the custom operator
mdtorch::l0_fused, one node of a traced graph.
"""

import numpy as np
import torch

from megadetector_tpu_torch.ops import _build

# Kernel launches made by l0_fused (the plain version never counts)
launches = 0

TAPS = 108  # 6 x 6 x 3

# csrc/l0_fused.cu: a tile of TILE_ROWS x TILE_COLS output pixels (K, the
# 108 taps, padded to seven k16 steps), channels GROUP at a time, the bf16
# input patch (PATCH_ROWS rows of PATCH_ELEMS elements, PATCH_STRIDE
# 32-bit words apart), a raw row's 16-byte pieces, a staged pixel's 32-bit
# words
TILE_ROWS = 4
TILE_COLS = 64
GROUP = 64
PATCH_ROWS = 2 * TILE_ROWS + 4
PATCH_ELEMS = (2 * TILE_COLS + 4) * 3
PATCH_STRIDE = 216
RAW_PIECES = 26
STAGE_WORDS = GROUP // 2 + 4

# The kernel's bar against the plain version: each element within one bf16
# ulp of the larger magnitude, or within ABS_FLOOR where the sum cancels
# to near 0, and at most DIFF_SHARE of the elements differing at all
ABS_FLOOR = 1e-5
DIFF_SHARE = 1e-3


def prepare_l0_weights(node):
    """
    The unfolded l0 conv node ({'w': HWIO [6, 6, 3, C], 'b': [C]}, numpy or
    tensors) in kernel form: (bf16(w / 255) as [108, C] with row (ky * 6 +
    kx) * 3 + c, the bias as float32 [C]). The /255 is a float32 division,
    rounded to bf16 nearest-even, as the TPU kernel's weights are.
    """

    w = np.asarray(node['w'], np.float32)
    if w.shape[:3] != (6, 6, 3):
        raise ValueError('prepare_l0_weights needs the unfolded l0 kernel '
                         '[6, 6, 3, C], got {}'.format(w.shape))
    c = w.shape[3]
    w_scaled = torch.from_numpy((w / np.float32(255.0)).reshape(TAPS, c))
    b = torch.from_numpy(np.asarray(node['b'], np.float32).reshape(c).copy())
    return w_scaled.to(torch.bfloat16), b


def _check_geometry(images_u8, w, bias):
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or \
            images_u8.shape[3] != 3:
        raise ValueError('l0_fused: need uint8 images [B, H, W, 3], got {} '
                         '{}'.format(images_u8.dtype, tuple(images_u8.shape)))
    b, h, wd, _ = images_u8.shape
    if h % 2 or wd % 2 or h == 0 or wd == 0:
        raise ValueError('l0_fused: H and W must be even and positive, got '
                         '{}x{}'.format(h, wd))
    if w.dim() != 2 or w.shape[0] != TAPS or w.dtype != torch.bfloat16:
        raise ValueError('l0_fused: need bf16 weights [108, C], got {} {}'
                         .format(w.dtype, tuple(w.shape)))
    c = w.shape[1]
    if bias.dtype != torch.float32 or tuple(bias.shape) != (c,):
        raise ValueError('l0_fused: need a float32 bias [{}]'.format(c))
    return b, h, wd, c


def l0_fused_reference(images_u8, w, bias):
    """
    Plain version: the 108 taps summed in float32 in the fixed (ky, kx, c)
    order, one add per tap (each uint8 x bf16 product is exact), then the
    bias, then y * sigmoid(y), rounded once to bf16.
    """

    b, h, wd, c = _check_geometry(images_u8, w, bias)
    ho, wo = h // 2, wd // 2
    xp = torch.nn.functional.pad(images_u8.permute(0, 3, 1, 2).float(),
                                 (2, 2, 2, 2))
    wf = w.float()
    acc = torch.zeros((b, ho, wo, c), dtype=torch.float32,
                      device=images_u8.device)
    for ky in range(6):
        for kx in range(6):
            for ch in range(3):
                tap = xp[:, ch, ky:ky + 2 * ho:2, kx:kx + 2 * wo:2]
                acc.addcmul_(tap[..., None], wf[(ky * 6 + kx) * 3 + ch])
    y = acc + bias
    return (y * torch.sigmoid(y)).to(torch.bfloat16)


def plain_bar(got, ref):
    """
    The kernel's output against the plain version's (bf16 tensors of one
    shape): (elements that differ, largest |difference|, elements outside
    the bar: more than one bf16 ulp of the larger magnitude and more than
    ABS_FLOOR). The kernel passes when the last is 0 and the first is at
    most DIFF_SHARE of the elements.
    """

    a, b = got.float(), ref.float()
    diff = (a - b).abs()
    # one bf16 ulp of m = mant * 2^e (mant in [0.5, 1)) is 2^(e - 8)
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(diff), e - 8)
    outside = (diff > ulp) & (diff > ABS_FLOOR)
    return (int((diff > 0).sum()), float(diff.max()) if diff.numel() else
            0.0, int(outside.sum()))


def l0_fused(images_u8, w, bias):
    """
    l0 conv + bias + SiLU of YOLOv5 from raw pixels.

    Args:
        images_u8: [B, H, W, 3] uint8 (H, W even)
        w, bias: from prepare_l0_weights ([108, C] bf16 with C a multiple
            of 8 and at most 256 on the card; [C] float32)

    Returns:
        [B, H/2, W/2, C] bf16 (NHWC, contiguous)

    CPU tensors run the plain version. CUDA tensors run the kernel (built
    at first use); anything else raises.
    """

    if images_u8.device.type not in ('cpu', 'cuda'):
        raise ValueError('l0_fused: images on {}; need the CPU or a CUDA '
                         'device'.format(images_u8.device))
    return torch.ops.mdtorch.l0_fused(images_u8, w, bias)


@torch.library.custom_op('mdtorch::l0_fused', mutates_args=(),
                         device_types='cpu')
def _l0_fused_op(images_u8: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    return l0_fused_reference(images_u8, w, bias)


@_l0_fused_op.register_fake
def _l0_fused_fake(images_u8, w, bias):
    b, h, wd, c = _check_geometry(images_u8, w, bias)
    return images_u8.new_empty((b, h // 2, wd // 2, c), dtype=torch.bfloat16)


@_l0_fused_op.register_kernel('cuda')
def _l0_fused_cuda(images_u8, w, bias):
    global launches

    if images_u8.device.type != 'cuda':
        raise ValueError('l0_fused: images on {}; need the CPU or a CUDA '
                         'device'.format(images_u8.device))
    b, h, wd, c = _check_geometry(images_u8, w, bias)
    if c % 8 or c > 256:
        raise ValueError('l0_fused: C={} must be a multiple of 8 and at '
                         'most 256'.format(c))
    tensors = (images_u8, w, bias)
    if any(t.device != images_u8.device for t in tensors):
        raise ValueError('l0_fused: tensors on {}; need one device'.format(
            [str(t.device) for t in tensors]))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('l0_fused: inputs must be contiguous')
    out = torch.empty((b, h // 2, wd // 2, c), dtype=torch.bfloat16,
                      device=images_u8.device)
    if out.numel() == 0:
        return out

    lib = _build.load_library()
    with torch.cuda.device(images_u8.device):
        err = lib.md_l0_fused(
            images_u8.data_ptr(), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, wd, c,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, 'md_l0_fused')
    launches += 1
    return out
