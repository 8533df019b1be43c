"""
bf16 conv epilogue (optional per-channel bias add, then SiLU): the CUDA
kernel (csrc/silu_bf16.cu) and its plain PyTorch version.

Replaces experiments/exp_pallas_l0_retry.py _bf16_kernel, x * sigmoid(x)
in bf16, which is the activation megadetector_tpu/models/yolov5.py _conv
applies after every float conv of a bf16 detector. The JAX graph rounds to
bf16 after each op (the conv, + b, exp, 1 +, 1 /, *): XLA lowers every bf16
jnp op to an f32 op and a convert. Both versions here round at the same
points, so they agree with the JAX activation bit for bit, except where
XLA on the CPU flushes a subnormal intermediate to zero (results below
2^-126 in magnitude).

silu_bf16 takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises.
"""

import torch

from megadetector_tpu_torch.ops import _build

# Kernel launches made by silu_bf16 (the plain version never counts)
launches = 0


def _channel_view(bias, x):
    """[C] bias shaped to broadcast over [x]'s channel dimension (1 of an
    NCHW-indexed tensor, whatever its memory format)."""

    if x.dim() < 2:
        return bias
    return bias.view((1, -1) + (1,) * (x.dim() - 2))


def silu_bf16_reference(x, bias=None):
    """Plain version: [x] (+ bias over dim 1) then SiLU, as a chain of bf16
    torch ops, each computed in float and rounded to bf16."""

    y = x if bias is None else x + _channel_view(bias, x)
    return y * torch.reciprocal(1 + torch.exp(-y))


def _is_dense(x):
    """True when x's elements fill one block of memory with no gaps or
    overlaps, in any order of its dimensions."""

    expected = 1
    for size, stride in sorted(zip(x.shape, x.stride()), key=lambda p: p[1]):
        if size == 1:
            continue
        if stride != expected:
            return False
        expected *= size
    return True


def _layout(x):
    """(c, inner) of the kernel's channel map (i / inner) % c for a dense
    4-d tensor, NCHW-contiguous or channels_last; None for others."""

    if x.dim() != 4:
        return None
    if x.is_contiguous():
        return x.shape[1], x.shape[2] * x.shape[3]
    if x.is_contiguous(memory_format=torch.channels_last):
        return x.shape[1], 1
    return None


def silu_bf16(x, bias=None, out=None):
    """
    bf16 SiLU, with the conv's bias added first (rounded to bf16) when
    [bias] is given.

    Args:
        x: bf16 tensor; with a bias, a 4-d NCHW-indexed tensor, contiguous
            or channels_last (any dense tensor without one)
        bias: None or [C] bf16 (C = x.shape[1])
        out: None (a new tensor in x's memory format) or a bf16 tensor of
            x's shape and strides, x itself for in place

    Returns:
        the bf16 result (out when given)

    CPU tensors run the plain version. CUDA tensors run the kernel (built
    at first use); anything else raises.
    """

    global launches

    if x.device.type == 'cpu':
        y = silu_bf16_reference(x, bias)
        if out is None:
            return y
        return out.copy_(y)
    if x.device.type != 'cuda':
        raise ValueError('silu_bf16: x on {}; need the CPU or a CUDA device'
                         .format(x.device))
    if x.dtype != torch.bfloat16:
        raise ValueError('silu_bf16: need a bf16 tensor, got {}'.format(
            x.dtype))
    if not _is_dense(x):
        raise ValueError('silu_bf16: x must be dense')
    if x.numel() >= 2 ** 31:
        raise ValueError('silu_bf16: {} elements; the kernel takes fewer '
                         'than 2^31'.format(x.numel()))
    c, inner = 1, 1
    if bias is not None:
        layout = _layout(x)
        if layout is None:
            raise ValueError('silu_bf16: a bias needs a 4-d tensor, '
                             'contiguous or channels_last; got shape {} '
                             'strides {}'.format(tuple(x.shape), x.stride()))
        c, inner = layout
        if bias.dtype != torch.bfloat16 or tuple(bias.shape) != (c,) or \
                bias.device != x.device or not bias.is_contiguous():
            raise ValueError('silu_bf16: bias must be a contiguous [{}] bf16 '
                             'tensor on {}'.format(c, x.device))
    if out is None:
        out = torch.empty_like(x)
    elif out.dtype != x.dtype or out.shape != x.shape or \
            out.stride() != x.stride() or out.device != x.device:
        raise ValueError('silu_bf16: out must match x in type, shape, '
                         'strides and device')
    if x.numel() == 0:
        return out

    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.md_silu_bf16(
            x.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr(), x.numel(), int(c), int(inner),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, 'md_silu_bf16')
    launches += 1
    return out
