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
tensors it launches the kernel or raises. It calls the custom operator
mdtorch::silu_bf16 (mdtorch::silu_bf16_out, which writes [out], where out=
is given), one node of a traced graph.

The gradient: where x or the bias requires grad (and grad mode is on),
silu_bf16 is a torch.autograd.Function that saves x and the bias and whose
backward is silu_bf16_backward: the kernel md_silu_bf16_backward of the
same source on a card (it recomputes y = x + b and the sigmoid rather than
storing them), silu_bf16_backward_reference on the CPU. Both follow the
bf16 VJP that JAX takes of y * sigmoid(y), y = x + b (read from
jax.make_jaxpr of jax.vjp): logistic's JVP is s * (1 - s), and the
product rule's two terms are g * s and (y * g) * (s * (1 - s)), added in
that order, every op rounded to bf16. The bias gradient is that dx summed
over N, H and W per channel in float32 and rounded once to bf16, then cast
to the float32 parameter by autograd. (JAX's VJP sums in a bf16
reduce_sum, which XLA on the CPU evaluates one element after another,
rounding every addition; a parallel sum cannot follow that order, and
rounding once is the more exact of the two: ROADMAP C, PR 14.)
"""

from typing import Optional

import torch

from megadetector_tpu_torch.ops import _build

# Kernel launches made by silu_bf16 and silu_bf16_backward (the plain
# version never counts)
launches = 0
backward_launches = 0

# The backward kernel's per-channel sums live in shared memory (float32),
# up to 48 KB of it
MAX_BACKWARD_CHANNELS = 12288
# Blocks of the backward kernel's grid-stride loop, at most
BACKWARD_BLOCKS = 528


def _channel_view(bias, x):
    """[C] bias shaped to broadcast over [x]'s channel dimension (1 of an
    NCHW-indexed tensor, whatever its memory format)."""

    if x.dim() < 2:
        return bias
    return bias.view((1, -1) + (1,) * (x.dim() - 2))


def sigmoid_denominator_bf16_reference(y):
    """1 + exp(-y) of a bf16 tensor as XLA computes it in bf16: exp and
    1 + each computed in float and rounded to bf16."""

    return 1 + torch.exp(-y)


def sigmoid_bf16_reference(y):
    """sigmoid of a bf16 tensor as XLA computes it in bf16: exp, 1 + and
    1 / each computed in float and rounded to bf16."""

    return torch.reciprocal(sigmoid_denominator_bf16_reference(y))


def silu_bf16_reference(x, bias=None):
    """Plain version: [x] (+ bias over dim 1) then SiLU, as a chain of bf16
    torch ops, each computed in float and rounded to bf16."""

    y = x if bias is None else x + _channel_view(bias, x)
    return y * sigmoid_bf16_reference(y)


def silu_bf16_backward_reference(g, x, bias=None):
    """
    Plain version of the backward of silu_bf16(x, bias) at the output
    gradient [g] (bf16, x's shape): (dx, db), dx bf16 and db [C] bf16 (None
    without a bias). The op sequence is JAX's VJP of y * sigmoid(y) in
    bf16, every op rounded to bf16:

        y = x + b, s = sigmoid(y), i = s * (1 - s),
        dx = g * s + (y * g) * i

    and db = bf16(sum over N, H, W of float32(dx)).
    """

    y = x if bias is None else x + _channel_view(bias, x)
    s = sigmoid_bf16_reference(y)
    i = s * (1 - s)
    dx = g * s + (y * g) * i
    if bias is None:
        return dx, None
    dims = (0,) + tuple(range(2, x.dim()))
    return dx, dx.float().sum(dims).to(torch.bfloat16)


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


class _SiluBf16(torch.autograd.Function):
    """silu_bf16 with its gradient: the forward saves x and the bias; the
    backward is silu_bf16_backward."""

    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return _silu_bf16(x, bias, None)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        return silu_bf16_backward(g, x, bias)


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
    at first use); anything else raises. Where grad mode is on and x or
    the bias requires grad, the call is recorded for autograd (the same
    forward, no [out]) and its backward is silu_bf16_backward.
    """

    if torch.is_grad_enabled() and (
            x.requires_grad or (bias is not None and bias.requires_grad)):
        if out is not None:
            raise ValueError('silu_bf16: out= cannot be differentiated')
        return _SiluBf16.apply(x, bias)
    return _silu_bf16(x, bias, out)


def _check_bias(x, bias, name):
    """(c, inner) of the kernel's channel map for [x] with [bias] (1, 1
    without one); raises on a layout or bias the kernels do not take."""

    if bias is None:
        return 1, 1
    layout = _layout(x)
    if layout is None:
        raise ValueError('{}: a bias needs a 4-d tensor, contiguous or '
                         'channels_last; got shape {} strides {}'.format(
                             name, tuple(x.shape), x.stride()))
    c, inner = layout
    if bias.dtype != torch.bfloat16 or tuple(bias.shape) != (c,) or \
            bias.device != x.device or not bias.is_contiguous():
        raise ValueError('{}: bias must be a contiguous [{}] bf16 tensor '
                         'on {}'.format(name, c, x.device))
    return c, inner


def _check_cuda_input(x, name):
    if x.device.type != 'cuda':
        raise ValueError('{}: x on {}; need the CPU or a CUDA device'
                         .format(name, x.device))
    if x.dtype != torch.bfloat16:
        raise ValueError('{}: need a bf16 tensor, got {}'.format(
            name, x.dtype))
    if not _is_dense(x):
        raise ValueError('{}: x must be dense'.format(name))
    if x.numel() >= 2 ** 31:
        raise ValueError('{}: {} elements; the kernel takes fewer than '
                         '2^31'.format(name, x.numel()))


def _silu_bf16(x, bias, out):
    # The operators' fake versions take any other device (the meta
    # device included): refuse it here
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('silu_bf16: x on {}; need the CPU or a CUDA device'
                         .format(x.device))
    if out is None:
        return torch.ops.mdtorch.silu_bf16(x, bias)
    torch.ops.mdtorch.silu_bf16_out(x, bias, out)
    return out


@torch.library.custom_op('mdtorch::silu_bf16', mutates_args=(),
                         device_types='cpu')
def _silu_bf16_op(x: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    return silu_bf16_reference(x, bias)


@_silu_bf16_op.register_fake
def _silu_bf16_fake(x, bias):
    return torch.empty_like(x)


@_silu_bf16_op.register_kernel('cuda')
def _silu_bf16_cuda(x, bias):
    return _launch(x, bias, None)


@torch.library.custom_op('mdtorch::silu_bf16_out', mutates_args=('out',),
                         device_types='cpu')
def _silu_bf16_out_op(x: torch.Tensor, bias: Optional[torch.Tensor],
                      out: torch.Tensor) -> None:
    out.copy_(silu_bf16_reference(x, bias))


@_silu_bf16_out_op.register_fake
def _silu_bf16_out_fake(x, bias, out):
    return None


@_silu_bf16_out_op.register_kernel('cuda')
def _silu_bf16_out_cuda(x, bias, out):
    _launch(x, bias, out)


def _launch(x, bias, out):
    """The kernel on a CUDA tensor, into [out] (a new tensor when None)."""

    global launches

    _check_cuda_input(x, 'silu_bf16')
    c, inner = _check_bias(x, bias, 'silu_bf16')
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


def silu_bf16_backward(g, x, bias=None):
    """
    Backward of silu_bf16(x, bias): (dx, db) for the output gradient [g],
    dx in x's shape and memory format, db [C] bf16 (None without a bias).

    CPU tensors run silu_bf16_backward_reference. CUDA tensors run the
    kernel md_silu_bf16_backward (one launch: dx and per-block float32
    channel sums, then a pass that adds the blocks' sums in order and
    rounds); anything else raises. A [g] whose strides differ from x's is
    copied into x's layout first.
    """

    global backward_launches

    if x.device.type == 'cpu':
        return silu_bf16_backward_reference(g, x, bias)
    _check_cuda_input(x, 'silu_bf16_backward')
    c, inner = _check_bias(x, bias, 'silu_bf16_backward')
    if c > MAX_BACKWARD_CHANNELS:
        raise ValueError('silu_bf16_backward: {} channels; the kernel takes '
                         'at most {}'.format(c, MAX_BACKWARD_CHANNELS))
    if g.dtype != torch.bfloat16 or g.shape != x.shape or \
            g.device != x.device:
        raise ValueError('silu_bf16_backward: g must be a bf16 tensor of '
                         'x\'s shape on {}'.format(x.device))
    if g.stride() != x.stride():
        g = torch.empty_like(x).copy_(g)
    dx = torch.empty_like(x)
    db = None if bias is None else torch.empty_like(bias)
    if x.numel() == 0:
        if db is not None:
            db.zero_()
        return dx, db
    blocks = min(BACKWARD_BLOCKS, -(-x.numel() // 2048))
    partials = None if bias is None else torch.empty(
        (blocks, c), dtype=torch.float32, device=x.device)

    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.md_silu_bf16_backward(
            g.data_ptr(), x.data_ptr(),
            0 if bias is None else bias.data_ptr(), dx.data_ptr(),
            0 if bias is None else partials.data_ptr(),
            0 if bias is None else db.data_ptr(), x.numel(), int(c),
            int(inner), blocks, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, 'md_silu_bf16_backward')
    backward_launches += 1
    return dx, db
