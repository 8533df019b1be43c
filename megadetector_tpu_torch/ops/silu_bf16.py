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

The kernel adds in a fixed partition and order of its own
(backward_plan), so its db is the same bits on every call;
silu_bf16_backward_bias_sum_ordered repeats that order in torch ops, for
the tests and the card check. Its sigmoid comes from a table of (s, i)
over every bf16 y, whose plain version is sigmoid_grad_table_reference.
"""

from typing import NamedTuple, Optional

import torch

from megadetector_tpu_torch.ops import _build

# Kernel launches made by silu_bf16 and silu_bf16_backward (the plain
# version never counts)
launches = 0
backward_launches = 0

# The backward kernel's partition (csrc/silu_bf16.cu, backward_plan):
# threads a block; blocks at most (4 of 256 threads on each of the H100's
# 132 SMs, all resident at once, so that each stages the sigmoid table
# once); rows a thread of the rows kernel walks before another block is
# added; units a thread takes of a planes-kernel tile; slices of the bias
# pass
BACKWARD_THREADS = 256
BACKWARD_BLOCKS = 528
BACKWARD_MIN_ROWS = 4
BACKWARD_TILE_STEPS = 4
BACKWARD_BIAS_SLICES = 64
# Channels the backward takes: the rows kernel's grid has a column tile
# for every 32 units of C, at most 65,535 (the sums live in registers and
# in [blocks, C] scratch, not in shared memory)
MAX_BACKWARD_CHANNELS = 1 << 20

# The backward's (s, i) table: float bits of the largest bf16 below 2^-8
# and of 128.0, and the entries of each sign (csrc/silu_bf16.cu kTableLo,
# kTableHi, kTableHalf)
SIGMOID_TABLE_LO = 0x3B7F0000
SIGMOID_TABLE_HI = 0x43000000
SIGMOID_TABLE_HALF = ((SIGMOID_TABLE_HI - SIGMOID_TABLE_LO) >> 16) + 1


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


def _bf16_from_bits(bits):
    """bf16 tensor of int64 [bits] (0 .. 65535)."""

    return (((bits + 32768) % 65536) - 32768).to(torch.int16).view(
        torch.bfloat16)


def _bf16_bits(t):
    """int64 bit patterns (0 .. 65535) of a bf16 tensor."""

    return t.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF


def sigmoid_grad_table_reference():
    """
    Plain version of the backward kernel's table: int64 [2 *
    SIGMOID_TABLE_HALF], positive y first. Entry k of a sign holds the y
    with float bits sign | (SIGMOID_TABLE_LO + (k << 16)); its value is
    s's bf16 bits << 16 | i's, s = sigmoid_bf16_reference(y) and i = s *
    (1 - s) in bf16. Entry 0 stands for every |y| below 2^-8, the last
    for every |y| from 128 up.
    """

    k = torch.arange(SIGMOID_TABLE_HALF, dtype=torch.int64)
    mag = (SIGMOID_TABLE_LO + (k << 16)) >> 16
    y = _bf16_from_bits(torch.cat([mag, mag | 0x8000]))
    s = sigmoid_bf16_reference(y)
    i = s * (1 - s)
    return (_bf16_bits(s) << 16) | _bf16_bits(i)


def sigmoid_grad_lookup_reference(y, table):
    """(s, i), bf16 tensors of [y]'s shape, read from [table] for the bf16
    tensor [y] as the backward kernel reads them."""

    bits = _bf16_bits(y) << 16
    a = (bits & 0x7FFFFFFF).clamp(SIGMOID_TABLE_LO, SIGMOID_TABLE_HI)
    e = table[((a - SIGMOID_TABLE_LO) >> 16) + (bits >> 31) *
              SIGMOID_TABLE_HALF]
    return _bf16_from_bits(e >> 16), _bf16_from_bits(e & 0xFFFF)


class BackwardPlan(NamedTuple):
    """The backward kernel's partition (csrc/silu_bf16.cu)."""

    kind: str          # 'rows' (a bias, inner == 1) or 'planes'
    width: int         # elements a unit: 8 (one 16-byte vector) or 1
    blocks: int        # the grid's x size
    cols: int          # rows: units a block covers across a row
    lanes: int         # rows: rows a block walks side by side
    segs: int          # planes: tiles a plane
    partial_rows: int  # rows of the [partial_rows, C] float32 scratch


def backward_plan(n, c, inner, has_bias, aligned=True):
    """
    The partition the backward kernel uses for a dense tensor of [n]
    elements whose element i has channel (i / inner) % c, with or without
    a bias; [aligned]: g, x and dx start on 16-byte boundaries.

    With a bias and inner == 1 ([rows, c], channels_last): units of 8
    channels (1 where c % 8 != 0 or not aligned), cols = min(units, 32)
    of them across a block and lanes = 256 // cols rows side by side; a
    block for every lanes * BACKWARD_MIN_ROWS rows, at most
    BACKWARD_BLOCKS over all column tiles. Else planes (the (n, c) planes
    of an NCHW tensor; without a bias one plane of all n): units of 8
    where the plane allows it, tiles of BACKWARD_TILE_STEPS * 256 units,
    at most BACKWARD_BLOCKS blocks.
    """

    if has_bias and inner == 1:
        width = 8 if aligned and c % 8 == 0 else 1
        units = c // width
        cols = min(units, 32)
        lanes = BACKWARD_THREADS // cols
        col_tiles = -(-units // cols)
        rows = n // c
        blocks = max(1, min(BACKWARD_BLOCKS // col_tiles,
                            -(-rows // (lanes * BACKWARD_MIN_ROWS))))
        return BackwardPlan('rows', width, blocks, cols, lanes, 0, blocks)
    plane = inner if has_bias else n
    width = 8 if aligned and plane % 8 == 0 else 1
    segs = -(-(plane // width) // (BACKWARD_TILE_STEPS * BACKWARD_THREADS))
    planes = n // plane
    return BackwardPlan('planes', width, min(BACKWARD_BLOCKS, planes * segs),
                        0, 0, segs, planes // c * segs if has_bias else 0)


def _tree_sum(v, dim):
    """The kernels' fixed tree over [dim] of size L: at step s (from the
    largest power of two below L down to 1) entry l < s adds entry l + s
    where that exists; float32 additions, one at a time."""

    v = v.movedim(dim, 0).clone()
    size = v.shape[0]
    s = 1
    while s < size:
        s <<= 1
    s >>= 1
    while s > 0:
        m = min(s, size - s)
        if m > 0:
            v[:m] = v[:m] + v[s:s + m]
        s >>= 1
    return v[0]


def _sum_in_order(v):
    """v[0] + v[1] + ... in float32, in that order."""

    total = torch.zeros_like(v[0])
    for part in v:
        total = total + part
    return total


def silu_bf16_backward_bias_sum_ordered(dx, aligned=True):
    """
    db as the backward kernel adds it from its own dx: the float32 sums
    of backward_plan's partition in the kernel's order (each thread's
    rows or tile units in order, the block's fixed tree, then the bias
    pass's 64 slices and its tree), rounded once to bf16. [dx] bf16, 4-d,
    contiguous or channels_last; [aligned] as for backward_plan. Only the
    tests and the card check use it.
    """

    return _bias_sum_ordered_f32(dx, aligned).to(torch.bfloat16)


def _bias_sum_ordered_f32(dx, aligned):
    """silu_bf16_backward_bias_sum_ordered before its rounding: [C]
    float32."""

    layout = _layout(dx)
    if layout is None:
        raise ValueError('silu_bf16_backward_bias_sum_ordered: dx must be '
                         '4-d, contiguous or channels_last')
    c, inner = layout
    plan = backward_plan(dx.numel(), c, inner, True, aligned)
    d = dx.float()
    if plan.kind == 'rows':
        rows = d.permute(0, 2, 3, 1).reshape(-1, c)
        stride = plan.blocks * plan.lanes
        pad = -rows.shape[0] % stride
        rows = torch.cat([rows, rows.new_zeros(pad, c)])
        sums = _sum_in_order(rows.view(-1, plan.blocks, plan.lanes, c))
        partials = _tree_sum(sums, 1)
    else:
        tile = BACKWARD_TILE_STEPS * BACKWARD_THREADS * plan.width
        planes = d.reshape(dx.shape[0], c, inner)
        planes = torch.cat([planes, planes.new_zeros(
            dx.shape[0], c, plan.segs * tile - inner)], 2)
        units = planes.view(dx.shape[0], c, plan.segs, BACKWARD_TILE_STEPS,
                            BACKWARD_THREADS, plan.width)
        sums = _sum_in_order(units.permute(3, 5, 0, 1, 2, 4).reshape(
            -1, dx.shape[0], c, plan.segs, BACKWARD_THREADS))
        warps = _tree_sum(sums.view(dx.shape[0], c, plan.segs,
                                    BACKWARD_THREADS // 32, 32), 4)
        partials = _tree_sum(warps, 3).permute(0, 2, 1).reshape(-1, c)
    pad = -partials.shape[0] % BACKWARD_BIAS_SLICES
    partials = torch.cat([partials, partials.new_zeros(pad, c)])
    slices = _sum_in_order(partials.view(-1, BACKWARD_BIAS_SLICES, c))
    return _tree_sum(slices, 0)


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
    kernel md_silu_bf16_backward (one counted launch: dx and each block's
    float32 channel sums in backward_plan's partition, then, with a bias,
    a pass that adds them in a fixed order and rounds); anything else
    raises. A [g] whose strides differ from x's is copied into x's layout
    first.
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
    plan = backward_plan(x.numel(), c, inner, bias is not None,
                         all(t.data_ptr() % 16 == 0 for t in (g, x, dx)))
    partials = None if bias is None else torch.empty(
        (plan.partial_rows, c), dtype=torch.float32, device=x.device)

    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.md_silu_bf16_backward(
            g.data_ptr(), x.data_ptr(),
            0 if bias is None else bias.data_ptr(), dx.data_ptr(),
            0 if bias is None else partials.data_ptr(),
            0 if bias is None else db.data_ptr(), x.numel(), int(c),
            int(inner), plan.width, plan.blocks, plan.cols, plan.lanes,
            plan.segs, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, 'md_silu_bf16_backward')
    backward_launches += 1
    return dx, db
