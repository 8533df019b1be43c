"""
int8 convolution of the int8 activation chain: the CUDA kernel
(csrc/conv_int8.cu) and its plain PyTorch version.

Replaces megadetector_tpu/ops/pallas_conv.py conv3x3_chain / _kernel (the
3x3 stride-1 SAME instance) and runs every other conv of the chain too (1x1
and 3x3 stride 2: the XLA branch of quantization.chained_conv), so on a
card no chain conv runs outside a hand-written kernel. The kernel is an
implicit GEMM on the int8 tensor cores (wgmma, fed by a cp.async ring in
shared memory) with the chain epilogue (*scale + bias, SiLU, requant to
int8) fused; see the source note for what bounds it. conv_tiling picks its
instance (tile and copy width) for each call.

Layouts: activations NHWC int8; weights [Cout, kh, kw, Cin] int8
(prepare_weight, once at load); pads (top, bottom, left, right).

conv3x3_int8_exp runs the same kernel's tile loop with an input requant
and the int8 experiments' epilogues (experiments/exp_pallas_conv3x3*.py,
E1-E4): see its docstring and the source note.

conv_int8 and conv3x3_int8_exp take the plain version only for tensors on
the CPU. For CUDA tensors they launch the kernel or raise.
"""

import collections

import numpy as np
import torch
import torch.nn.functional as F

from megadetector_tpu_torch.ops import _build
from megadetector_tpu_torch.ops.silu_bf16 import (
    sigmoid_bf16_reference, sigmoid_denominator_bf16_reference)

# Kernel launches made by conv_int8 (the plain version never counts)
launches = 0
# Kernel launches made by conv3x3_int8_exp
exp_launches = 0

# The experiments' epilogues and their codes in csrc/conv_int8.cu
EXP_EPILOGUES = {'f32': 1, 'f32_nosilu': 2, 'bf16': 3, 'hybrid': 4}

# The H100's streaming multiprocessors: a grid with fewer blocks leaves
# some idle
SMS = 132

# csrc/conv_int8.cu's instance bits
INST_VEC16, INST_BK128, INST_BM128, INST_BN128 = 1, 2, 4, 8

ConvTiling = collections.namedtuple('ConvTiling', 'bm bn bk vec code')


def conv_tiling(m, cin, cout, aligned16=True):
    """
    The conv kernel's instance for an [m, cout] output over Cin channels:

        vec 16 (16-byte cp.async) when Cin % 16 == 0 and x and w are
            16-byte aligned ([aligned16]), else 4 (four 4-byte words a
            chunk)
        bk  128 (K bytes per stage) when vec is 16 and Cin % 128 == 0,
            else 64
        bn  64 when Cout <= 64, else 128
        bm  128 when that grid has at least SMS blocks, else 64 (the
            15x20 and 30x40 levels' few pixels; no split-K, which would
            break the fused epilogue)

    Returns a ConvTiling whose code is the kernel's instance code.
    """

    vec = 16 if cin % 16 == 0 and aligned16 else 4
    bk = 128 if vec == 16 and cin % 128 == 0 else 64
    bn = 64 if cout <= 64 else 128
    bm = 128 if conv_grid(m, cout, 128, bn) >= SMS else 64
    code = ((INST_VEC16 if vec == 16 else 0) |
            (INST_BK128 if bk == 128 else 0) |
            (INST_BM128 if bm == 128 else 0) |
            (INST_BN128 if bn == 128 else 0))
    return ConvTiling(bm, bn, bk, vec, code)


def conv_grid(m, cout, bm, bn):
    """Blocks of the kernel's grid for an [m, cout] output in bm x bn
    tiles."""

    return -(-m // bm) * -(-cout // bn)


def _tiling_for(x_q, w, m):
    return conv_tiling(m, x_q.shape[3], w.shape[0],
                       x_q.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def prepare_weight(w_q_hwio):
    """HWIO int8 weight (numpy or tensor) -> contiguous [Cout, kh, kw, Cin]
    int8 tensor, the kernel's layout."""

    w = torch.as_tensor(np.asarray(w_q_hwio))
    if w.dtype != torch.int8 or w.dim() != 4:
        raise ValueError('prepare_weight: need a 4-d int8 HWIO weight, got '
                         '{} {}'.format(w.dtype, tuple(w.shape)))
    return w.permute(3, 0, 1, 2).contiguous()


def scalar_like(value, ref):
    """[value] as a float32 0-d tensor on [ref]'s device. Dividing by it is
    an IEEE division on the card too, where dividing by a Python number
    multiplies by its reciprocal."""

    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=ref.device)


def round_to_int8(y, scale):
    """clamp(round(y / scale), -127, 127) as int8: qt_quantize's
    arithmetic (float32 division, round half to even)."""

    return torch.clamp(torch.round(y / scalar_like(scale, y)), -127,
                       127).to(torch.int8)


def multiply_to_int8(y, inv_scale):
    """clamp(round(y * f32(inv_scale)), -127, 127) as int8: the int8
    experiments' requant, a float32 multiply (not a division)."""

    return torch.clamp(torch.round(y * scalar_like(inv_scale, y)), -127,
                       127).to(torch.int8)


def chain_epilogue_reference(acc, scale, bias, y_scale):
    """int32 accumulators [..., Cout] -> int8: acc * scale + bias, then
    SiLU as y * sigmoid(y), then round_to_int8 at y_scale."""

    y = acc.to(torch.float32) * scale + bias
    return round_to_int8(y * torch.sigmoid(y), y_scale)


def conv_int32_reference(x_q, w, stride, pads):
    """
    Plain int8 x int8 -> int32 conv. float32 would not be exact (a 3x3
    over 768 channels sums up to 6912 * 127^2 > 2^24), so the sums run in
    float64, exact below 2^53, with cuDNN off (its FFT and Winograd
    algorithms are not exact).

    x_q [B, H, W, Cin] int8, w [Cout, kh, kw, Cin] int8 -> [B, Ho, Wo,
    Cout] int32.
    """

    xd = F.pad(x_q.permute(0, 3, 1, 2).to(torch.float64),
               (pads[2], pads[3], pads[0], pads[1]))
    wd = w.permute(0, 3, 1, 2).to(torch.float64)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xd, wd, stride=tuple(stride))
    return acc.to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv_int8_reference(x_q, w, scale, bias, stride, pads, y_scale=None):
    """Plain version of conv_int8 (same arguments)."""

    acc = conv_int32_reference(x_q, w, stride, pads)
    if y_scale is None:
        return acc
    return chain_epilogue_reference(acc, scale, bias, y_scale)


def requant_input_reference(x_q, in_ratio):
    """clamp(round(f32(x) * f32(in_ratio)), -127, 127) as int8, the
    experiments' in-kernel input requant; x itself at in_ratio 1."""

    if float(in_ratio) == 1.0:
        return x_q
    return multiply_to_int8(x_q.to(torch.float32), in_ratio)


def exp_epilogue_reference(acc, scale, bias, y_scale, epilogue):
    """
    int32 accumulators [..., Cout] -> int8 through one of the experiments'
    epilogues, rounding where their JAX bodies round on the CPU (y_scale's
    reciprocal is taken in double, then rounded to float32):

        f32         q(silu(acc * scale + bias))
        f32_nosilu  q(acc * scale + bias)
        bf16        a = bf16(f32(acc)); y = bf16(bf16(a * bf16(scale)) +
                    bf16(bias)); q(y * bf16(1 / d(y)))
        hybrid      y = acc * scale + bias; q(y * (1 / d(bf16(y))))

    with q(y) = multiply_to_int8(y, 1 / y_scale), silu = y * sigmoid(y) in
    float32, d(y) = bf16(1 + bf16(exp(-y))) and every unmarked step in
    float32. XLA lowers a bf16 op to a float32 op and a rounding convert,
    but drops the rounding where the graph converts the result straight
    back to float32: so the last product of the bf16 epilogue and the
    sigmoid of the hybrid one stay float32. s32 -> bf16 goes through
    float32, two roundings, as XLA converts it.
    """

    if epilogue == 'bf16':
        bf16 = torch.bfloat16
        a = acc.to(torch.float32).to(bf16)
        y = a * scale.to(bf16) + bias.to(bf16)
        y = y.to(torch.float32) * sigmoid_bf16_reference(y).to(
            torch.float32)
    else:
        y = acc.to(torch.float32) * scale + bias
        if epilogue == 'f32':
            y = y * torch.sigmoid(y)
        elif epilogue == 'hybrid':
            d = sigmoid_denominator_bf16_reference(y.to(torch.bfloat16))
            y = y * torch.reciprocal(d.to(torch.float32))
        elif epilogue != 'f32_nosilu':
            raise ValueError('unknown epilogue {!r}; one of {}'.format(
                epilogue, sorted(EXP_EPILOGUES)))
    return multiply_to_int8(y, 1.0 / float(y_scale))


def conv3x3_int8_exp_reference(x_q, w, scale, bias, in_ratio, y_scale,
                               epilogue):
    """Plain version of conv3x3_int8_exp (same arguments)."""

    acc = conv_int32_reference(requant_input_reference(x_q, in_ratio), w,
                               (1, 1), (1, 1, 1, 1))
    return exp_epilogue_reference(acc, scale, bias, y_scale, epilogue)


def _check_cuda(x_q, w, scale, bias, y_scale):
    tensors = [x_q, w] + ([scale, bias] if y_scale is not None else [])
    if any(t.device != x_q.device for t in tensors):
        raise ValueError('conv_int8: tensors on {}; need one device'.format(
            [str(t.device) for t in tensors]))
    if x_q.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError('conv_int8: need int8 x and w, got {} and {}'
                         .format(x_q.dtype, w.dtype))
    if y_scale is not None and (scale.dtype != torch.float32 or
                                bias.dtype != torch.float32):
        raise ValueError('conv_int8: need float32 scale and bias')
    if x_q.dim() != 4 or w.dim() != 4 or x_q.shape[3] != w.shape[3]:
        raise ValueError('conv_int8: need x [B, H, W, Cin] and w [Cout, kh, '
                         'kw, Cin], got {} and {}'.format(
                             tuple(x_q.shape), tuple(w.shape)))
    if x_q.shape[3] % 4 != 0:
        raise ValueError('conv_int8: Cin={} is not a multiple of 4'.format(
            x_q.shape[3]))
    if y_scale is not None and (tuple(scale.shape) != (w.shape[0],) or
                                tuple(bias.shape) != (w.shape[0],)):
        raise ValueError('conv_int8: scale and bias must be [Cout]')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('conv_int8: inputs must be contiguous')
    if x_q.data_ptr() % 4 or w.data_ptr() % 4:
        raise ValueError('conv_int8: x and w must be 4-byte aligned')


def conv_int8(x_q, w, scale, bias, stride, pads, y_scale=None):
    """
    int8 conv with the chain epilogue (every chain conv has SiLU).

    Args:
        x_q: [B, H, W, Cin] int8 (Cin a multiple of 4 on the card)
        w: [Cout, kh, kw, Cin] int8 (prepare_weight)
        scale, bias: [Cout] float32 (scale = w_scale * x_scale); unused
            when y_scale is None
        stride: (sh, sw); pads: (top, bottom, left, right)
        y_scale: the output grid (Python float); None returns the int32
            accumulators

    Returns:
        [B, Ho, Wo, Cout] int8 at y_scale, or int32 when y_scale is None

    CPU tensors run the plain version. CUDA tensors run the kernel (built
    at first use); anything else raises.
    """

    global launches

    if x_q.device.type == 'cpu' and w.device.type == 'cpu':
        return conv_int8_reference(x_q, w, scale, bias, stride, pads,
                                   y_scale)
    if x_q.device.type != 'cuda':
        raise ValueError('conv_int8: x on {}; need the CPU or a CUDA device'
                         .format(x_q.device))
    _check_cuda(x_q, w, scale, bias, y_scale)
    b, h, wd, cin = x_q.shape
    cout, kh, kw, _ = w.shape
    ho = (h + pads[0] + pads[1] - kh) // stride[0] + 1
    wo = (wd + pads[2] + pads[3] - kw) // stride[1] + 1
    if ho <= 0 or wo <= 0:
        raise ValueError('conv_int8: empty output {}x{}'.format(ho, wo))
    out = torch.empty((b, ho, wo, cout), device=x_q.device,
                      dtype=torch.int32 if y_scale is None else torch.int8)
    if out.numel() == 0:
        return out
    if y_scale is None:
        ys, sp, bp = 0.0, 0, 0
    else:
        ys, sp, bp = float(y_scale), scale.data_ptr(), bias.data_ptr()

    lib = _build.load_library()
    with torch.cuda.device(x_q.device):
        err = lib.md_conv_int8(
            x_q.data_ptr(), w.data_ptr(), sp, bp, out.data_ptr(), b, h, wd,
            cin, cout, kh, kw, int(stride[0]), int(stride[1]), int(pads[0]),
            int(pads[2]), ho, wo, ys, int(y_scale is not None),
            _tiling_for(x_q, w, b * ho * wo).code,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, 'md_conv_int8')
    launches += 1
    return out


def conv3x3_int8_exp(x_q, w, scale, bias, in_ratio, y_scale, epilogue='f32'):
    """
    The int8 experiments' 3x3 stride-1 SAME conv (E1-E4): the input
    requantized at in_ratio (skipped at 1.0), int8 x int8 -> int32, then
    one of EXP_EPILOGUES (exp_epilogue_reference), int8 out.

    Args:
        x_q: [B, H, W, Cin] int8 (Cin a multiple of 4 on the card)
        w: [Cout, 3, 3, Cin] int8 (prepare_weight)
        scale, bias: [Cout] float32
        in_ratio: producer scale / x scale (Python float)
        y_scale: the output grid (Python float)
        epilogue: 'f32', 'f32_nosilu', 'bf16' or 'hybrid'

    Returns:
        [B, H, W, Cout] int8 at y_scale

    CPU tensors run the plain version. CUDA tensors run the kernel (built
    at first use); anything else raises.
    """

    global exp_launches

    if epilogue not in EXP_EPILOGUES:
        raise ValueError('conv3x3_int8_exp: unknown epilogue {!r}; one of '
                         '{}'.format(epilogue, sorted(EXP_EPILOGUES)))
    if x_q.device.type == 'cpu' and w.device.type == 'cpu':
        return conv3x3_int8_exp_reference(x_q, w, scale, bias, in_ratio,
                                          y_scale, epilogue)
    if x_q.device.type != 'cuda':
        raise ValueError('conv3x3_int8_exp: x on {}; need the CPU or a CUDA '
                         'device'.format(x_q.device))
    _check_cuda(x_q, w, scale, bias, y_scale)
    if tuple(w.shape[1:3]) != (3, 3):
        raise ValueError('conv3x3_int8_exp: need a 3x3 weight, got {}'.format(
            tuple(w.shape)))
    b, h, wd, cin = x_q.shape
    cout = w.shape[0]
    out = torch.empty((b, h, wd, cout), device=x_q.device, dtype=torch.int8)
    if out.numel() == 0:
        return out

    lib = _build.load_library()
    with torch.cuda.device(x_q.device):
        err = lib.md_conv3x3_int8_exp(
            x_q.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, wd, cin, cout,
            int(float(in_ratio) != 1.0), float(np.float32(in_ratio)),
            float(np.float32(1.0 / float(y_scale))), EXP_EPILOGUES[epilogue],
            _tiling_for(x_q, w, b * h * wd).code,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, 'md_conv3x3_int8_exp')
    exp_launches += 1
    return out
