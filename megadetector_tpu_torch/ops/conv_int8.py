"""
int8 convolution of the int8 activation chain: the CUDA kernel
(csrc/conv_int8.cu) and its plain PyTorch version.

Replaces megadetector_tpu/ops/pallas_conv.py conv3x3_chain / _kernel (the
3x3 stride-1 SAME instance) and runs every other conv of the chain too (1x1
and 3x3 stride 2: the XLA branch of quantization.chained_conv), so on a
card no chain conv runs outside a hand-written kernel. The kernel is an
implicit GEMM accumulating __dp4a into int32 with the chain epilogue
(*scale + bias, SiLU, requant to int8) fused; see the source note for what
bounds it.

Layouts: activations NHWC int8; weights [Cout, kh, kw, Cin] int8
(prepare_weight, once at load); pads (top, bottom, left, right).

conv_int8 takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises.
"""

import numpy as np
import torch
import torch.nn.functional as F

from megadetector_tpu_torch.ops import _build

# Kernel launches made by conv_int8 (the plain version never counts)
launches = 0


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
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, 'md_conv_int8')
    launches += 1
    return out
