"""
The int8 activation chain (counterpart of
megadetector_tpu/ops/quantization.py, whose numpy parts are carried over
here because that module imports jax).

- Weights and policy: quantize_conv_weight (symmetric per-output-channel
  int8), quantize_params (the static-scale policy: a conv becomes int8
  when c_in * k * k >= 288 and c_out >= 64), quantize_params_chain
  (YOLOv5's; EfficientNet's is in models/efficientnet.py) and the
  float-store layer lists; requalify_quantized.
- QTensor (int8 NHWC data + a static Python-float scale) and its ops:
  qt_dequant, qt_quantize, qt_requant, qt_concat, qt_add, qt_maxpool,
  qt_upsample2x (float tensors take the plain torch ops; the model,
  models/yolov5.py, picks which).
- chained_conv: int8 in, int8 out, on the conv kernel (ops/conv_int8),
  with or without SiLU (act); fused_bottleneck: a whole CSP bottleneck on
  the bottleneck kernel (ops/bottleneck_int8).
- quantized_conv: float in and out, the int8 conv on the conv kernel in
  its int32 mode and the float epilogue in torch. With a static x_scale
  (mode='static' checkpoints) it is that path's conv: no reduction and no
  host read, so the forward can be captured into a CUDA graph. Without
  one it quantizes at the dynamic abs-max input scale: the calibration
  forward of calibrate_chain_scales (YOLOv5 and EfficientNet, whose
  residual sums get their own res_scale) and of
  calibrate_activation_scales (the static x_scale).

Scale arithmetic happens in Python floats and becomes float32 where the
JAX module makes it float32: w_scale * f32(x_scale) in chained_conv,
f32(x.scale / scale) in qt_requant, s_a + s_b in qt_add (cast only inside
the requant). Convs consume QTensor inputs at the producer's scale; only a
float input (the chain entry) is quantized at the node's x_scale.

Layouts are the JAX module's: NHWC activations, HWIO weights in the
parameter tree ([Cout, kh, kw, Cin] once prepared for the kernel).
"""

import numpy as np
import torch
import torch.nn.functional as F

from megadetector_tpu_torch.device import get_device
from megadetector_tpu_torch.ops import bottleneck_int8, conv_int8
from megadetector_tpu_torch.ops.conv_int8 import (round_to_int8,
                                                  scalar_like)
from megadetector_tpu_torch.ops.silu_bf16 import sigmoid_bf16_reference

SCALE_KEYS = ('x_scale', 'y_scale', 'res_scale')

DEFAULT_FLOAT_STORE_LAYERS = ('l0', 'l1', 'l2')

# The policy of the JAX package's MDv5a int8 checkpoint (quantized after
# width folding): only the 3-channel stem stays float. The port writes the
# same policy unfolded (models/convert_weights.quantize_checkpoint).
DEFAULT_FLOAT_STORE_LAYERS_FOLDED = ('l0',)


#%% Weights and policy


def quantize_conv_weight(w):
    """
    Symmetric per-output-channel int8 quantization of an HWIO conv weight.
    Returns (w_q int8, scale f32 [c_out]).
    """

    w = np.asarray(w, np.float32)
    max_abs = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    scale = np.maximum(max_abs, 1e-12) / 127.0
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return w_q, scale.astype(np.float32)


def quantize_params(params, min_channels=32):
    """
    The static-scale policy (mode='static'): every conv node ({'w', 'b'},
    a 4-d w) with c_in * k * k >= min_channels * 9 and c_out >= 64 becomes
    {'w_q', 'w_scale', 'b'}; the others stay float32 {'w', 'b'}. The
    detect heads are convs like any other, so they quantize once
    3 * (5 + nc) >= 64. x_scale comes from calibrate_activation_scales.
    """

    def convert(node):
        if isinstance(node, dict):
            if 'w' in node and 'b' in node and \
                    getattr(node['w'], 'ndim', 0) == 4:
                w = np.asarray(node['w'])
                k, _, c_in, c_out = w.shape
                if c_in * k * k >= min_channels * 9 and c_out >= 64:
                    w_q, scale = quantize_conv_weight(w)
                    return {'w_q': w_q, 'w_scale': scale,
                            'b': np.asarray(node['b'], np.float32)}
                return {'w': w.astype(np.float32),
                        'b': np.asarray(node['b'], np.float32)}
            return {key: convert(value) for key, value in node.items()}
        return node

    return convert(params)


def quantize_params_chain(params, skip_names=('detect',),
                          keep_float_first=True,
                          float_store_names=DEFAULT_FLOAT_STORE_LAYERS):
    """
    Quantize a yolov5-style parameter tree for the chain: conv nodes get
    w_q/w_scale/b (x_scale/y_scale come from calibrate_chain_scales).
    Layers in [float_store_names] stay float {'w', 'b'}, and so do the
    top-level [skip_names] (the detect heads). [keep_float_first] is
    unused, as in the JAX module, whose positional order this keeps.
    """

    float_store = tuple(float_store_names or ())

    def convert(node, path):
        if isinstance(node, dict):
            if 'w' in node and 'b' in node and \
                    getattr(node['w'], 'ndim', 0) == 4:
                if path and path[0] in float_store:
                    return {'w': np.asarray(node['w'], np.float32),
                            'b': np.asarray(node['b'], np.float32)}
                w_q, scale = quantize_conv_weight(node['w'])
                return {'w_q': w_q, 'w_scale': scale,
                        'b': np.asarray(node['b'], np.float32)}
            return {key: convert(value, path + (key,))
                    for key, value in node.items()}
        return node

    return {key: value if key in skip_names else convert(value, (key,))
            for key, value in params.items()}


def requalify_quantized(params):
    """
    Copy of a parameter tree with every static scale (x_scale, y_scale,
    res_scale; 0-d arrays after a checkpoint round trip) as a Python
    float. Every node is taken as it is, with or without scales: the JAX
    module's version (ops/quantization.py:165) re-wraps only the nodes
    that carry a y_scale, so an int8 checkpoint saved before calibration
    loads there as plain dicts, and its scales become traced leaves that
    crash the chain after auto-calibration. Here nothing depends on the
    wrapping: the networks read the scales as Python floats wherever they
    are.
    """

    if isinstance(params, dict):
        return {k: float(np.asarray(v)) if k in SCALE_KEYS
                else requalify_quantized(v) for k, v in params.items()}
    return params


#%% QTensor


class QTensor:
    """A quantized activation: int8 NHWC data and a static Python-float
    scale."""

    __slots__ = ('q', 'scale')

    def __init__(self, q, scale):
        self.q = q
        self.scale = float(scale)


def qt_dequant(x, dtype=torch.float32):
    """QTensor -> float NHWC tensor in [dtype], as the JAX qt_dequant
    computes it: q.astype(dtype) * dtype(scale), so in bf16 the scale and
    the product are rounded to bf16."""

    if dtype == torch.float32:
        return x.q.to(torch.float32) * scalar_like(x.scale, x.q)
    scale = torch.full((), x.scale, dtype=dtype, device=x.q.device)
    return x.q.to(dtype) * scale


def qt_quantize(x, scale):
    """float NHWC tensor -> QTensor at [scale]."""

    return QTensor(round_to_int8(x.to(torch.float32), scale).contiguous(),
                   scale)


def qt_requant(x, scale):
    """QTensor -> QTensor at a new scale (float32 ratio)."""

    if x.scale == scale:
        return x
    ratio = scalar_like(x.scale / scale, x.q)
    q = torch.clamp(torch.round(x.q.to(torch.float32) * ratio), -127, 127)
    return QTensor(q.to(torch.int8), scale)


def qt_concat(xs):
    """Channel concat of QTensors, requantized to the largest scale."""

    scale = max(x.scale for x in xs)
    return QTensor(torch.cat([qt_requant(x, scale).q for x in xs], dim=-1),
                   scale)


def qt_add(a, b):
    """Residual add of two QTensors in float32, requantized at the bound
    scale s_a + s_b so the sum cannot clip."""

    q, scale = bottleneck_int8.residual_requant(a.q, a.scale, b.q, b.scale)
    return QTensor(q, scale)


def qt_maxpool(x, pool_k):
    """Stride-1 SAME max pool of a QTensor's int8 values (the scale is
    positive, so the max commutes with dequantization). max_pool2d takes
    no int8 on CUDA, so the values pool as float32 and cast back, exactly:
    the window always holds its centre, so the -inf padding here and the
    JAX module's -128 padding give the same max."""

    pooled = F.max_pool2d(x.q.permute(0, 3, 1, 2).to(torch.float32),
                          pool_k, 1, pool_k // 2)
    return QTensor(pooled.to(torch.int8).permute(0, 2, 3, 1).contiguous(),
                   x.scale)


def qt_upsample2x(x):
    """Nearest 2x upsample of a QTensor's raw int8."""

    b, h, w, c = x.q.shape
    return QTensor(x.q[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
                   .reshape(b, 2 * h, 2 * w, c), x.scale)


#%% Convs


def conv_pads(pad, k):
    """JAX conv_geom's padding forms -> (top, bottom, left, right): None
    (k // 2), an int, or ((top, bottom), (left, right))."""

    if pad is None:
        pad = k // 2
    if isinstance(pad, int):
        return (pad, pad, pad, pad)
    (t, b), (left, r) = pad
    return (t, b, left, r)


def _pair(stride):
    return (stride, stride) if isinstance(stride, int) else tuple(stride)


def chained_conv(x, w, w_scale, bias, x_scale, y_scale, stride, pads,
                 act=True):
    """
    int8-in / int8-out conv of the chain: int8 x int8 -> int32, then
    acc * (w_scale * x_scale) + bias, SiLU (unless not [act]), requant at
    y_scale, fused in the conv kernel (the plain version on the CPU).

    Args:
        x: QTensor (consumed at its own scale) or float NHWC tensor (the
            chain entry, quantized at [x_scale])
        w: [Cout, kh, kw, Cin] int8; w_scale, bias: [Cout] float32
        x_scale, y_scale: the node's calibrated scales (Python floats)
        stride: int or (sh, sw); pads: (top, bottom, left, right)

    Returns:
        QTensor at y_scale
    """

    if not isinstance(x, QTensor):
        x = qt_quantize(x, x_scale)
    scale = w_scale * float(np.float32(x.scale))
    y_q = conv_int8.conv_int8(x.q, w, scale, bias, _pair(stride), pads,
                              y_scale, act=act)
    return QTensor(y_q, y_scale)


def quantized_conv(x, w, w_scale, bias, stride, pads, stats=None,
                   act=True, dtype=torch.float32, x_scale=None):
    """
    int8 conv with float input and output, the JAX module's
    quantized_conv: x (NHWC) is quantized at [x_scale] (a float32 0-d
    tensor on x's device: the static scale) or, without one, at the
    dynamic abs-max scale max(|x|max, 1e-6) / 127; the conv kernel runs in
    its int32 mode, and the float epilogue acc * (w_scale * x_scale) +
    bias follows in torch, cast to [dtype], then SiLU in that dtype when
    [act] (in bf16 rounded at each op, as the JAX module's accum_dtype
    path computes it).

    [stats], when a dict, records the input and output abs-max under 'in'
    and 'out' (the largest seen).
    """

    x = x.to(torch.float32)
    if stats is not None:
        stats['in'] = max(stats.get('in', 0.0), float(x.abs().max()))
    if x_scale is None:
        x_scale = torch.clamp(x.abs().max(), min=1e-6) / scalar_like(127.0,
                                                                     x)
    x_q = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    acc = conv_int8.conv_int8(x_q.contiguous(), w, None, None,
                              _pair(stride), pads, None)
    y = (acc.to(torch.float32) * (w_scale * x_scale) + bias).to(dtype)
    if act:
        y = y * (sigmoid_bf16_reference(y) if dtype == torch.bfloat16
                 else torch.sigmoid(y))
    if stats is not None:
        stats['out'] = max(stats.get('out', 0.0), float(y.abs().max()))
    return y


def fused_bottleneck(x, w1, w1_scale, b1, mid_scale, w2, w2_scale, b2,
                     cv2_scale, shortcut):
    """
    A whole CSP bottleneck (1x1 chained conv -> 3x3 chained conv ->
    qt_add) on the fused bottleneck kernel; bit-identical to the unfused
    chain. x is a QTensor; w1 [C, 1, 1, C] and w2 [C, 3, 3, C] int8.
    Returns a QTensor.
    """

    s_in = x.scale
    scale1 = w1_scale * float(np.float32(s_in))
    scale2 = w2_scale * float(np.float32(mid_scale))
    q, scale = bottleneck_int8.bottleneck_int8(
        x.q, w1, scale1, b1, mid_scale, w2, scale2, b2, cv2_scale, s_in,
        shortcut)
    return QTensor(q, scale)


#%% Calibration


def _calibration_network(config, params_q):
    """The port's network for [config] (YOLOv5 or EfficientNet) holding
    [params_q], and the forward that calibration runs on it."""

    from megadetector_tpu_torch.models import efficientnet, yolov5

    if isinstance(config, efficientnet.EfficientNetConfig):
        model = efficientnet.EfficientNet(config).load_params(params_q)
        return model, model
    model = yolov5.YoloV5(config).load_params(params_q)
    return model, lambda x: model(x, decode=False)


def _calibration_forward(config, params_q, sample_images, device):
    """The port's float32 forward of [params_q] over [sample_images] on
    [device] with every uncalibrated int8 conv in quantized_conv at its
    dynamic scale, each recording its abs-max statistics; returns the
    [(module name, stats dict)] of those convs."""

    device = get_device(device)
    model, forward = _calibration_network(config, params_q)
    model = model.eval().to(device)
    qconvs = [(name, m) for name, m in model.named_modules()
              if hasattr(m, 'stats') and hasattr(m, 'y_scale')]
    if not qconvs:
        raise ValueError('Calibration matched no quantized convs')
    for _, m in qconvs:
        if m.y_scale is not None or getattr(m, 'x_scale', None) is not None:
            raise ValueError('calibration: the parameters are already '
                             'calibrated')
        m.stats = {'in': 0.0, 'out': 0.0}
    x = torch.from_numpy(np.asarray(sample_images, np.float32))
    with torch.inference_mode():
        forward(x.to(device))
    return [(name, m.stats) for name, m in qconvs]


def _node_at(params_q, name):
    """The parameter node of module [name] ('layers.<pytree path>')."""

    node = params_q
    for key in name.split('.')[1:]:
        node = node[key]
    return node


def calibrate_chain_scales(config, params_q, sample_images, headroom=1.0,
                           device=None):
    """
    Calibrate the static scales of every int8 conv node of [params_q]
    (quantize_params_chain output, without scales; YOLOv5 or
    EfficientNet, by [config]'s type) by running the port's float32
    forward over [sample_images] ([N, H, W, 3] float, as the network
    takes them) with every int8 conv in quantized_conv, recording its
    input and output abs-max and, for an EfficientNet project conv under a
    residual, the float sum's abs-max ('res'). Sets x_scale =
    max(in * headroom, 1e-6) / 127, y_scale and res_scale likewise, in
    place; returns params_q. [device] is as get_device takes it: None
    means the card, 'cpu' the CPU.
    """

    for name, stats in _calibration_forward(config, params_q, sample_images,
                                            device):
        node = _node_at(params_q, name)
        for key, stat in (('x_scale', 'in'), ('y_scale', 'out'),
                          ('res_scale', 'res')):
            if stat in stats:
                node[key] = float(max(stats[stat] * headroom, 1e-6) /
                                  127.0)
    return params_q


def calibrate_activation_scales(config, params_q, sample_images,
                                percentile_headroom=1.0, device=None):
    """
    Calibrate the static input scale of every int8 conv of [params_q]
    (quantize_params output, YOLOv5): the port's float32 forward over
    [sample_images] ([N, H, W, 3] float in [0, 1]) with every int8 conv
    quantizing at its dynamic abs-max scale records each one's input
    abs-max, and x_scale = float32(max(absmax * percentile_headroom,
    1e-6) / 127) is set in place, as the JAX module writes it. Returns
    params_q. [device] is as get_device takes it: None means the card,
    'cpu' the CPU.
    """

    for name, stats in _calibration_forward(config, params_q, sample_images,
                                            device):
        _node_at(params_q, name)['x_scale'] = np.float32(
            max(stats['in'] * percentile_headroom, 1e-6) / 127.0)
    return params_q
