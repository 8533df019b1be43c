"""
YOLOv5-family detection network as a torch nn.Module (counterpart of
megadetector_tpu/models/yolov5.py).

The config tables, make_divisible and init_params are the JAX module's,
line for line, so both packages build the same architecture and draw the
same random parameters from a seed. The network is an inference graph
with BatchNorm folded into the weights: a Conv is conv + bias + SiLU.

The public forward keeps the JAX layout: it takes NHWC images (uint8
pixels, or floats in [0, 1]) and returns NHWC per-level head tensors [B,
H_l, W_l, na*(5+nc)] or the decoded [B, A, 5+nc]. Inside, the float
convolutions run on an NCHW view of the NHWC input (channels_last strides,
no copy).

Compute dtype (set_compute_dtype): float32, or bf16 as the JAX package's
apply(dtype=bfloat16) computes: float weights and biases cast to bf16, each
conv rounded to bf16, then + b rounded, then SiLU with a rounding after
each op (ops/silu_bf16.py, the E7 kernel on a card, which fuses the bias
add). A bf16 model may run l0 as the fused stem (ops/l0_fused.py, the B4
kernel) straight from uint8 pixels; otherwise uint8 input becomes bf16(u8 /
255), as the JAX detector's program computes it. The detect heads run in
bf16 and are decoded in float32.

int8 parameters (nodes with 'w_q', ops/quantization.py) load as QConv
modules. Chain nodes (x_scale and y_scale) take and give QTensors (int8
NHWC + a static scale) through the int8 conv kernel; static nodes
(mode='static' checkpoints: x_scale alone, detect heads included once nc
>= 17) take and give float tensors, the int8 conv kernel in its int32 mode
between a quantize and a float epilogue; and
YoloV5(fuse_bottlenecks=True) runs every bottleneck whose convs are both
chained as the fused bottleneck kernel (the JAX conv_backend=pallas route).
Float tensors stay NCHW and QTensors NHWC; concat, add, pool and upsample
take either, and float convs (l0, the detect heads) dequantize QTensor
inputs. Width/height folding and im2col exist only to fit the TPU and are
not ported (folded checkpoints are unfolded on load).

Training (set_training): the float32 weights stay nn.Parameters, the
master copy, and each Conv casts its weight and bias to the training dtype
inside its forward, so autograd carries the gradient through the cast to
the float32 parameter, as jax.grad does through the JAX apply(dtype=
bfloat16)'s astype. In bf16 silu_bf16 then records itself for autograd
(its backward is the E7 backward kernel on a card). export_params is the
inverse of load_params for float networks: the module's parameters as a
JAX-layout numpy pytree (HWIO), ready for save_checkpoint.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from megadetector_tpu_torch.device import device_constant
from megadetector_tpu_torch.models.convert_weights import params_to_torch
from megadetector_tpu_torch.models.params import num_params  # noqa: F401
from megadetector_tpu_torch.ops import bottleneck_int8, l0_fused
from megadetector_tpu_torch.ops import quantization as q
from megadetector_tpu_torch.ops.conv_int8 import scalar_like
from megadetector_tpu_torch.ops.quantization import QTensor
from megadetector_tpu_torch.ops.silu_bf16 import silu_bf16

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


#%% Architecture configs (same tables as the JAX module)

# (depth_multiple, width_multiple) per published variant
VARIANT_MULTIPLES = {
    'n': (0.33, 0.25),
    's': (0.33, 0.50),
    'm': (0.67, 0.75),
    'l': (1.00, 1.00),
    'x': (1.33, 1.25),
}

# P5 anchors (strides 8/16/32), pixel units at the native image scale
ANCHORS_P5 = [
    [(10, 13), (16, 30), (33, 23)],
    [(30, 61), (62, 45), (59, 119)],
    [(116, 90), (156, 198), (373, 326)],
]

# P6 anchors (strides 8/16/32/64) used by the -6 1280px variants (= MDv5)
ANCHORS_P6 = [
    [(19, 27), (44, 40), (38, 94)],
    [(96, 68), (86, 152), (180, 137)],
    [(140, 301), (303, 264), (238, 542)],
    [(436, 615), (739, 380), (925, 792)],
]

# Layer spec: (from, repeats, kind, args); see the JAX module
P5_LAYERS = [
    (-1, 1, 'conv', (64, 6, 2, 2)),  # 0  P1/2 (explicit pad 2)
    (-1, 1, 'conv', (128, 3, 2)),    # 1  P2/4
    (-1, 3, 'c3', (128, True)),      # 2
    (-1, 1, 'conv', (256, 3, 2)),    # 3  P3/8
    (-1, 6, 'c3', (256, True)),      # 4
    (-1, 1, 'conv', (512, 3, 2)),    # 5  P4/16
    (-1, 9, 'c3', (512, True)),      # 6
    (-1, 1, 'conv', (1024, 3, 2)),   # 7  P5/32
    (-1, 3, 'c3', (1024, True)),     # 8
    (-1, 1, 'sppf', (1024, 5)),      # 9
    (-1, 1, 'conv', (512, 1, 1)),    # 10
    (-1, 1, 'up', ()),               # 11
    ([-1, 6], 1, 'cat', ()),         # 12
    (-1, 3, 'c3', (512, False)),     # 13
    (-1, 1, 'conv', (256, 1, 1)),    # 14
    (-1, 1, 'up', ()),               # 15
    ([-1, 4], 1, 'cat', ()),         # 16
    (-1, 3, 'c3', (256, False)),     # 17 P3 out
    (-1, 1, 'conv', (256, 3, 2)),    # 18
    ([-1, 14], 1, 'cat', ()),        # 19
    (-1, 3, 'c3', (512, False)),     # 20 P4 out
    (-1, 1, 'conv', (512, 3, 2)),    # 21
    ([-1, 10], 1, 'cat', ()),        # 22
    (-1, 3, 'c3', (1024, False)),    # 23 P5 out
    ([17, 20, 23], 1, 'detect', ()),  # 24
]

P6_LAYERS = [
    (-1, 1, 'conv', (64, 6, 2, 2)),  # 0  P1/2 (explicit pad 2)
    (-1, 1, 'conv', (128, 3, 2)),    # 1  P2/4
    (-1, 3, 'c3', (128, True)),      # 2
    (-1, 1, 'conv', (256, 3, 2)),    # 3  P3/8
    (-1, 6, 'c3', (256, True)),      # 4
    (-1, 1, 'conv', (512, 3, 2)),    # 5  P4/16
    (-1, 9, 'c3', (512, True)),      # 6
    (-1, 1, 'conv', (768, 3, 2)),    # 7  P5/32
    (-1, 3, 'c3', (768, True)),      # 8
    (-1, 1, 'conv', (1024, 3, 2)),   # 9  P6/64
    (-1, 3, 'c3', (1024, True)),     # 10
    (-1, 1, 'sppf', (1024, 5)),      # 11
    (-1, 1, 'conv', (768, 1, 1)),    # 12
    (-1, 1, 'up', ()),               # 13
    ([-1, 8], 1, 'cat', ()),         # 14
    (-1, 3, 'c3', (768, False)),     # 15
    (-1, 1, 'conv', (512, 1, 1)),    # 16
    (-1, 1, 'up', ()),               # 17
    ([-1, 6], 1, 'cat', ()),         # 18
    (-1, 3, 'c3', (512, False)),     # 19
    (-1, 1, 'conv', (256, 1, 1)),    # 20
    (-1, 1, 'up', ()),               # 21
    ([-1, 4], 1, 'cat', ()),         # 22
    (-1, 3, 'c3', (256, False)),     # 23 P3 out
    (-1, 1, 'conv', (256, 3, 2)),    # 24
    ([-1, 20], 1, 'cat', ()),        # 25
    (-1, 3, 'c3', (512, False)),     # 26 P4 out
    (-1, 1, 'conv', (512, 3, 2)),    # 27
    ([-1, 16], 1, 'cat', ()),        # 28
    (-1, 3, 'c3', (768, False)),     # 29 P5 out
    (-1, 1, 'conv', (768, 3, 2)),    # 30
    ([-1, 12], 1, 'cat', ()),        # 31
    (-1, 3, 'c3', (1024, False)),    # 32 P6 out
    ([23, 26, 29, 32], 1, 'detect', ()),  # 33
]


def make_divisible(x, divisor=8):
    """Round channel counts up to the nearest multiple of [divisor]."""

    return int(math.ceil(x / divisor) * divisor)


class YoloV5Config:
    """Resolved architecture: per-layer channel counts, strides, anchors."""

    def __init__(self, arch='yolov5l6', num_classes=3, anchors=None):
        if not arch.startswith('yolov5'):
            raise ValueError('Unknown arch {}'.format(arch))
        suffix = arch[len('yolov5'):]
        p6 = suffix.endswith('6')
        variant = suffix[:-1] if p6 else suffix
        if variant not in VARIANT_MULTIPLES:
            raise ValueError('Unknown yolov5 variant {}'.format(variant))

        self.arch = arch
        self.num_classes = num_classes
        gd, gw = VARIANT_MULTIPLES[variant]
        self.depth_multiple = gd
        self.width_multiple = gw
        spec = P6_LAYERS if p6 else P5_LAYERS
        self.strides = (8, 16, 32, 64) if p6 else (8, 16, 32)
        default_anchors = ANCHORS_P6 if p6 else ANCHORS_P5
        self.anchors = np.asarray(
            anchors if anchors is not None else default_anchors,
            dtype=np.float32)
        self.num_anchors = self.anchors.shape[1]
        self.max_stride = self.strides[-1]

        # channels[0] is the network input; layer f's output channel count
        # lives at channels[f + 1]
        self.layers = []
        channels = [3]

        def ch(f):
            return channels[-1] if f == -1 else channels[f + 1]

        for (frm, repeats, kind, args) in spec:
            n = max(round(repeats * gd), 1) if repeats > 1 else repeats
            if kind == 'conv':
                c_out = make_divisible(args[0] * gw)
                pad = args[3] if len(args) > 3 else args[1] // 2
                entry = dict(frm=frm, kind=kind, n=1, c_in=ch(frm),
                             c_out=c_out, k=args[1], s=args[2], p=pad)
            elif kind == 'c3':
                c_out = make_divisible(args[0] * gw)
                entry = dict(frm=frm, kind=kind, n=n, c_in=ch(frm),
                             c_out=c_out, shortcut=args[1])
            elif kind == 'sppf':
                c_out = make_divisible(args[0] * gw)
                entry = dict(frm=frm, kind=kind, n=1, c_in=ch(frm),
                             c_out=c_out, pool_k=args[1])
            elif kind == 'up':
                c_out = ch(frm)
                entry = dict(frm=frm, kind=kind, n=1, c_out=c_out)
            elif kind == 'cat':
                c_out = sum(ch(f) for f in frm)
                entry = dict(frm=frm, kind=kind, n=1, c_out=c_out)
            elif kind == 'detect':
                entry = dict(frm=frm, kind=kind, n=1,
                             c_ins=[ch(f) for f in frm], c_out=0)
            else:
                raise ValueError(kind)
            self.layers.append(entry)
            channels.append(entry['c_out'])

        # Which layer outputs must be retained for later layers
        needed = set()
        for entry in self.layers:
            frm = entry['frm']
            for f in (frm if isinstance(frm, list) else [frm]):
                if f != -1:
                    needed.add(f)
        self.save_indices = needed

    @property
    def num_outputs(self):
        return self.num_classes + 5


#%% Parameter initialization (numpy RNG; same draws as the JAX module)


def _init_conv(rng, c_in, c_out, k):
    """He-normal conv weight [k, k, c_in, c_out] (HWIO) + zero bias."""

    fan_in = c_in * k * k
    std = math.sqrt(2.0 / fan_in)
    w = rng.standard_normal((k, k, c_in, c_out)).astype(np.float32) * std
    return {'w': w, 'b': np.zeros((c_out,), dtype=np.float32)}


def _init_c3(rng, c_in, c_out, n):
    c_h = int(c_out * 0.5)
    params = {
        'cv1': _init_conv(rng, c_in, c_h, 1),
        'cv2': _init_conv(rng, c_in, c_h, 1),
        'cv3': _init_conv(rng, 2 * c_h, c_out, 1),
    }
    for j in range(n):
        params['m{}'.format(j)] = {
            'cv1': _init_conv(rng, c_h, c_h, 1),
            'cv2': _init_conv(rng, c_h, c_h, 3),
        }
    return params


def init_params(config, seed=0):
    """Random numpy parameters (JAX pytree layout, HWIO) for [config]."""

    rng = np.random.RandomState(seed)
    params = {}
    for i, entry in enumerate(config.layers):
        kind = entry['kind']
        name = 'l{}'.format(i)
        if kind == 'conv':
            params[name] = _init_conv(
                rng, entry['c_in'], entry['c_out'], entry['k'])
        elif kind == 'c3':
            params[name] = _init_c3(
                rng, entry['c_in'], entry['c_out'], entry['n'])
        elif kind == 'sppf':
            c_h = entry['c_in'] // 2
            params[name] = {
                'cv1': _init_conv(rng, entry['c_in'], c_h, 1),
                'cv2': _init_conv(rng, c_h * 4, entry['c_out'], 1),
            }
        elif kind == 'detect':
            no = config.num_outputs * config.num_anchors
            heads = {}
            for lvl, c_in in enumerate(entry['c_ins']):
                heads['m{}'.format(lvl)] = _init_conv(rng, c_in, no, 1)
            params[name] = heads
    return params


#%% Tensors of either kind: float NCHW or QTensor (int8 NHWC)


def _float_nchw(x, dtype=torch.float32):
    """A float NCHW tensor; QTensors are dequantized into [dtype] (in bf16
    as the JAX qt_dequant does: bf16(q) * bf16(scale), rounded)."""

    if not isinstance(x, QTensor):
        return x
    return q.qt_dequant(x, dtype).permute(0, 3, 1, 2)


def _cat(xs):
    """Channel concat: QTensors through qt_concat, else float NCHW."""

    if all(isinstance(x, QTensor) for x in xs):
        return q.qt_concat(xs)
    return torch.cat([_float_nchw(x) for x in xs], dim=1)


def _add(a, b):
    if isinstance(a, QTensor) and isinstance(b, QTensor):
        return q.qt_add(a, b)
    return _float_nchw(a) + _float_nchw(b)


def _maxpool(x, k):
    if isinstance(x, QTensor):
        return q.qt_maxpool(x, k)
    return F.max_pool2d(x, k, 1, k // 2)


def _upsample2x(x):
    if isinstance(x, QTensor):
        return q.qt_upsample2x(x)
    return F.interpolate(x, scale_factor=2, mode='nearest')


#%% Modules (parameter names follow the pytree keys)


class Conv(nn.Module):
    """Conv + bias (+ SiLU); BatchNorm is already folded into the weights."""

    def __init__(self, c_in, c_out, k, s=1, p=None, act=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride = s
        self.padding = k // 2 if p is None else p
        self.act = act
        # Training in bf16 (YoloV5.set_training): the float32 weight and
        # bias are cast to this dtype in each forward; None: used as held
        self.cast = None

    def forward(self, x):
        w, b = self.weight, self.bias
        if self.cast is not None:
            w, b = w.to(self.cast), b.to(self.cast)
        x = _float_nchw(x, w.dtype)
        if w.dtype == torch.bfloat16:
            # The JAX rounding points: the conv rounds to bf16, + b rounds,
            # then the activation (silu_bf16 adds the bias itself)
            y = F.conv2d(x, w, None, self.stride, self.padding)
            return silu_bf16(y, b) if self.act else y + b.view(1, -1, 1, 1)
        y = F.conv2d(x, w, b, self.stride, self.padding)
        return F.silu(y) if self.act else y


class QConv(nn.Module):
    """
    int8 conv in place of a Conv: int8 weight [Cout, kh, kw, Cin], float32
    w_scale and bias buffers; a chain node's x_scale / y_scale are Python
    floats, a static node's x_scale a float32 0-d buffer.

    A chain node (x_scale and y_scale, SiLU) returns a QTensor at y_scale
    (quantization.chained_conv). A static node (mode='static': x_scale
    alone; the detect heads too, without SiLU) takes and gives float
    tensors in the input's dtype: quantization.quantized_conv at the
    static scale, the conv kernel in its int32 mode and the float
    epilogue in torch, as the JAX module's quantized_conv computes it.
    Uncalibrated (no scale), it is the calibration forward's
    quantized_conv at the dynamic scale; setting [stats] to a dict
    records its input and output abs-max there.
    """

    def __init__(self, conv, node):
        super().__init__()
        if 'y_scale' in node and 'x_scale' not in node:
            raise ValueError('an int8 chain conv node needs its x_scale')
        if 'y_scale' in node and not conv.act:
            raise ValueError('int8 chain convs without SiLU (the detect '
                             'heads) are not part of the chain')
        self.register_buffer('weight', node['w_q'])
        self.register_buffer('w_scale', node['w_scale'])
        self.register_buffer('bias', node['b'])
        self.y_scale = node.get('y_scale')
        if self.y_scale is not None:
            self.x_scale = node['x_scale']
        else:
            # The static input scale (None uncalibrated) as a float32 0-d
            # tensor on the module's device: dividing by it is an IEEE
            # division on the card too
            self.register_buffer(
                'x_scale', None if 'x_scale' not in node else
                torch.tensor(np.float32(node['x_scale'])), persistent=False)
        self.act = conv.act
        self.stride = conv.stride
        self.pads = q.conv_pads(conv.padding, self.weight.shape[1])
        self.stats = None

    def forward(self, x):
        if self.y_scale is not None:
            if not isinstance(x, QTensor):
                x = x.permute(0, 2, 3, 1)
            return q.chained_conv(x, self.weight, self.w_scale, self.bias,
                                  self.x_scale, self.y_scale, self.stride,
                                  self.pads)
        x = _float_nchw(x)
        y = q.quantized_conv(x.permute(0, 2, 3, 1), self.weight,
                             self.w_scale, self.bias, self.stride,
                             self.pads, self.stats, act=self.act,
                             dtype=x.dtype, x_scale=self.x_scale)
        return y.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (-> residual add). With [fused] and both convs chained,
    a QTensor input whose shape ops/bottleneck_int8.bottleneck_tiling
    takes runs the fused bottleneck kernel; every other one runs the two
    convs and the add, which give the same output."""

    def __init__(self, c, shortcut, fused=False):
        super().__init__()
        self.cv1 = Conv(c, c, 1)
        self.cv2 = Conv(c, c, 3)
        self.shortcut = shortcut
        self.fused = fused

    def forward(self, x):
        cv1, cv2 = self.cv1, self.cv2
        if self.fused and isinstance(x, QTensor) and \
                isinstance(cv1, QConv) and isinstance(cv2, QConv) and \
                cv1.y_scale is not None and cv2.y_scale is not None and \
                bottleneck_int8.bottleneck_tiling(*x.q.shape) is not None:
            return q.fused_bottleneck(
                x, cv1.weight, cv1.w_scale, cv1.bias, cv1.y_scale,
                cv2.weight, cv2.w_scale, cv2.bias, cv2.y_scale,
                self.shortcut)
        h = cv2(cv1(x))
        return _add(x, h) if self.shortcut else h


class C3(nn.Module):
    """CSP block: two 1x1 branches, n bottlenecks on the first, 1x1 merge."""

    def __init__(self, c_in, c_out, n, shortcut, fuse_bottlenecks=False):
        super().__init__()
        c_h = int(c_out * 0.5)
        self.cv1 = Conv(c_in, c_h, 1)
        self.cv2 = Conv(c_in, c_h, 1)
        self.cv3 = Conv(2 * c_h, c_out, 1)
        self.n = n
        for j in range(n):
            self.add_module('m{}'.format(j), Bottleneck(
                c_h, shortcut, fuse_bottlenecks))

    def forward(self, x):
        y1 = self.cv1(x)
        y2 = self.cv2(x)
        for j in range(self.n):
            y1 = getattr(self, 'm{}'.format(j))(y1)
        return self.cv3(_cat([y1, y2]))


class SPPF(nn.Module):
    """Three chained stride-1 SAME max pools (-inf padding), concat, 1x1."""

    def __init__(self, c_in, c_out, pool_k):
        super().__init__()
        c_h = c_in // 2
        self.cv1 = Conv(c_in, c_h, 1)
        self.cv2 = Conv(c_h * 4, c_out, 1)
        self.pool_k = pool_k

    def forward(self, x):
        y = self.cv1(x)
        pools = [y]
        for _ in range(3):
            pools.append(_maxpool(pools[-1], self.pool_k))
        return self.cv2(_cat(pools))


class Detect(nn.Module):
    """Per-level 1x1 linear heads (no activation)."""

    def __init__(self, c_ins, no):
        super().__init__()
        for lvl, c_in in enumerate(c_ins):
            self.add_module('m{}'.format(lvl), Conv(c_in, no, 1, act=False))

    def forward(self, xs):
        return [getattr(self, 'm{}'.format(lvl))(x)
                for lvl, x in enumerate(xs)]


def _decode_level(raw, anchors_level, stride, num_outputs):
    """
    Anchor-grid decode of one NHWC head [B, H, W, na*(5+nc)] ->
    [B, H*W*na, 5+nc] in canvas pixels (YOLOv5 v6: xy = (2s - 0.5 +
    grid) * stride, wh = (2s)^2 * anchor).
    """

    b, h, w, _ = raw.shape
    na = anchors_level.shape[0]
    y = torch.sigmoid(raw.reshape(b, h, w, na, num_outputs).float())
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=raw.device),
        torch.arange(w, dtype=torch.float32, device=raw.device),
        indexing='ij')
    grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]
    xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
    anchor = device_constant(anchors_level, torch.float32, raw.device)
    wh = torch.square(y[..., 2:4] * 2.0) * anchor
    out = torch.cat([xy, wh, y[..., 4:]], dim=-1)
    return out.reshape(b, h * w * na, num_outputs)


def load_conv_params(model, params_np):
    """
    Load a JAX-layout numpy pytree into [model], whose conv modules sit at
    the pytree's paths under model.layers: float nodes (HWIO 'w', 'b') into
    the Conv modules; int8 nodes ('w_q', 'w_scale', 'b', static scales)
    replace their Conv with a QConv. Returns [model].
    """

    state = {}

    def walk(node, path):
        if 'b' in node and ('w' in node or 'w_q' in node):
            name = '.'.join(path)
            if 'w_q' in node:
                parent = model.get_submodule('.'.join(path[:-1]))
                conv = getattr(parent, path[-1])
                if not isinstance(conv, Conv):
                    raise ValueError('{} is not a float Conv to '
                                     'replace'.format(name))
                setattr(parent, path[-1], QConv(conv, node))
                keys = {'w_q': 'weight', 'w_scale': 'w_scale',
                        'b': 'bias'}
            else:
                keys = {'w': 'weight', 'b': 'bias'}
            extra = set(node) - set(keys) - set(q.SCALE_KEYS)
            if extra:
                raise ValueError('{}: unexpected leaves {}'.format(
                    name, sorted(extra)))
            for k, v in keys.items():
                state[name + '.' + v] = node[k]
            return
        for k, v in node.items():
            if not isinstance(v, dict):
                raise ValueError('Leaf {} outside a conv node'.format(
                    '.'.join(path + [k])))
            walk(v, path + [k])

    walk(params_to_torch(params_np), ['layers'])
    model.load_state_dict(state, strict=True)
    return model


def network_input(x, compute_dtype):
    """A batch as the JAX programs feed it to the network: uint8 pixels
    become [compute_dtype](u8 / 255) (in bf16: the float32 quotient
    rounded once, as bf16(u8) / bf16(255) computes); float images are cast
    to [compute_dtype]."""

    if x.dtype == torch.uint8:
        if compute_dtype == torch.bfloat16:
            x = (x.float() / scalar_like(255.0, x)).to(torch.bfloat16)
        else:
            x = x.float() / 255.0
    return x.to(compute_dtype)


class YoloV5(nn.Module):
    """The network for a YoloV5Config; load weights with load_params.
    fuse_bottlenecks routes chained int8 bottlenecks to the fused
    bottleneck kernel (else each of their convs runs the conv kernel)."""

    def __init__(self, config, fuse_bottlenecks=False):
        super().__init__()
        self.config = config
        self.compute_dtype = torch.float32
        # set_training's dtype; None: inference
        self.train_dtype = None
        # The fused stem's weights (set_compute_dtype); None: l0 runs as a
        # plain conv. _stem_versions: l0's weight and bias versions they
        # were made from
        self.register_buffer('stem_w', None, persistent=False)
        self.register_buffer('stem_b', None, persistent=False)
        self._stem_versions = None
        self.layers = nn.ModuleDict()
        for i, e in enumerate(config.layers):
            name = 'l{}'.format(i)
            if e['kind'] == 'conv':
                self.layers[name] = Conv(e['c_in'], e['c_out'], e['k'],
                                         e['s'], e['p'])
            elif e['kind'] == 'c3':
                self.layers[name] = C3(e['c_in'], e['c_out'], e['n'],
                                       e['shortcut'], fuse_bottlenecks)
            elif e['kind'] == 'sppf':
                self.layers[name] = SPPF(e['c_in'], e['c_out'],
                                         e['pool_k'])
            elif e['kind'] == 'detect':
                self.layers[name] = Detect(
                    e['c_ins'], config.num_outputs * config.num_anchors)

    def load_params(self, params_np):
        """Load a JAX-layout numpy pytree (load_conv_params)."""

        return load_conv_params(self, params_np)

    def set_compute_dtype(self, dtype, fused_stem=False):
        """
        Compute in [dtype] (float32 or bf16; call once, after load_params,
        on float32 weights). bf16 casts every float conv's weight and bias
        to bf16 (int8 convs are unchanged); with [fused_stem] and a float
        l0, l0 then runs from uint8 pixels as the fused stem, whose weights
        are bf16(w / 255) of the float32 l0 weights.
        """

        if dtype not in COMPUTE_DTYPES:
            raise ValueError('compute dtype must be one of {}, got {}'.format(
                COMPUTE_DTYPES, dtype))
        if self.compute_dtype != torch.float32:
            raise ValueError('set_compute_dtype: already {}'.format(
                self.compute_dtype))
        self.compute_dtype = dtype
        if dtype == torch.float32:
            return self
        l0 = self.layers['l0']
        if fused_stem and type(l0) is Conv:
            w = l0.weight.detach().float().permute(2, 3, 1, 0).cpu().numpy()
            b = l0.bias.detach().float().cpu().numpy()
            self.stem_w, self.stem_b = l0_fused.prepare_l0_weights(
                {'w': w, 'b': b})
            self.stem_w = self.stem_w.to(l0.weight.device)
            self.stem_b = self.stem_b.to(l0.weight.device)
        for m in self.modules():
            if type(m) is Conv:
                m.weight.data = m.weight.data.to(dtype)
                m.bias.data = m.bias.data.to(dtype)
        if self.stem_w is not None:
            self._stem_versions = (l0.weight._version, l0.bias._version)
        return self

    def set_training(self, dtype):
        """
        Training mode in [dtype] (float32 or bf16), or back to inference
        with None. Needs float32 weights (no set_compute_dtype to bf16: it
        casts them in place) and no int8 convs. The float32 weights and
        biases stay the parameters; in bf16 each Conv casts them in its
        forward. Returns self.
        """

        if dtype is not None and dtype not in COMPUTE_DTYPES:
            raise ValueError('training dtype must be one of {} or None, got '
                             '{}'.format(COMPUTE_DTYPES, dtype))
        if self.compute_dtype != torch.float32:
            raise ValueError('set_training needs the float32 weights; this '
                             'model computes in {}'.format(self.compute_dtype))
        if any(type(m) is QConv for m in self.modules()):
            raise ValueError('int8 convs do not train')
        cast = dtype if dtype == torch.bfloat16 else None
        for m in self.modules():
            if type(m) is Conv:
                m.cast = cast
        self.train_dtype = dtype
        return self

    def export_params(self):
        """The float parameters as a JAX-layout numpy pytree (HWIO 'w',
        'b', float32), the inverse of load_params."""

        params = {}
        for name, m in self.named_modules():
            if type(m) is QConv:
                raise ValueError('{}: int8 convs are not exported'.format(
                    name))
            if type(m) is not Conv:
                continue
            node = params
            for key in name.split('.')[1:]:
                node = node.setdefault(key, {})
            node['w'] = m.weight.detach().float().permute(
                2, 3, 1, 0).cpu().numpy().copy()
            node['b'] = m.bias.detach().float().cpu().numpy().copy()
        return params

    def check_stem(self):
        """Raise ValueError when the fused stem's weights were made from an
        l0 whose parameters have changed since."""

        l0 = self.layers['l0']
        if self.stem_w is not None and self._stem_versions != (
                l0.weight._version, l0.bias._version):
            raise ValueError(
                'The fused stem\'s weights were made from l0\'s weights '
                'before they changed; load the trained weights into a new '
                'model (export_params, load_params, set_compute_dtype)')

    def _input(self, x):
        """(l0's NCHW input in the compute dtype, None) for the NHWC
        batch, or (None, l0's output) when the fused stem takes the uint8
        pixels. The fused stem refuses to run on weights made from an l0
        whose parameters have changed since (an optimizer step, a
        load_params): set_compute_dtype makes them, once."""

        if x.dtype == torch.uint8 and self.stem_w is not None:
            # A trace sees the parameters through stand-ins with versions
            # of their own: the exporter checks before it traces
            if not torch.compiler.is_compiling():
                self.check_stem()
            out = l0_fused.l0_fused(x.contiguous(), self.stem_w, self.stem_b)
            return None, out.permute(0, 3, 1, 2)
        dtype = self.train_dtype or self.compute_dtype
        return network_input(x, dtype).permute(0, 3, 1, 2), None

    def forward(self, x, decode=True):
        """
        Args:
            x: [B, H, W, 3] uint8 pixels, or float images in [0, 1]; H and
                W multiples of config.max_stride
            decode: True -> decoded [B, A, 5+nc] in canvas pixels;
                False -> list of raw NHWC heads [B, H_l, W_l, na*(5+nc)]
                (in the compute dtype)
        """

        config = self.config
        prev, stem_out = self._input(x)
        saved = {}
        heads = None
        for i, entry in enumerate(config.layers):
            kind = entry['kind']
            frm = entry['frm']
            if i == 0 and stem_out is not None:
                out = stem_out
            elif kind == 'cat':
                out = _cat([prev if f == -1 else saved[f] for f in frm])
            elif kind == 'detect':
                heads = self.layers['l{}'.format(i)](
                    [saved[f] for f in frm])
                out = prev
            else:
                src = prev if frm == -1 else saved[frm]
                if kind == 'up':
                    out = _upsample2x(src)
                else:
                    out = self.layers['l{}'.format(i)](src)
            if i in config.save_indices:
                saved[i] = out
            prev = out

        if heads is None:
            raise ValueError('Config has no detect layer')
        heads = [h.permute(0, 2, 3, 1).contiguous() for h in heads]
        if not decode:
            return heads
        return torch.cat([
            _decode_level(raw, config.anchors[lvl],
                          float(config.strides[lvl]), config.num_outputs)
            for lvl, raw in enumerate(heads)], dim=1)


def activated_conv_shapes(config, height, width, batch=1):
    """
    The geometry of every activated conv of [config]'s network on a
    [batch, height, width] input, in forward order (l0 first, then the
    convs the int8 chain quantizes), from a forward on the meta device (no
    weights, no arithmetic). Returns dicts with name (the parameter path),
    batch, h, w (input), cin, cout, k, stride, pads (top, bottom, left,
    right), ho and wo.
    """

    with torch.device('meta'):
        model = YoloV5(config).eval()
    names = {m: n for n, m in model.named_modules()}
    shapes = []

    def record(module, inputs, output):
        _, cin, h, w = inputs[0].shape
        _, cout, ho, wo = output.shape
        k = module.weight.shape[2]
        shapes.append({
            'name': names[module][len('layers.'):], 'batch': batch, 'h': h,
            'w': w, 'cin': cin, 'cout': cout, 'k': k,
            'stride': module.stride, 'pads': q.conv_pads(module.padding, k),
            'ho': ho, 'wo': wo})

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if type(m) is Conv and m.act]
    try:
        with torch.inference_mode():
            model(torch.zeros((batch, height, width, 3), device='meta'),
                  decode=False)
    finally:
        for hook in hooks:
            hook.remove()
    return shapes
