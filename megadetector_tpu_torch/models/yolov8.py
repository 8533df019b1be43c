"""
Anchor-free YOLOv8-family detection network (the MDv1000 models) as a
torch nn.Module: counterpart of megadetector_tpu/models/yolov8.py.

The config tables, YoloV8Config and init_params are the JAX module's, line
for line, so the same seed gives the same arrays. The network is built from
models/yolov5.py's Conv and SPPF, as the JAX module builds it from the JAX
yolov5's _conv and _sppf, so a bf16 conv rounds where XLA rounds: the conv,
then + b, then SiLU with a rounding after each op (ops/silu_bf16, the E7
kernel on a card). The detect heads' last 1x1 convs are linear (conv, then
+ b). l0 is a plain 3x3 s2 conv: the fused 6x6 stem is yolov5's only.

Like YoloV5, the forward takes NHWC images (uint8 pixels, or floats in [0,
1]) and returns the decoded [B, A, 5+nc] in canvas pixels (DFL decode in
float32, objectness column fixed at 1.0) or the raw per-level (box, cls)
heads, NHWC, in the compute dtype.
"""

import math

import numpy as np
import torch
import torch.nn as nn

from megadetector_tpu_torch.models.convert_weights import _TorchKeyReader
from megadetector_tpu_torch.models.yolov5 import (
    COMPUTE_DTYPES, SPPF, Conv, _upsample2x, load_conv_params, network_input)

#%% Architecture configs (the JAX module's tables)

# (depth, width, max_channels)
V8_VARIANTS = {
    'n': (0.33, 0.25, 1024),
    's': (0.33, 0.50, 1024),
    'm': (0.67, 0.75, 768),
    'l': (1.00, 1.00, 512),
    'x': (1.00, 1.25, 512),
}

# (from, repeats, kind, args); kinds: conv(c,k,s), c2f(c,shortcut),
# sppf(c,k), up, cat, detect
V8_LAYERS = [
    (-1, 1, 'conv', (64, 3, 2)),     # 0  P1/2
    (-1, 1, 'conv', (128, 3, 2)),    # 1  P2/4
    (-1, 3, 'c2f', (128, True)),     # 2
    (-1, 1, 'conv', (256, 3, 2)),    # 3  P3/8
    (-1, 6, 'c2f', (256, True)),     # 4
    (-1, 1, 'conv', (512, 3, 2)),    # 5  P4/16
    (-1, 6, 'c2f', (512, True)),     # 6
    (-1, 1, 'conv', (1024, 3, 2)),   # 7  P5/32
    (-1, 3, 'c2f', (1024, True)),    # 8
    (-1, 1, 'sppf', (1024, 5)),      # 9
    (-1, 1, 'up', ()),               # 10
    ([-1, 6], 1, 'cat', ()),         # 11
    (-1, 3, 'c2f', (512, False)),    # 12
    (-1, 1, 'up', ()),               # 13
    ([-1, 4], 1, 'cat', ()),         # 14
    (-1, 3, 'c2f', (256, False)),    # 15 P3 out
    (-1, 1, 'conv', (256, 3, 2)),    # 16
    ([-1, 12], 1, 'cat', ()),        # 17
    (-1, 3, 'c2f', (512, False)),    # 18 P4 out
    (-1, 1, 'conv', (512, 3, 2)),    # 19
    ([-1, 9], 1, 'cat', ()),         # 20
    (-1, 3, 'c2f', (1024, False)),   # 21 P5 out
    ([15, 18, 21], 1, 'detect', ()),  # 22
]

REG_MAX = 16


def _make_divisible(x, divisor=8):
    return int(math.ceil(x / divisor) * divisor)


class YoloV8Config:
    """Resolved YOLOv8 architecture."""

    def __init__(self, arch='yolov8l', num_classes=3):
        if not arch.startswith('yolov8'):
            raise ValueError('Unknown arch {}'.format(arch))
        variant = arch[len('yolov8'):]
        if variant not in V8_VARIANTS:
            raise ValueError('Unknown yolov8 variant {}'.format(variant))
        gd, gw, max_ch = V8_VARIANTS[variant]

        self.arch = arch
        self.num_classes = num_classes
        self.strides = (8, 16, 32)
        self.max_stride = 32
        self.reg_max = REG_MAX

        self.layers = []
        channels = [3]

        def ch(f):
            return channels[-1] if f == -1 else channels[f + 1]

        def scale_c(c):
            return _make_divisible(min(c, max_ch) * gw)

        for (frm, repeats, kind, args) in V8_LAYERS:
            n = max(round(repeats * gd), 1) if repeats > 1 else repeats
            if kind == 'conv':
                entry = dict(frm=frm, kind=kind, n=1, c_in=ch(frm),
                             c_out=scale_c(args[0]), k=args[1], s=args[2])
            elif kind == 'c2f':
                entry = dict(frm=frm, kind=kind, n=n, c_in=ch(frm),
                             c_out=scale_c(args[0]), shortcut=args[1])
            elif kind == 'sppf':
                entry = dict(frm=frm, kind=kind, n=1, c_in=ch(frm),
                             c_out=scale_c(args[0]), pool_k=args[1])
            elif kind == 'up':
                entry = dict(frm=frm, kind=kind, n=1, c_out=ch(frm))
            elif kind == 'cat':
                entry = dict(frm=frm, kind=kind, n=1,
                             c_out=sum(ch(f) for f in frm))
            elif kind == 'detect':
                entry = dict(frm=frm, kind=kind, n=1,
                             c_ins=[ch(f) for f in frm], c_out=0)
            self.layers.append(entry)
            channels.append(entry['c_out'])

        # Which layer outputs later layers consume
        needed = set()
        for entry in self.layers:
            frm = entry['frm']
            for f in (frm if isinstance(frm, list) else [frm]):
                if f != -1:
                    needed.add(f)
        self.save_indices = needed

        # Detect-head branch widths (ultralytics conventions)
        detect = self.layers[-1]
        ch0 = detect['c_ins'][0]
        self.head_c2 = max(16, ch0 // 4, self.reg_max * 4)
        self.head_c3 = max(ch0, min(num_classes, 100))


def activated_conv_count(config):
    """The convs with SiLU in [config]'s network (every conv but the detect
    heads' three linear outputs a level): in bf16 each runs the bias + SiLU
    epilogue once a forward."""

    count = 0
    for entry in config.layers:
        if entry['kind'] == 'conv':
            count += 1
        elif entry['kind'] == 'c2f':
            count += 2 + 2 * entry['n']
        elif entry['kind'] == 'sppf':
            count += 2
        elif entry['kind'] == 'detect':
            count += 4 * len(entry['c_ins'])
    return count


#%% Initialization (numpy RNG; the JAX module's draws)


def _conv_slot(rng, c_in, c_out, k):
    fan_in = c_in * k * k
    std = math.sqrt(2.0 / fan_in)
    return {'w': rng.standard_normal((k, k, c_in, c_out))
            .astype(np.float32) * std,
            'b': np.zeros((c_out,), np.float32)}


def init_params(config, seed=0):
    """Random numpy parameters (JAX pytree layout, HWIO) for [config]."""

    rng = np.random.RandomState(seed)
    params = {}
    for i, entry in enumerate(config.layers):
        kind = entry['kind']
        name = 'l{}'.format(i)
        if kind == 'conv':
            params[name] = _conv_slot(rng, entry['c_in'],
                                      entry['c_out'], entry['k'])
        elif kind == 'c2f':
            c_h = entry['c_out'] // 2
            node = {
                'cv1': _conv_slot(rng, entry['c_in'], 2 * c_h, 1),
                'cv2': _conv_slot(rng, (2 + entry['n']) * c_h,
                                  entry['c_out'], 1),
            }
            for j in range(entry['n']):
                node['m{}'.format(j)] = {
                    'cv1': _conv_slot(rng, c_h, c_h, 3),
                    'cv2': _conv_slot(rng, c_h, c_h, 3),
                }
            params[name] = node
        elif kind == 'sppf':
            c_h = entry['c_in'] // 2
            params[name] = {
                'cv1': _conv_slot(rng, entry['c_in'], c_h, 1),
                'cv2': _conv_slot(rng, c_h * 4, entry['c_out'], 1),
            }
        elif kind == 'detect':
            heads = {}
            for lvl, c_in in enumerate(entry['c_ins']):
                heads['box{}'.format(lvl)] = {
                    'cv0': _conv_slot(rng, c_in, config.head_c2, 3),
                    'cv1': _conv_slot(rng, config.head_c2,
                                      config.head_c2, 3),
                    'out': _conv_slot(rng, config.head_c2,
                                      4 * config.reg_max, 1),
                }
                heads['cls{}'.format(lvl)] = {
                    'cv0': _conv_slot(rng, c_in, config.head_c3, 3),
                    'cv1': _conv_slot(rng, config.head_c3,
                                      config.head_c3, 3),
                    'out': _conv_slot(rng, config.head_c3,
                                      config.num_classes, 1),
                }
            params[name] = heads
    return params


#%% Modules (parameter names follow the pytree keys)


class C2fBottleneck(nn.Module):
    """3x3 -> 3x3 (-> residual add)."""

    def __init__(self, c, shortcut):
        super().__init__()
        self.cv1 = Conv(c, c, 3)
        self.cv2 = Conv(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        h = self.cv2(self.cv1(x))
        return x + h if self.shortcut else h


class C2f(nn.Module):
    """1x1 to 2 c_h channels, split in two; n bottlenecks chained on the
    second half, each output kept; concat of all, 1x1 merge. The split is
    on the channel dim (1, NCHW) where JAX splits the last (NHWC) axis."""

    def __init__(self, c_in, c_out, n, shortcut):
        super().__init__()
        c_h = c_out // 2
        self.cv1 = Conv(c_in, 2 * c_h, 1)
        self.cv2 = Conv((2 + n) * c_h, c_out, 1)
        self.n = n
        for j in range(n):
            self.add_module('m{}'.format(j), C2fBottleneck(c_h, shortcut))

    def forward(self, x):
        y = self.cv1(x)
        c_h = y.shape[1] // 2
        parts = [y[:, :c_h], y[:, c_h:]]
        cur = parts[-1]
        for j in range(self.n):
            cur = getattr(self, 'm{}'.format(j))(cur)
            parts.append(cur)
        return self.cv2(torch.cat(parts, dim=1))


class HeadBranch(nn.Module):
    """Two 3x3 convs with SiLU, then the linear 1x1 output conv."""

    def __init__(self, c_in, c_mid, c_out):
        super().__init__()
        self.cv0 = Conv(c_in, c_mid, 3)
        self.cv1 = Conv(c_mid, c_mid, 3)
        self.out = Conv(c_mid, c_out, 1, act=False)

    def forward(self, x):
        return self.out(self.cv1(self.cv0(x)))


class DetectV8(nn.Module):
    """Decoupled heads per level: box{lvl} (4 * reg_max DFL bins) and
    cls{lvl} (class logits)."""

    def __init__(self, config, c_ins):
        super().__init__()
        for lvl, c_in in enumerate(c_ins):
            self.add_module('box{}'.format(lvl), HeadBranch(
                c_in, config.head_c2, 4 * config.reg_max))
            self.add_module('cls{}'.format(lvl), HeadBranch(
                c_in, config.head_c3, config.num_classes))
        self.levels = len(c_ins)

    def forward(self, xs):
        return [(getattr(self, 'box{}'.format(lvl))(x),
                 getattr(self, 'cls{}'.format(lvl))(x))
                for lvl, x in enumerate(xs)]


def decode_level_v8(box_raw, cls_raw, stride, reg_max):
    """
    DFL decode of one level (the JAX _decode_level_v8, in float32): NHWC
    box bins [B, H, W, 4 * reg_max] and class logits [B, H, W, nc] ->
    [B, H*W, 5+nc] (cx, cy, w, h in canvas pixels, obj = 1, sigmoid class
    scores): softmax over each side's bins, their expectation over
    arange(reg_max) gives the l, t, r, b distances from the cell centre
    (grid + 0.5).
    """

    b, h, w, _ = box_raw.shape
    nc = cls_raw.shape[-1]
    device = box_raw.device

    bins = box_raw.reshape(b, h, w, 4, reg_max).float()
    probs = torch.softmax(bins, dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=device)
    dist = torch.sum(probs * proj, dim=-1)  # [B, H, W, 4] = l, t, r, b

    grid_y, grid_x = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing='ij')
    grid_x = (grid_x + 0.5)[None]
    grid_y = (grid_y + 0.5)[None]

    x0 = grid_x - dist[..., 0]
    y0 = grid_y - dist[..., 1]
    x1 = grid_x + dist[..., 2]
    y1 = grid_y + dist[..., 3]
    cx = (x0 + x1) / 2.0 * stride
    cy = (y0 + y1) / 2.0 * stride
    bw = (x1 - x0) * stride
    bh = (y1 - y0) * stride

    cls = torch.sigmoid(cls_raw.float())
    obj = torch.ones((b, h, w, 1), dtype=torch.float32, device=device)
    out = torch.cat([cx[..., None], cy[..., None], bw[..., None],
                     bh[..., None], obj, cls], dim=-1)
    return out.reshape(b, h * w, 5 + nc)


class YoloV8(nn.Module):
    """The network for a YoloV8Config; load weights with load_params,
    then set_compute_dtype."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.compute_dtype = torch.float32
        self.layers = nn.ModuleDict()
        for i, e in enumerate(config.layers):
            name = 'l{}'.format(i)
            if e['kind'] == 'conv':
                self.layers[name] = Conv(e['c_in'], e['c_out'], e['k'],
                                         e['s'])
            elif e['kind'] == 'c2f':
                self.layers[name] = C2f(e['c_in'], e['c_out'], e['n'],
                                        e['shortcut'])
            elif e['kind'] == 'sppf':
                self.layers[name] = SPPF(e['c_in'], e['c_out'],
                                         e['pool_k'])
            elif e['kind'] == 'detect':
                self.layers[name] = DetectV8(config, e['c_ins'])

    def load_params(self, params_np):
        """Load a float JAX-layout numpy pytree (HWIO 'w', 'b' nodes).
        int8 nodes are refused: the int8 chain is yolov5's only."""

        def int8_paths(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    yield from int8_paths(v, path + [k])
                elif k == 'w_q':
                    yield '/'.join(path)

        quantized = list(int8_paths(params_np, []))
        if quantized:
            raise ValueError('int8 nodes ({}...) in a {} checkpoint: the '
                             'int8 chain is the yolov5 family\'s only'.format(
                                 quantized[0], self.config.arch))
        return load_conv_params(self, params_np)

    def set_compute_dtype(self, dtype):
        """Compute in [dtype] (float32 or bf16; once, after load_params):
        bf16 casts every conv's weight and bias, as the JAX detector casts
        the 4-d leaves and the JAX _conv casts the bias at each use."""

        if dtype not in COMPUTE_DTYPES:
            raise ValueError('compute dtype must be one of {}, got {}'.format(
                COMPUTE_DTYPES, dtype))
        if self.compute_dtype != torch.float32:
            raise ValueError('set_compute_dtype: already {}'.format(
                self.compute_dtype))
        self.compute_dtype = dtype
        for m in self.modules():
            if type(m) is Conv:
                m.weight.data = m.weight.data.to(dtype)
                m.bias.data = m.bias.data.to(dtype)
        return self

    def forward(self, x, decode=True):
        """
        Args:
            x: [B, H, W, 3] uint8 pixels, or float images in [0, 1]; H and
                W multiples of 32
            decode: True -> decoded [B, A, 5+nc] float32 in canvas pixels;
                False -> list of raw NHWC (box [B, H_l, W_l, 4 * reg_max],
                cls [B, H_l, W_l, nc]) pairs in the compute dtype
        """

        config = self.config
        prev = network_input(x, self.compute_dtype).permute(0, 3, 1, 2)
        saved = {}
        heads = None
        for i, entry in enumerate(config.layers):
            kind = entry['kind']
            frm = entry['frm']
            if kind == 'cat':
                out = torch.cat([prev if f == -1 else saved[f] for f in frm],
                                dim=1)
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

        heads = [(box.permute(0, 2, 3, 1), cls.permute(0, 2, 3, 1))
                 for box, cls in heads]
        if not decode:
            return heads
        return torch.cat([
            decode_level_v8(box, cls, float(config.strides[lvl]),
                            config.reg_max)
            for lvl, (box, cls) in enumerate(heads)], dim=1)


#%% Conversion from ultralytics state dicts


def convert_ultralytics_state_dict(state_dict, config):
    """
    Map an ultralytics YOLOv8 torch state dict onto [config]'s layer
    structure (the JAX module's mapping): 'model.{i}.cv1.conv.weight',
    'model.{i}.m.{j}.cv1...', the detect head's box branch
    'model.22.cv2.{lvl}.{k}...' and class branch 'model.22.cv3.{lvl}.{k}...'
    (the fixed 'model.22.dfl.conv.weight' is the arange projection, not a
    parameter). BatchNorm is folded. Returns the numpy params pytree.
    """

    reader = _TorchKeyReader(state_dict)
    params = {}

    for i, entry in enumerate(config.layers):
        kind = entry['kind']
        name = 'l{}'.format(i)
        base = str(i)
        if kind == 'conv':
            params[name] = reader.conv(base)
        elif kind == 'c2f':
            node = {
                'cv1': reader.conv(base + '.cv1'),
                'cv2': reader.conv(base + '.cv2'),
            }
            for j in range(entry['n']):
                node['m{}'.format(j)] = {
                    'cv1': reader.conv('{}.m.{}.cv1'.format(base, j)),
                    'cv2': reader.conv('{}.m.{}.cv2'.format(base, j)),
                }
            params[name] = node
        elif kind == 'sppf':
            params[name] = {
                'cv1': reader.conv(base + '.cv1'),
                'cv2': reader.conv(base + '.cv2'),
            }
        elif kind == 'detect':
            heads = {}
            for lvl in range(len(entry['frm'])):
                heads['box{}'.format(lvl)] = {
                    'cv0': reader.conv('{}.cv2.{}.0'.format(base, lvl)),
                    'cv1': reader.conv('{}.cv2.{}.1'.format(base, lvl)),
                    'out': reader.plain_conv(
                        '{}.cv2.{}.2'.format(base, lvl)),
                }
                heads['cls{}'.format(lvl)] = {
                    'cv0': reader.conv('{}.cv3.{}.0'.format(base, lvl)),
                    'cv1': reader.conv('{}.cv3.{}.1'.format(base, lvl)),
                    'out': reader.plain_conv(
                        '{}.cv3.{}.2'.format(base, lvl)),
                }
            params[name] = heads

    return params
