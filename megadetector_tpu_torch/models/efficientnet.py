"""
EfficientNetV2 image classifier as a torch nn.Module (counterpart of
megadetector_tpu/models/efficientnet.py): the species-classifier backbone
of the two-stage detect -> crop -> classify path (SpeciesNet's always-crop
model is an EfficientNetV2-M).

The config tables and init_params are the JAX module's, line for line, so
both packages build the same architecture and draw the same random
parameters from a seed. The network is an inference graph with BatchNorm
folded into the weights: stem conv, FusedMBConv stages, MBConv stages with
squeeze-excitation, 1x1 head conv, global average pool and a linear
classifier. It takes NHWC float images (normalized by the caller) and
returns float32 logits.

Compute dtype (set_compute_dtype): float32 (TF32 off on a card, see
device.set_float32_exact), or bf16 rounded where the JAX apply(dtype=
bfloat16) rounds: each conv rounded to bf16, + b rounded, then SiLU with a
rounding after each op (ops/silu_bf16.py, the E7 kernel on a card, which
fuses the bias add); the SE squeeze and the head's pool sum in float32 and
round once; the SE gate x * sigmoid(s) rounds at each op; the fc multiplies
bf16 operands into float32 sums.

int8 chain (quantize_params_chain, then calibrate_chain_scales): the
expand / project / head convs of stages 1-6 take and give QTensors through
the int8 conv kernel (ops/conv_int8.py, B2; the project convs with its
epilogue without SiLU), the residual sum is re-quantized at its own
calibrated res_scale, and the stem, stage0, the depthwise and SE convs and
the fc stay float, computed in bf16 (the classifier's int8 default): a
QTensor feeding a float conv is dequantized in bf16.

fold_stem is a TPU lane trick and is not ported: a checkpoint with a
width-folded stem is unfolded on load (unfold_stem, its exact inverse).

Training (set_training): the float weights and the fc are nn.Parameters
(requires_grad off for inference), kept in float32 as the master copy and
cast to the training dtype inside each forward, so autograd carries the
gradient through the cast as jax.grad does through the JAX apply's
astype; in bf16 silu_bf16's backward is the E7 backward kernel on a card.
export_params gives them back as a JAX-layout numpy pytree.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from megadetector_tpu_torch.models.convert_weights import fuse_conv_bn
from megadetector_tpu_torch.models.params import num_params  # noqa: F401
from megadetector_tpu_torch.models.yolov5 import _float_nchw
from megadetector_tpu_torch.ops import quantization as q
from megadetector_tpu_torch.ops.quantization import QTensor
from megadetector_tpu_torch.ops.silu_bf16 import (sigmoid_bf16_reference,
                                                  silu_bf16)

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


#%% Architecture configs (same tables as the JAX module)
#
# Stage spec: (block, expansion, kernel, stride, channels, layers)
# block: 'fused' = FusedMBConv (no SE), 'mb' = MBConv (SE ratio 0.25)

EFFICIENTNET_V2_CONFIGS = {
    'efficientnetv2_s': {
        'stem_channels': 24,
        'stages': [
            ('fused', 1, 3, 1, 24, 2),
            ('fused', 4, 3, 2, 48, 4),
            ('fused', 4, 3, 2, 64, 4),
            ('mb', 4, 3, 2, 128, 6),
            ('mb', 6, 3, 1, 160, 9),
            ('mb', 6, 3, 2, 256, 15),
        ],
        'head_channels': 1280,
    },
    # Tiny test-only variant: exercises both block types + SE cheaply
    'efficientnetv2_test': {
        'stem_channels': 8,
        'stages': [
            ('fused', 1, 3, 1, 8, 1),
            ('fused', 2, 3, 2, 16, 1),
            ('mb', 2, 3, 2, 24, 1),
        ],
        'head_channels': 64,
    },
    'efficientnetv2_m': {
        'stem_channels': 24,
        'stages': [
            ('fused', 1, 3, 1, 24, 3),
            ('fused', 4, 3, 2, 48, 5),
            ('fused', 4, 3, 2, 80, 5),
            ('mb', 4, 3, 2, 160, 7),
            ('mb', 6, 3, 1, 176, 14),
            ('mb', 6, 3, 2, 304, 18),
            ('mb', 6, 3, 1, 512, 5),
        ],
        'head_channels': 1280,
    },
}


class EfficientNetConfig:
    """Resolved EfficientNetV2 architecture."""

    def __init__(self, arch='efficientnetv2_m', num_classes=1000,
                 image_size=480):
        assert arch in EFFICIENTNET_V2_CONFIGS, \
            'Unknown arch {}'.format(arch)
        self.arch = arch
        self.num_classes = num_classes
        self.image_size = image_size
        cfg = EFFICIENTNET_V2_CONFIGS[arch]
        self.stem_channels = cfg['stem_channels']
        self.stages = cfg['stages']
        self.head_channels = cfg['head_channels']


def blocks(config):
    """Every block of [config] in forward order: (stage name, block name,
    kind, expansion, kernel, stride, c_in, c_out, use_residual)."""

    out = []
    c_in = config.stem_channels
    for i_stage, (block, expansion, k, stride, c_out, layers) in \
            enumerate(config.stages):
        for i_layer in range(layers):
            s = stride if i_layer == 0 else 1
            out.append(('stage{}'.format(i_stage), 'b{}'.format(i_layer),
                        block, expansion, k, s, c_in, c_out,
                        s == 1 and c_in == c_out))
            c_in = c_out
    return out


#%% Initialization (numpy RNG; same draws as the JAX module)


def _conv_slot(rng, c_in, c_out, k, groups=1):
    fan_in = (c_in // groups) * k * k
    std = math.sqrt(2.0 / fan_in)
    w = rng.standard_normal((k, k, c_in // groups, c_out)) \
        .astype(np.float32) * std
    return {'w': w, 'b': np.zeros((c_out,), np.float32)}


def init_params(config, seed=0, train_init=False):
    """
    Random parameters; structure mirrors the network. [train_init]
    zero-initializes each residual block's projection and the classifier
    head, as the JAX module does for from-scratch training.
    """

    rng = np.random.RandomState(seed)
    params = {'stem': _conv_slot(rng, 3, config.stem_channels, 3)}

    c_in = config.stem_channels
    for i_stage, (block, expansion, k, stride, c_out, layers) in \
            enumerate(config.stages):
        stage_params = []
        for i_layer in range(layers):
            s = stride if i_layer == 0 else 1
            use_residual = (s == 1 and c_in == c_out)
            block_params = {}
            c_exp = c_in * expansion
            if block == 'fused':
                if expansion == 1:
                    block_params['project'] = _conv_slot(rng, c_in, c_out, k)
                else:
                    block_params['expand'] = _conv_slot(rng, c_in, c_exp, k)
                    block_params['project'] = _conv_slot(rng, c_exp, c_out, 1)
            else:  # mbconv
                block_params['expand'] = _conv_slot(rng, c_in, c_exp, 1)
                block_params['dw'] = _conv_slot(rng, c_exp, c_exp, k,
                                                groups=c_exp)
                c_se = max(1, c_in // 4)
                block_params['se_reduce'] = _conv_slot(rng, c_exp, c_se, 1)
                block_params['se_expand'] = _conv_slot(rng, c_se, c_exp, 1)
                block_params['project'] = _conv_slot(rng, c_exp, c_out, 1)
            if train_init and use_residual:
                block_params['project']['w'] = \
                    np.zeros_like(block_params['project']['w'])
            elif train_init:
                block_params['project']['w'] *= 0.5
            stage_params.append(block_params)
            c_in = c_out
        params['stage{}'.format(i_stage)] = {
            'b{}'.format(j): bp for j, bp in enumerate(stage_params)}

    params['head'] = _conv_slot(rng, c_in, config.head_channels, 1)
    std = 1.0 / math.sqrt(config.head_channels)
    params['fc'] = {
        'w': np.zeros((config.head_channels, config.num_classes),
                      np.float32) if train_init else
        rng.uniform(-std, std, (config.head_channels,
                                config.num_classes)).astype(np.float32),
        'b': np.zeros((config.num_classes,), np.float32),
    }
    return params


#%% Stem folding (the JAX package's TPU layout, undone on load)


def stem_is_folded(params):
    w = params['stem']['w']
    return w.shape[0] == 3 and w.shape[1] == 2


def unfold_stem(params):
    """
    The exact inverse of the JAX fold_stem: a copy of [params] whose stem
    is the [3, 3, 3, C] conv again (w2: [3, 2, 6, C]; w4: [3, 2, 12, 2C],
    whose second output phase repeats the first's taps). Every original
    tap sits in the folded kernel once, so the weights come back bit for
    bit; a folded kernel that is not a fold_stem output raises.
    """

    wf = np.asarray(params['stem']['w'], np.float32)
    bf = np.asarray(params['stem']['b'], np.float32)
    if wf.shape[:2] != (3, 2) or wf.shape[2] not in (6, 12):
        raise ValueError('unfold_stem expects a w2 [3,2,6,C] or w4 '
                         '[3,2,12,2C] stem, got {}'.format(wf.shape))
    w4 = wf.shape[2] == 12
    c_out = wf.shape[3] // 2 if w4 else wf.shape[3]
    wo = wf[..., :c_out]
    # The folded column (kx, channels) of each original tap column
    taps = ((0, slice(9, 12)), (1, slice(0, 3)), (1, slice(3, 6))) if w4 \
        else ((0, slice(3, 6)), (1, slice(0, 3)), (1, slice(3, 6)))
    w = np.stack([wo[:, kx, ch, :] for kx, ch in taps], axis=1)
    b = bf[:c_out]
    expected = np.zeros_like(wf)
    for (kx, ch), tap in zip(taps, range(3)):
        expected[:, kx, ch, :c_out] = w[:, tap]
    if w4:
        for tap, ch in enumerate((slice(3, 6), slice(6, 9), slice(9, 12))):
            expected[:, 1, ch, c_out:] = w[:, tap]
    if not np.array_equal(expected, wf) or (
            w4 and not np.array_equal(bf[c_out:], b)):
        raise ValueError('stem kernel of shape {} is not a fold_stem '
                         'output'.format(wf.shape))
    out = dict(params)
    out['stem'] = {'w': np.ascontiguousarray(w), 'b': b.copy()}
    return out


#%% int8 chain quantization


def quantize_params_chain(params, config, float_stages=('stage0',)):
    """
    Quantize an EfficientNetV2 parameter tree for the int8 chain: expand /
    project / head conv nodes get int8 weights (per-output-channel
    symmetric, ops/quantization.quantize_conv_weight) as {'w_q',
    'w_scale', 'b'}; activation scales (x_scale / y_scale / res_scale) come
    from ops/quantization.calibrate_chain_scales. [float_stages] stay
    entirely float (default: the low-channel, high-resolution stage0); the
    stem, depthwise, SE convs and the fc stay float everywhere. Returns a
    new tree sharing the float nodes.
    """

    def quantize_node(node):
        w_q, scale = q.quantize_conv_weight(np.asarray(node['w']))
        return {'w_q': w_q, 'w_scale': scale,
                'b': np.asarray(node['b'], np.float32)}

    out = {'stem': params['stem']}
    for i_stage in range(len(config.stages)):
        name = 'stage{}'.format(i_stage)
        if name in (float_stages or ()):
            out[name] = params[name]
            continue
        out[name] = {
            key: {slot: quantize_node(node) if slot in ('expand', 'project')
                  else node for slot, node in bp.items()}
            for key, bp in params[name].items()}
    out['head'] = quantize_node(params['head'])
    out['fc'] = params['fc']
    return out


def params_are_chain_quantized(params):
    """True when the tree carries int8 chain conv nodes."""

    if not isinstance(params, dict):
        return False
    if 'w_q' in params:
        return True
    return any(params_are_chain_quantized(v) for v in params.values())


def strip_scales(params):
    """A copy of [params] without static scales (x_scale, y_scale,
    res_scale): the tree calibrate_chain_scales fills."""

    if not isinstance(params, dict):
        return params
    return {k: strip_scales(v) for k, v in params.items()
            if k not in q.SCALE_KEYS}


#%% Conversion from torchvision checkpoints


def convert_torchvision_state_dict(state_dict, config):
    """
    Convert a torchvision efficientnet_v2_* state dict to this module's
    parameter tree by ordered consumption: torchvision enumerates conv/BN
    pairs in exactly the construction order used here, so each BN folds
    into its conv and the slots fill in order. The final linear layer maps
    to 'fc'.
    """

    # Ordered (conv_weight, bn or bias) pairs from the state dict
    keys = list(state_dict.keys())
    conv_entries = []
    i = 0
    fc_w = None
    fc_b = None
    while i < len(keys):
        k = keys[i]
        if k.endswith('.weight') and state_dict[k].ndim == 4:
            conv_w = state_dict[k]
            # Look ahead for BN (weight/bias/mean/var) on the same block
            if i + 4 < len(keys) and keys[i + 1].endswith('.weight') and \
                    state_dict[keys[i + 1]].ndim == 1 and \
                    'running_mean' in keys[i + 3]:
                bn_w = state_dict[keys[i + 1]]
                bn_b = state_dict[keys[i + 2]]
                bn_m = state_dict[keys[i + 3]]
                bn_v = state_dict[keys[i + 4]]
                w, b = fuse_conv_bn(np.asarray(conv_w, np.float64),
                                    np.asarray(bn_w, np.float64),
                                    np.asarray(bn_b, np.float64),
                                    np.asarray(bn_m, np.float64),
                                    np.asarray(bn_v, np.float64),
                                    eps=1e-3)
                conv_entries.append((w.astype(np.float32),
                                     b.astype(np.float32)))
                i += 5
                if i < len(keys) and 'num_batches_tracked' in keys[i]:
                    i += 1
                continue
            # Conv with plain bias (SE layers)
            if i + 1 < len(keys) and keys[i + 1].endswith('.bias'):
                conv_entries.append(
                    (np.asarray(conv_w, np.float32),
                     np.asarray(state_dict[keys[i + 1]], np.float32)))
                i += 2
                continue
            conv_entries.append(
                (np.asarray(conv_w, np.float32),
                 np.zeros(conv_w.shape[0], np.float32)))
            i += 1
        elif k.endswith('.weight') and state_dict[k].ndim == 2:
            fc_w = np.asarray(state_dict[k], np.float32)
            if i + 1 < len(keys) and keys[i + 1].endswith('.bias'):
                fc_b = np.asarray(state_dict[keys[i + 1]], np.float32)
                i += 2
            else:
                fc_b = np.zeros(fc_w.shape[0], np.float32)
                i += 1
        else:
            i += 1

    assert fc_w is not None, 'No linear classifier found in state dict'

    entries = iter(conv_entries)

    def next_conv():
        # OIHW -> HWIO (a depthwise [C, 1, k, k] becomes [k, k, 1, C])
        w, b = next(entries)
        return {'w': np.transpose(w, (2, 3, 1, 0)), 'b': b}

    params = {'stem': next_conv()}
    for i_stage, (block, expansion, k, stride, c_out, layers) in \
            enumerate(config.stages):
        stage_params = {}
        for i_layer in range(layers):
            bp = {}
            if block == 'fused':
                if expansion == 1:
                    bp['project'] = next_conv()
                else:
                    bp['expand'] = next_conv()
                    bp['project'] = next_conv()
            else:
                bp['expand'] = next_conv()
                bp['dw'] = next_conv()
                bp['se_reduce'] = next_conv()
                bp['se_expand'] = next_conv()
                bp['project'] = next_conv()
            stage_params['b{}'.format(i_layer)] = bp
        params['stage{}'.format(i_stage)] = stage_params

    params['head'] = next_conv()
    remaining = sum(1 for _ in entries)
    assert remaining == 0, \
        '{} unconsumed conv tensors in state dict'.format(remaining)

    params['fc'] = {'w': fc_w.T.copy(), 'b': fc_b}
    return params


#%% Geometry and launch counts


def chain_conv_shapes(config, image_size, batch=1,
                      float_stages=('stage0',)):
    """
    The geometry of every int8 chain conv of [config] (quantized with
    [float_stages] float) on a [batch, image_size, image_size] input, in
    forward order: dicts with name (the parameter path), batch, h, w
    (input), cin, cout, k, stride, pads (top, bottom, left, right), ho,
    wo and act (False for the project convs).
    """

    def out_side(side, k, s):
        return (side + 2 * (k // 2) - k) // s + 1

    side = out_side(image_size, 3, 2)   # the stem
    shapes = []

    def add(name, cin, cout, k, s, act):
        nonlocal side
        ho = out_side(side, k, s)
        shapes.append({'name': name, 'batch': batch, 'h': side, 'w': side,
                       'cin': cin, 'cout': cout, 'k': k, 'stride': s,
                       'pads': (k // 2,) * 4, 'ho': ho, 'wo': ho,
                       'act': act})

    for stage, blk, kind, expansion, k, s, c_in, c_out, _ in blocks(config):
        name = '{}.{}'.format(stage, blk)
        quantized = stage not in (float_stages or ())
        c_exp = c_in * expansion
        if kind == 'fused':
            if expansion == 1:
                side = out_side(side, k, s)
                continue
            if quantized:
                add(name + '.expand', c_in, c_exp, k, s, True)
            side = out_side(side, k, s)
            if quantized:
                add(name + '.project', c_exp, c_out, 1, 1, False)
        else:
            if quantized:
                add(name + '.expand', c_in, c_exp, 1, 1, True)
            side = out_side(side, k, s)
            if quantized:
                add(name + '.project', c_exp, c_out, 1, 1, False)
    add('head', config.stages[-1][4], config.head_channels, 1, 1, True)
    return shapes


def forward_launches(config, quantized, compute_dtype,
                     float_stages=('stage0',)):
    """(int8 conv kernel launches, bf16 bias + SiLU launches) of one
    forward: every chain conv launches B2 once when [quantized]; every
    float conv with SiLU (stem, stage0 and fused expands, MBConv expands,
    depthwise and SE reduce convs, head) launches E7 once in bf16."""

    n_chain = len(chain_conv_shapes(config, 64, 1, float_stages)) \
        if quantized else 0
    if compute_dtype != torch.bfloat16:
        return n_chain, 0
    n_silu = 2   # stem and head
    for stage, _, kind, expansion, _, _, _, _, _ in blocks(config):
        float_stage = not quantized or stage in (float_stages or ())
        if kind == 'fused':
            # expansion 1: the project conv has SiLU; else the expand does
            n_silu += int(float_stage)
        else:
            # expand (when float), depthwise, SE reduce
            n_silu += int(float_stage) + 2
    if quantized:
        n_silu -= 1   # the head is int8
    return n_chain, n_silu


def activated_conv_shapes(config, image_size, batch=1):
    """
    The output shapes [batch, C, H, W] of every float conv with SiLU of
    [config]'s network on a [batch, image_size, image_size] input, in
    forward order (the tensors the bf16 epilogue and its backward take in
    a bf16 float forward), from a forward on the meta device (no weights,
    no arithmetic).
    """

    params = init_params(config)
    model = EfficientNet(config).load_params(params).to('meta')
    shapes = []

    def record(module, inputs, output):
        shapes.append(tuple(output.shape))

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, FloatConv) and m.act]
    try:
        with torch.inference_mode():
            model(torch.zeros((batch, image_size, image_size, 3),
                              device='meta'))
    finally:
        for hook in hooks:
            hook.remove()
    return shapes


#%% The network


def _nhwc(x):
    """Float NCHW view -> NHWC view (free for channels_last data)."""

    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class FloatConv(nn.Module):
    """A float conv node: conv + bias (+ SiLU) over NCHW (channels_last
    data), the weight OIHW, in the compute dtype; a QTensor input is
    dequantized into it (the JAX qt_dequant: in bf16, bf16(q) *
    bf16(scale))."""

    def __init__(self, node, stride=1, groups=1, act=True):
        super().__init__()
        w = np.asarray(node['w'], np.float32)
        self.weight = nn.Parameter(torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
            requires_grad=False)
        self.bias = nn.Parameter(torch.from_numpy(
            np.asarray(node['b'], np.float32).copy()), requires_grad=False)
        self.stride = stride
        self.padding = w.shape[0] // 2
        self.groups = groups
        self.act = act

    def forward(self, x, dtype):
        x = _float_nchw(x, dtype)
        # a no-op in inference (set_compute_dtype cast them); training
        # casts the float32 parameters here
        w, b = self.weight.to(dtype), self.bias.to(dtype)
        if dtype == torch.bfloat16:
            # The JAX rounding points: the conv rounds to bf16, + b rounds,
            # then the activation (silu_bf16 adds the bias itself)
            y = F.conv2d(x, w, None, self.stride, self.padding, 1,
                         self.groups)
            return silu_bf16(y, b) if self.act else y + b.view(1, -1, 1, 1)
        y = F.conv2d(x, w, b, self.stride, self.padding, 1, self.groups)
        return y * torch.sigmoid(y) if self.act else y


class ChainConv(nn.Module):
    """
    An int8 conv node of the chain: int8 weight [Cout, kh, kw, Cin],
    float32 w_scale and bias buffers, Python-float x_scale / y_scale /
    res_scale. Calibrated, it returns a QTensor at y_scale
    (quantization.chained_conv, with or without SiLU); uncalibrated, it is
    the calibration forward's float-in / float-out quantized_conv, which
    records its input and output abs-max in [stats] when that is a dict.
    """

    def __init__(self, node, stride=1, act=True):
        super().__init__()
        w_q = np.asarray(node['w_q'])
        if w_q.dtype != np.int8:
            raise ValueError('w_q has dtype {}, expected int8'.format(
                w_q.dtype))
        if ('x_scale' in node) != ('y_scale' in node):
            raise ValueError('int8 conv node with only some of x_scale '
                             'and y_scale')
        self.register_buffer('weight', torch.from_numpy(
            np.ascontiguousarray(w_q.transpose(3, 0, 1, 2))))
        self.register_buffer('w_scale', torch.from_numpy(
            np.asarray(node['w_scale'], np.float32).copy()))
        self.register_buffer('bias', torch.from_numpy(
            np.asarray(node['b'], np.float32).copy()))
        self.x_scale = None if 'x_scale' not in node else \
            float(node['x_scale'])
        self.y_scale = None if 'y_scale' not in node else \
            float(node['y_scale'])
        self.res_scale = None if 'res_scale' not in node else \
            float(node['res_scale'])
        self.stride = stride
        self.pads = q.conv_pads(None, w_q.shape[0])
        self.act = act
        self.stats = None

    def forward(self, x, dtype):
        if self.y_scale is not None:
            if not isinstance(x, QTensor):
                x = _nhwc(x)
            return q.chained_conv(x, self.weight, self.w_scale, self.bias,
                                  self.x_scale, self.y_scale, self.stride,
                                  self.pads, act=self.act)
        if isinstance(x, QTensor):
            x = q.qt_dequant(x, dtype)
        else:
            x = _nhwc(x)
        y = q.quantized_conv(x, self.weight, self.w_scale, self.bias,
                             self.stride, self.pads, self.stats,
                             act=self.act, dtype=dtype)
        return _nchw(y)


def _node(node, stride=1, groups=1, act=True):
    if 'w_q' in node:
        if groups != 1:
            raise ValueError('depthwise convs are never quantized')
        return ChainConv(node, stride, act)
    return FloatConv(node, stride, groups, act)


class Block(nn.Module):
    """A FusedMBConv or MBConv block; submodules are named as the
    parameter tree's slots."""

    def __init__(self, bp, kind, expansion, stride, use_residual):
        super().__init__()
        self.kind = kind
        self.use_residual = use_residual
        if kind == 'fused':
            if expansion == 1:
                self.project = _node(bp['project'], stride)
            else:
                self.expand = _node(bp['expand'], stride)
                self.project = _node(bp['project'], act=False)
        else:
            self.expand = _node(bp['expand'])
            c_exp = np.shape(bp['dw']['w'])[-1]
            self.dw = _node(bp['dw'], stride, groups=c_exp)
            self.se_reduce = _node(bp['se_reduce'])
            self.se_expand = _node(bp['se_expand'], act=False)
            self.project = _node(bp['project'], act=False)

    def forward(self, x, dtype):
        shortcut = x
        if hasattr(self, 'expand'):
            y = self.expand(x, dtype)
        else:
            y = x
        if self.kind == 'mb':
            y = self.dw(y, dtype)
            y = self._se(y, dtype)
        y = self.project(y, dtype)
        if self.use_residual:
            y = self._residual_add(y, shortcut, dtype)
        return y

    def _se(self, x, dtype):
        """Squeeze-and-excitation over NCHW: the mean sums in float32 and
        rounds once to [x]'s dtype (jnp.mean's upcast)."""

        s = torch.mean(x, (2, 3), keepdim=True, dtype=torch.float32).to(
            x.dtype)
        s = self.se_reduce(s, dtype)
        s = self.se_expand(s, dtype)
        if x.dtype == torch.bfloat16:
            return x * sigmoid_bf16_reference(s)
        return x * torch.sigmoid(s)

    def _residual_add(self, y, shortcut, dtype):
        """
        The residual add, int8-chain-aware. With a QTensor on either side
        the sum is float32 (both dequantized) and re-quantized at the
        project node's calibrated res_scale, or cast to the compute dtype
        where the node has none. Float sums stay in their dtype; during
        calibration the sum's abs-max is recorded under 'res' in the
        project node's stats.
        """

        project = self.project
        if isinstance(y, QTensor) or isinstance(shortcut, QTensor):
            s = _float_nhwc(y) + _float_nhwc(shortcut)
            if getattr(project, 'res_scale', None) is not None:
                return q.qt_quantize(s, project.res_scale)
            return _nchw(s.to(dtype))
        s = y + shortcut
        if getattr(project, 'stats', None) is not None:
            project.stats['res'] = max(project.stats.get('res', 0.0),
                                       float(s.float().abs().max()))
        return s


def _float_nhwc(x):
    """QTensor or float NCHW view -> float32 NHWC."""

    if isinstance(x, QTensor):
        return q.qt_dequant(x)
    return _nhwc(x).to(torch.float32)


class EfficientNet(nn.Module):
    """
    The network for an EfficientNetConfig: load_params (a JAX-layout
    numpy tree, float or int8 chain), then set_compute_dtype, then
    forward(x) on NHWC float images -> [B, num_classes] float32 logits.
    Submodules sit at the parameter tree's paths under layers (stem,
    stage<i>.b<j>.<slot>, head), which calibrate_chain_scales relies on.
    """

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.compute_dtype = torch.float32
        # set_training's dtype; None: inference
        self.train_dtype = None
        self.layers = nn.ModuleDict()
        self.register_parameter('fc_w', None)
        self.register_parameter('fc_b', None)

    def load_params(self, params_np):
        """Build the conv nodes from [params_np] (a folded stem is
        unfolded first). Returns self."""

        if stem_is_folded(params_np):
            params_np = unfold_stem(params_np)
        config = self.config
        self.layers['stem'] = _node(params_np['stem'], stride=2)
        for stage, blk, kind, expansion, _, s, _, _, residual in \
                blocks(config):
            if stage not in self.layers:
                self.layers[stage] = nn.ModuleDict()
            self.layers[stage][blk] = Block(params_np[stage][blk], kind,
                                            expansion, s, residual)
        self.layers['head'] = _node(params_np['head'])
        self.fc_w = nn.Parameter(torch.from_numpy(
            np.asarray(params_np['fc']['w'], np.float32).copy()),
            requires_grad=False)
        self.fc_b = nn.Parameter(torch.from_numpy(
            np.asarray(params_np['fc']['b'], np.float32).copy()),
            requires_grad=False)
        return self

    def set_compute_dtype(self, dtype):
        """
        Compute in [dtype] (float32 or bf16; call once, after
        load_params): bf16 casts every float conv's weight and bias and
        the fc to bf16 (the JAX classifier casts its float leaves to the
        compute dtype); int8 nodes are unchanged.
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
        for p in self.parameters():
            p.data = p.data.to(dtype)
        return self

    def set_training(self, dtype):
        """
        Training mode in [dtype] (float32 or bf16), or back to inference
        with None: the float parameters (convs and fc, float32: no
        set_compute_dtype to bf16 before) require grad and are cast to
        [dtype] in each forward. int8 nodes do not train. Returns self.
        """

        if dtype is not None and dtype not in COMPUTE_DTYPES:
            raise ValueError('training dtype must be one of {} or None, got '
                             '{}'.format(COMPUTE_DTYPES, dtype))
        if self.compute_dtype != torch.float32:
            raise ValueError('set_training needs the float32 weights; this '
                             'model computes in {}'.format(self.compute_dtype))
        if any(isinstance(m, ChainConv) for m in self.modules()):
            raise ValueError('int8 convs do not train')
        self.train_dtype = dtype
        self.requires_grad_(dtype is not None)
        return self

    def export_params(self):
        """The float parameters as a JAX-layout numpy pytree (HWIO conv
        'w', 'b'; fc 'w' [head, classes], 'b'; float32)."""

        def arr(t):
            return t.detach().float().cpu().numpy().copy()

        params = {}
        for name, m in self.layers.named_modules():
            if isinstance(m, ChainConv):
                raise ValueError('{}: int8 convs are not exported'.format(
                    name))
            if not isinstance(m, FloatConv):
                continue
            node = params
            for key in name.split('.'):
                node = node.setdefault(key, {})
            node['w'] = arr(m.weight.permute(2, 3, 1, 0))
            node['b'] = arr(m.bias)
        params['fc'] = {'w': arr(self.fc_w), 'b': arr(self.fc_b)}
        return params

    def forward(self, x):
        """x: [B, H, W, 3] float images (normalized by the caller) ->
        [B, num_classes] float32 logits."""

        dtype = self.train_dtype or self.compute_dtype
        x = _nchw(x.to(dtype))
        x = self.layers['stem'](x, dtype)
        for stage, blk, *_ in blocks(self.config):
            x = self.layers[stage][blk](x, dtype)
        x = self.layers['head'](x, dtype)
        if isinstance(x, QTensor):
            x = q.qt_dequant(x).mean((1, 2))
        else:
            x = torch.mean(x, (2, 3), dtype=torch.float32).to(x.dtype)
        # bf16 operands multiply exactly into float32 sums
        return x.float() @ self.fc_w.to(dtype).float() + \
            self.fc_b.to(dtype).float()
