"""
Port parity of the int8 activation chain's modules (ops/quantization.py,
ops/conv_int8.py, ops/bottleneck_int8.py, the unfolding in
models/convert_weights.py) against the JAX package, on the CPU, where the
kernels' wrappers run their plain versions.

Bars: weights, QTensor ops, int32 accumulators and unfolding are exact.
int8 conv outputs may differ by 1 lsb on at most 1e-4 of the elements:
torch's and XLA's float32 sigmoids differ by an ulp now and then, which
can move a value across a requant rounding boundary (ROADMAP section C).
The Pallas bottleneck allows its residual add 1 lsb on 5 % of elements
(FMA contraction, megadetector_tpu/ops/pallas_bottleneck.py); the port's
plain bottleneck IS the unfused chain.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu.ops import folding
from megadetector_tpu.ops import pallas_bottleneck, pallas_conv
from megadetector_tpu.ops import quantization as jq
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import (
    flatten_params, unfold_early_params)
from megadetector_tpu_torch.ops import conv_int8
from megadetector_tpu_torch.ops import quantization as q

INT8_FLIP_FRACTION = 1e-4


def _assert_int8_close(got, want, max_frac=INT8_FLIP_FRACTION):
    got = np.asarray(got, np.int32)
    want = np.asarray(want, np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1, diff.max()
    assert (diff != 0).mean() <= max_frac, (diff != 0).mean()


def _int8(rng, shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _conv_node(rng, k, c_in, c_out, y_scale=0.03):
    """A chain node, numpy leaves, with acc * scale at about unit std for
    inputs at scale ~0.007 (as the Pallas tests build theirs)."""

    w = rng.uniform(-0.4, 0.4, (k, k, c_in, c_out)).astype(np.float32)
    w_q, w_scale = jq.quantize_conv_weight(w)
    return {'w_q': w_q, 'w_scale': w_scale,
            'b': rng.uniform(-0.2, 0.2, (c_out,)).astype(np.float32),
            'x_scale': 0.011, 'y_scale': y_scale}


def _jax_node(node):
    return jq.QConvParams({k: jnp.asarray(v) if k in ('w_q', 'w_scale', 'b')
                           else v for k, v in node.items()})


def _port_args(node):
    return (conv_int8.prepare_weight(node['w_q']),
            torch.from_numpy(node['w_scale']), torch.from_numpy(node['b']))


def _port_chained(node, x, stride, pad):
    """The port's chained_conv on a numpy node; x a QTensor or NHWC
    float tensor."""

    w, w_scale, b = _port_args(node)
    return q.chained_conv(x, w, w_scale, b, node['x_scale'],
                          node['y_scale'], stride,
                          q.conv_pads(pad, node['w_q'].shape[0]))


#%% Weights and policy


def test_quantize_conv_weight_byte_identical():
    rng = np.random.RandomState(0)
    for shape in ((3, 3, 64, 128), (1, 1, 36, 20), (6, 6, 3, 16)):
        w = rng.standard_normal(shape).astype(np.float32)
        w[..., 0] = 0.0     # an all-zero channel hits the 1e-12 floor
        for got, want in zip(q.quantize_conv_weight(w),
                             jq.quantize_conv_weight(w)):
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize('float_store', [jq.DEFAULT_FLOAT_STORE_LAYERS,
                                         jq.DEFAULT_FLOAT_STORE_LAYERS_FOLDED])
def test_quantize_params_chain_byte_identical(float_store):
    cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
    params = yolov5.init_params(cfg, seed=0)
    detect = 'l{}'.format(len(cfg.layers) - 1)
    got = flatten_params(q.quantize_params_chain(
        params, skip_names=(detect,), float_store_names=float_store))
    want = flatten_params(jq.quantize_params_chain(
        params, skip_names=(detect,), float_store_names=float_store))
    assert sorted(got) == sorted(want)
    assert any(k.endswith('/w_q') for k in got)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


#%% QTensor ops


def _qt_pair(rng, shape, scale):
    a = _int8(rng, shape)
    return q.QTensor(torch.from_numpy(a), scale), \
        jq.QTensor(jnp.asarray(a), scale)


@pytest.mark.parametrize('op', ['dequant', 'quantize', 'requant', 'concat',
                                'add', 'maxpool', 'upsample'])
def test_qt_ops_match_jax(op):
    rng = np.random.RandomState(1)
    shape = (2, 9, 11, 12)
    pa, ja = _qt_pair(rng, shape, 0.0173)
    pb, jb = _qt_pair(rng, shape, 0.0291)
    if op == 'dequant':
        got, want = q.qt_dequant(pa), jq.qt_dequant(ja)
    elif op == 'quantize':
        x = (rng.standard_normal(shape) * 1.3).astype(np.float32)
        got = q.qt_quantize(torch.from_numpy(x), 0.0117)
        want = jq.qt_quantize(jnp.asarray(x), 0.0117)
    elif op == 'requant':
        got, want = q.qt_requant(pa, 0.0291), jq.qt_requant(ja, 0.0291)
    elif op == 'concat':
        got, want = q.qt_concat([pa, pb]), jq.qt_concat([ja, jb])
    elif op == 'add':
        got, want = q.qt_add(pa, pb), jq.qt_add(ja, jb)
    elif op == 'maxpool':
        got, want = q.qt_maxpool(pa, 5), jq.qt_maxpool(ja, 5)
    else:
        got, want = q.qt_upsample2x(pa), jq.qt_upsample2x(ja)
    if isinstance(want, jq.QTensor):
        assert got.scale == want.scale
        got, want = got.q, want.q
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


#%% The conv


def _jax_int32(xq, w_q, stride, pad):
    strides, pads = jax_yolov5.conv_geom(stride, pad, w_q.shape[0])
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(w_q), window_strides=strides,
        padding=pads, dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize('b,h,w,cin,cout,k,stride,pad', [
    # the Pallas conv tests' shapes (3x3 s1 SAME)
    (2, 16, 16, 128, 128, 3, 1, 1),
    (1, 24, 40, 128, 256, 3, 1, 1),
    (1, 10, 8, 256, 128, 3, 1, 1),
    # the other chain convs: 1x1, 3x3 s2, Cin not a multiple of 128, odd
    # widths, the folded-style asymmetric pads
    (2, 12, 20, 96, 64, 1, 1, 0),
    (2, 17, 23, 64, 96, 3, 2, 1),
    (1, 13, 21, 36, 72, 3, 1, 1),
    (1, 10, 11, 24, 40, 3, (2, 1), ((1, 1), (1, 0))),
])
def test_chain_conv_matches_jax(b, h, w, cin, cout, k, stride, pad):
    rng = np.random.RandomState(cin * 7 + cout)
    node = _conv_node(rng, k, cin, cout)
    xq = _int8(rng, (b, h, w, cin))

    # int32 accumulators: identical
    w_port = conv_int8.prepare_weight(node['w_q'])
    pads = q.conv_pads(pad, k)
    strides = (stride, stride) if isinstance(stride, int) else stride
    acc = conv_int8.conv_int8(torch.from_numpy(xq), w_port, None, None,
                              strides, pads)
    assert acc.dtype == torch.int32
    assert np.array_equal(acc.numpy(), _jax_int32(xq, node['w_q'], stride,
                                                  pad))

    # int8 chain output at the producer's scale
    got = _port_chained(node, q.QTensor(torch.from_numpy(xq), 0.007),
                        stride, pad)
    want = jq.chained_conv(_jax_node(node), jq.QTensor(jnp.asarray(xq),
                                                       0.007), stride, pad)
    assert got.scale == want.scale
    _assert_int8_close(got.q.numpy(), want.q)
    if k == 3 and stride == 1 and cin % 128 == 0:
        scale = node['w_scale'] * np.float32(0.007)
        pallas = pallas_conv.conv3x3_chain(
            jnp.asarray(xq), jnp.asarray(node['w_q']), scale, node['b'],
            node['y_scale'], interpret=True)
        _assert_int8_close(got.q.numpy(), pallas)

    # a float input (the chain entry) is quantized at the node's x_scale
    xf = (rng.standard_normal((b, h, w, cin)) * 0.4).astype(np.float32)
    got = _port_chained(node, torch.from_numpy(xf), stride, pad)
    want = jq.chained_conv(_jax_node(node), jnp.asarray(xf), stride, pad)
    _assert_int8_close(got.q.numpy(), want.q)


def test_quantized_conv_matches_jax():
    """The calibration forward's float-in / float-out int8 conv, at the
    dynamic abs-max input scale."""

    rng = np.random.RandomState(4)
    node = _conv_node(rng, 3, 32, 48)
    x = (rng.standard_normal((2, 9, 10, 32)) * 0.6).astype(np.float32)
    w, w_scale, b = _port_args(node)
    stats = {}
    got = q.quantized_conv(torch.from_numpy(x), w, w_scale, b, (1, 1),
                           (1, 1, 1, 1), stats=stats)
    params = {'w_q': jnp.asarray(node['w_q']),
              'w_scale': jnp.asarray(node['w_scale']),
              'b': jnp.asarray(node['b'])}
    want = np.asarray(jq.quantized_conv(params, jnp.asarray(x), 1, 1,
                                        accum_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert stats['in'] == float(np.abs(x).max())
    assert stats['out'] == pytest.approx(float(np.abs(want).max()),
                                         rel=1e-6)


#%% The bottleneck


def _bottleneck_nodes(rng, c):
    return _conv_node(rng, 1, c, c, 0.021), _conv_node(rng, 3, c, c, 0.033)


def _port_fused(cv1, cv2, x, shortcut):
    w1, s1, b1 = _port_args(cv1)
    w2, s2, b2 = _port_args(cv2)
    return q.fused_bottleneck(x, w1, s1, b1, cv1['y_scale'], w2, s2, b2,
                              cv2['y_scale'], shortcut)


@pytest.mark.parametrize('shortcut', [True, False])
@pytest.mark.parametrize('shape', [(2, 12, 16, 128), (1, 9, 8, 128),
                                   (1, 60, 8, 128), (1, 7, 13, 36)])
def test_fused_bottleneck_matches_jax(shape, shortcut):
    """Against the unfused JAX chain (at the sigmoid bar) and, where the
    Pallas kernel covers the shape, against bottleneck_chain in interpret
    mode: several row bands, so the zeroed h1 halo at the image's first
    and last rows and the real one between bands are both exercised."""

    rng = np.random.RandomState(shape[1] * 3 + shape[3])
    cv1, cv2 = _bottleneck_nodes(rng, shape[-1])
    xq = _int8(rng, shape)
    got = _port_fused(cv1, cv2, q.QTensor(torch.from_numpy(xq), 0.007),
                      shortcut)

    # the port's plain bottleneck is the unfused port chain, exactly
    x_port = q.QTensor(torch.from_numpy(xq), 0.007)
    h = _port_chained(cv2, _port_chained(cv1, x_port, 1, 0), 1, 1)
    unfused = q.qt_add(x_port, h) if shortcut else h
    assert got.scale == unfused.scale
    assert torch.equal(got.q, unfused.q)

    x_jax = jq.QTensor(jnp.asarray(xq), 0.007)
    h = jq.chained_conv(_jax_node(cv1), x_jax, 1, 0)
    h = jq.chained_conv(_jax_node(cv2), h, 1, 1)
    want = jq.qt_add(x_jax, h) if shortcut else h
    assert got.scale == want.scale
    _assert_int8_close(got.q.numpy(), want.q)

    if pallas_bottleneck.supports(shape, cv1['w_q'].shape,
                                  cv2['w_q'].shape):
        try:
            jq.set_conv_backend('pallas-interpret')
            pallas = jq.fused_bottleneck(
                {'cv1': _jax_node(cv1), 'cv2': _jax_node(cv2)}, x_jax,
                shortcut)
        finally:
            jq.set_conv_backend('xla')
        assert pallas.scale == got.scale
        _assert_int8_close(got.q.numpy(), pallas.q,
                           max_frac=0.05 if shortcut else INT8_FLIP_FRACTION)


#%% Unfolding


def _assert_trees_identical(got, want):
    got, want = flatten_params(got), flatten_params(want)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize('arch', ['yolov5n', 'yolov5s6'])
@pytest.mark.parametrize('h2', [False, True])
def test_unfold_inverts_fold_float(arch, h2):
    cfg = yolov5.YoloV5Config(arch, num_classes=3)
    params = yolov5.init_params(cfg, seed=1)
    folded = folding.fold_early_params(params, cfg, h2=h2)
    assert folding.params_are_folded(folded)
    _assert_trees_identical(unfold_early_params(folded, cfg), params)
    assert unfold_early_params(params, cfg) is params


def test_unfold_inverts_fold_quantized():
    """Folding then chain-quantizing (what the JAX quantize_checkpoint
    writes) and unfolding gives exactly the chain quantization of the
    unfolded weights; the merged cv12 node's scales go to both cv1 and
    cv2."""

    cfg = yolov5.YoloV5Config('yolov5s6', num_classes=3)
    params = yolov5.init_params(cfg, seed=2)
    detect = 'l{}'.format(len(cfg.layers) - 1)
    policy = dict(skip_names=(detect,),
                  float_store_names=jq.DEFAULT_FLOAT_STORE_LAYERS_FOLDED)
    folded_q = jq.quantize_params_chain(
        folding.fold_early_params(params, cfg), **policy)
    folded_q['l2']['cv12']['x_scale'] = 0.0123
    folded_q['l2']['cv12']['y_scale'] = 0.0456
    got = unfold_early_params(q.requalify_quantized(folded_q), cfg)
    for name in ('cv1', 'cv2'):
        assert got['l2'][name].pop('x_scale') == 0.0123
        assert got['l2'][name].pop('y_scale') == 0.0456
    _assert_trees_identical(got, q.quantize_params_chain(params, **policy))


#%% Calibration


def test_calibration_matches_jax():
    cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
    params = yolov5.init_params(cfg, seed=0)
    detect = 'l{}'.format(len(cfg.layers) - 1)
    samples = np.random.RandomState(1).uniform(
        0, 1, (2, 64, 96, 3)).astype(np.float32)
    port = q.calibrate_chain_scales(cfg, q.quantize_params_chain(
        params, skip_names=(detect,)), samples, device='cpu')
    ref = jq.calibrate_chain_scales(
        jax_yolov5.apply, jax_yolov5.YoloV5Config('yolov5n', num_classes=3),
        jq.quantize_params_chain(params, skip_names=(detect,)), samples)
    got = {k: v for k, v in flatten_params(port).items()
           if k.endswith('_scale') and not k.endswith('w_scale')}
    want = {k: float(v) for k, v in flatten_params(ref).items()
            if k.endswith('_scale') and not k.endswith('w_scale')}
    assert sorted(got) == sorted(want) and len(got) > 20
    for k in got:
        assert float(got[k]) == pytest.approx(want[k], rel=1e-3), k


def test_int8_forward_matches_jax():
    """The whole int8 forward (both routes through the bottlenecks)
    against the JAX apply on the same calibrated parameters: raw heads
    agree closely, the int8 flips of the sigmoid bar stay rare."""

    cfg = yolov5.YoloV5Config('yolov5s6', num_classes=3)
    detect = 'l{}'.format(len(cfg.layers) - 1)
    params_q = jq.quantize_params_chain(
        yolov5.init_params(cfg, seed=0), skip_names=(detect,),
        float_store_names=jq.DEFAULT_FLOAT_STORE_LAYERS_FOLDED)
    samples = np.random.RandomState(3).uniform(
        0, 1, (1, 128, 192, 3)).astype(np.float32)
    q.calibrate_chain_scales(cfg, params_q, samples, device='cpu')
    params_q = q.requalify_quantized(params_q)
    ref = jax_yolov5.apply(
        jax_yolov5.YoloV5Config('yolov5s6', num_classes=3),
        jq.requalify_quantized(params_q), jnp.asarray(samples),
        decode=False)
    for fuse in (False, True):
        model = yolov5.YoloV5(cfg, fuse_bottlenecks=fuse).load_params(
            params_q).eval()
        assert isinstance(model.layers['l1'], yolov5.QConv)
        assert isinstance(model.layers['l0'], yolov5.Conv)
        with torch.inference_mode():
            heads = model(torch.from_numpy(samples), decode=False)
        for got, want in zip(heads, ref):
            want = np.asarray(want)
            diff = np.abs(got.numpy() - want)
            scale = np.abs(want).max()
            assert np.percentile(diff, 99) <= 1e-3 * scale
            assert diff.max() <= 0.1 * scale
