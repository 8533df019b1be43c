"""
The int8 chain of the port's classifier against the JAX package on the
CPU: quantize_params_chain's structure, calibrated x / y / res scales
within 1e-3 relative, each chain conv's int32 sums identical and its int8
outputs within the chain's bar (1 lsb on at most 1e-4 of elements; the
epilogue without SiLU exact against JAX's chained_conv(act=False)), the
int8 network against JAX's, and the three faults of the JAX classifier,
each shown there and absent here:

- models/classifier.py:173, calibrate() on a calibrated classifier fails
  an assertion (the port recalibrates);
- ops/quantization.py:173, requalify_quantized re-wraps only nodes with a
  y_scale, so an int8 checkpoint saved before calibration crashes after
  auto-calibration (the port loads and calibrates it);
- models/classifier.py:267, auto-calibration takes its scales from the
  first batch, even one of 1-3 crops, and says nothing (the port keeps
  the default and prints the count).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megadetector_tpu.models import classifier as jclf
from megadetector_tpu.models import efficientnet as jeff
from megadetector_tpu.models.convert_weights import save_checkpoint
from megadetector_tpu.ops import quantization as jq
from megadetector_tpu_torch.models import classifier as tclf
from megadetector_tpu_torch.models import efficientnet as teff
from megadetector_tpu_torch.ops import conv_int8
from megadetector_tpu_torch.ops import quantization as tq

STAGES = [('fused', 1, 3, 1, 8, 2), ('fused', 2, 3, 2, 16, 2),
          ('mb', 2, 3, 2, 24, 3)]


def _configs():
    """A tiny config whose stages have residual blocks (the stock
    efficientnetv2_test's stages are single-layer), as the JAX package's
    int8 tests build it."""

    jc = jeff.EfficientNetConfig('efficientnetv2_test', num_classes=6,
                                 image_size=64)
    tc = teff.EfficientNetConfig('efficientnetv2_test', num_classes=6,
                                 image_size=64)
    jc.stages = tc.stages = list(STAGES)
    return jc, tc


def _sane_params(config, seed=0, scale=0.4):
    """He init explodes through the BN-free graph; conv weights scaled
    down, as the JAX package's tests do."""

    params = teff.init_params(config, seed=seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (v * np.float32(scale) if v.ndim == 4 else v)
                for k, v in node.items()}
    return walk(params)


def _images(n=4, seed=1):
    return np.random.RandomState(seed).uniform(
        0, 1, (n, 64, 64, 3)).astype(np.float32)


def _qnodes(params, path=()):
    if isinstance(params, dict):
        if 'w_q' in params:
            yield path, params
        else:
            for k in sorted(params):
                yield from _qnodes(params[k], path + (k,))


@pytest.fixture(scope='module')
def calibrated():
    """(jax config, port config, float params, JAX's calibrated tree,
    the port's calibrated tree, calibration images)."""

    jc, tc = _configs()
    params = _sane_params(tc)
    x = _images()
    jp = jeff.quantize_params_chain(params, jc)
    jq.calibrate_chain_scales(jeff.apply, jc, jp, x)
    tp = teff.quantize_params_chain(params, tc)
    tq.calibrate_chain_scales(tc, tp, x, device='cpu')
    return jc, tc, params, jq.requalify_quantized(jp), tp, x


def test_quantize_params_chain_structure_equals_jax():
    jc, tc = _configs()
    params = _sane_params(tc)
    jp = jeff.quantize_params_chain(params, jc)
    tp = teff.quantize_params_chain(params, tc)
    assert sorted(jp) == sorted(tp)
    jn, tn = list(_qnodes(jp)), list(_qnodes(tp))
    assert [p for p, _ in jn] == [p for p, _ in tn]
    # expand and project of every block of stages 1 and 2, and the head
    assert [p for p, _ in tn] == [('head',)] + [
        ('stage{}'.format(s), 'b{}'.format(b), slot)
        for s in (1, 2) for b in range(STAGES[s][5])
        for slot in ('expand', 'project')]
    for (_, a), (_, b) in zip(jn, tn):
        assert sorted(a) == sorted(b) == ['b', 'w_q', 'w_scale']
        for k in a:
            assert np.asarray(a[k]).dtype == b[k].dtype
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])
    # float nodes are shared, not copied
    assert tp['stage0'] is params['stage0'] and tp['stem'] is params['stem']
    assert tp['stage2']['b0']['dw'] is params['stage2']['b0']['dw']
    assert teff.params_are_chain_quantized(tp) and \
        not teff.params_are_chain_quantized(params)


def test_calibrated_scales_match_jax(calibrated):
    _, _, _, jp, tp, _ = calibrated
    n_res = 0
    for (path, a), (_, b) in zip(_qnodes(jp), _qnodes(tp)):
        keys = sorted(k for k in a if k in tq.SCALE_KEYS)
        assert keys == sorted(k for k in b if k in tq.SCALE_KEYS), path
        n_res += 'res_scale' in keys
        for k in keys:
            assert isinstance(b[k], float)
            assert abs(b[k] - a[k]) <= 1e-3 * abs(a[k]), (path, k)
    # the residual blocks of stages 1 and 2 each bake a res_scale
    assert n_res == 3


def _jax_qtensor(x):
    return jq.QTensor(jnp.asarray(x.q.numpy()), x.scale)


@pytest.mark.parametrize('act', [True, False])
def test_chain_convs_int32_sums_and_int8_outputs_as_jax(calibrated, act):
    """Every chain conv node of the kind [act] on a random int8 input at
    its producer's scale: int32 sums identical; int8 outputs within 1 lsb
    on at most 1e-4 of elements (measured: identical); the epilogue
    without SiLU exactly JAX's act=False."""

    _, _, _, jp, tp, _ = calibrated
    rng = np.random.RandomState(11)
    n_el = n_diff = 0
    for (path, jn), (_, tn) in zip(_qnodes(jp), _qnodes(tp)):
        if (path[-1] != 'project') != act:
            continue
        k, cin = tn['w_q'].shape[0], tn['w_q'].shape[2]
        stride = 2 if path[-1] == 'expand' and path[1] == 'b0' and \
            k == 3 else 1
        x = tq.QTensor(torch.from_numpy(rng.randint(
            -127, 128, (2, 16, 16, cin)).astype(np.int8)), 0.031)
        w = conv_int8.prepare_weight(tn['w_q'])
        pads = tq.conv_pads(None, k)
        acc = conv_int8.conv_int8(x.q, w, None, None, (stride, stride),
                                  pads)
        want_acc = jax.lax.conv_general_dilated(
            jnp.asarray(x.q.numpy()), jnp.asarray(jn['w_q']),
            (stride, stride), [(k // 2, k // 2)] * 2,
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
            preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
        # the same scales in both (each package calibrated its own)
        got = tq.chained_conv(x, w, torch.from_numpy(tn['w_scale']),
                              torch.from_numpy(tn['b']), jn['x_scale'],
                              jn['y_scale'], stride, pads, act=act)
        want = jq.chained_conv(jn, _jax_qtensor(x), stride, k // 2,
                               act=act)
        assert got.scale == want.scale
        d = np.abs(got.q.numpy().astype(np.int32) -
                   np.asarray(want.q).astype(np.int32))
        assert d.max() <= 1, path
        n_el += d.size
        n_diff += int((d > 0).sum())
        if not act:
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert n_el > 0 and n_diff <= 1e-4 * n_el


def test_plain_epilogue_without_silu_is_jax_s(calibrated):
    """conv_int8_reference(act=False) on int32 sums spread over the whole
    int8 range: identical to JAX's act=False epilogue."""

    rng = np.random.RandomState(3)
    acc = rng.randint(-40000, 40000, (4, 9, 9, 24)).astype(np.int32)
    scale = rng.uniform(1e-5, 1e-4, 24).astype(np.float32)
    bias = rng.uniform(-1, 1, 24).astype(np.float32)
    got = conv_int8.chain_epilogue_reference(
        torch.from_numpy(acc), torch.from_numpy(scale),
        torch.from_numpy(bias), 0.0213, act=False)
    y = jnp.asarray(acc).astype(jnp.float32) * jnp.asarray(scale) + \
        jnp.asarray(bias)
    want = jq.qt_quantize(y, 0.0213).q
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 200


def test_int8_network_matches_jax(calibrated):
    """The int8 network in bf16 (the classifier's int8 default) against
    JAX's on the calibration images: no further than JAX's int8 is from
    its float32; the QTensor dequantized into bf16 for the depthwise
    convs, the residual sums re-quantized at res_scale."""

    jc, tc, params, jp, tp, x = calibrated
    ref = np.asarray(jeff.apply(jc, jp, jnp.asarray(x), dtype=jnp.bfloat16))
    ref32 = np.asarray(jeff.apply(jc, params, jnp.asarray(x)))
    model = teff.EfficientNet(tc).load_params(tp).set_compute_dtype(
        torch.bfloat16).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref32 - ref).max()


def test_qt_dequant_in_bf16_as_jax():
    q = torch.from_numpy(np.arange(-127, 128, dtype=np.int8))
    for scale in (0.0123, 0.3, 1.7e-3):
        got = tq.qt_dequant(tq.QTensor(q, scale), torch.bfloat16)
        want = jq.qt_dequant(jq.QTensor(jnp.asarray(q.numpy()), scale),
                             jnp.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.fixture(scope='module')
def ckpts(tmp_path_factory):
    """A float checkpoint and, of the same weights, an int8 one saved
    before calibration."""

    _, tc = _configs()
    folder = tmp_path_factory.mktemp('int8_classifier')
    params = _sane_params(tc, seed=2)
    meta = {'arch': 'efficientnetv2_test', 'num_classes': 6,
            'image_size': 64}
    float_path = str(folder / 'float.npz')
    save_checkpoint(params, float_path, meta)
    q_path = str(folder / 'uncalibrated_int8.npz')
    save_checkpoint(teff.quantize_params_chain(params, tc), q_path, meta)
    return float_path, q_path


def _classifiers(path, options=None):
    options = dict(options or {}, quantize='int8')
    j = jclf.SpeciesClassifier(path, options)
    j.config.stages = list(STAGES)
    t = tclf.SpeciesClassifier(path, options, device='cpu')
    t.config.stages = list(STAGES)
    return j, t


def _crops(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)
            for _ in range(n)]


def test_auto_calibration_matches_jax(ckpts, capsys):
    j, t = _classifiers(ckpts[0])
    crops = _crops(0, 6)
    want = j.classify_batch(crops)
    got = t.classify_batch(crops)
    assert t.calibration_crops == 6
    for (path, a), (_, b) in zip(_qnodes(j.params), _qnodes(t.params)):
        for k in tq.SCALE_KEYS:
            assert (k in a) == (k in b)
            if k in a:
                assert abs(b[k] - float(a[k])) <= 1e-3 * abs(float(a[k]))
    own = np.abs(want - jclf.SpeciesClassifier(
        ckpts[0], {'folded_stem': 'off'}).classify_batch(crops)).max()
    assert np.abs(got - want).max() <= own
    assert (got.argmax(1) == want.argmax(1)).all()


def test_fault_calibrate_twice(ckpts):
    """JAX: calibrate() on a calibrated classifier fails an assertion
    (models/classifier.py:173). The port recalibrates: its scales are a
    fresh classifier's calibrated on the new crops."""

    j, t = _classifiers(ckpts[0])
    first, second = _crops(1, 4), _crops(2, 4)
    j.calibrate(first)
    with pytest.raises(AssertionError):
        j.calibrate(second)
    t.calibrate(first)
    t.calibrate(second)
    fresh = tclf.SpeciesClassifier(ckpts[0], {'quantize': 'int8'},
                                   device='cpu')
    fresh.config.stages = list(STAGES)
    fresh.calibrate(second)
    for (_, a), (_, b) in zip(_qnodes(t.params), _qnodes(fresh.params)):
        assert {k: a[k] for k in tq.SCALE_KEYS if k in a} == \
            {k: b[k] for k in tq.SCALE_KEYS if k in b}
    np.testing.assert_array_equal(t.classify_batch(first),
                                  fresh.classify_batch(first))


def test_fault_uncalibrated_int8_checkpoint(ckpts):
    """JAX: an int8 checkpoint saved before calibration loads as plain
    dicts (requalify_quantized wraps only nodes with a y_scale), and the
    chain crashes once auto-calibration has set traced scales
    (ops/quantization.py:173). The port classifies it as it classifies
    the float checkpoint quantized on load."""

    float_path, q_path = ckpts
    crops = _crops(3, 5)
    j, t = _classifiers(q_path)
    with pytest.raises(Exception):
        j.classify_batch(crops)
    _, from_float = _classifiers(float_path)
    np.testing.assert_array_equal(t.classify_batch(crops),
                                  from_float.classify_batch(crops))


def test_fault_first_batch_calibration_is_reported(ckpts, capsys):
    """JAX: auto-calibration takes its scales from the first batch, even
    of 2 crops, silently (models/classifier.py:267). The port keeps that
    default and prints the count; its scales are JAX's from the same 2
    crops."""

    j, t = _classifiers(ckpts[0])
    crops = _crops(4, 2)
    capsys.readouterr()
    j.classify_batch(crops)
    assert 'Calibrated' not in capsys.readouterr().out
    t.classify_batch(crops)
    assert 'Calibrated int8 scales on 2 crops' in capsys.readouterr().out
    assert t.calibration_crops == 2
    for (_, a), (_, b) in zip(_qnodes(j.params), _qnodes(t.params)):
        assert abs(b['y_scale'] - float(a['y_scale'])) <= \
            1e-3 * abs(float(a['y_scale']))


def test_calibrate_requires_int8(ckpts):
    t = tclf.SpeciesClassifier(ckpts[0], device='cpu')
    with pytest.raises(ValueError, match='int8'):
        t.calibrate(_crops(0, 1))
