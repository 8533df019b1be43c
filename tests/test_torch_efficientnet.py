"""
The port's EfficientNetV2 (megadetector_tpu_torch/models/efficientnet.py)
against the JAX package's models/efficientnet.py on the CPU: the config
tables and init_params bit-identical, the float32 forward within rtol
1e-4, bf16 rounded in JAX's dtype at every conv, gate and block and no
further from JAX's bf16 than that is from JAX's float32, the unfold of a
width-folded stem exact, convert_torchvision_state_dict bit-identical,
the parameter counts, and the launch counts and chain-conv geometry the
card's run asserts.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megadetector_tpu.models import efficientnet as jeff
from megadetector_tpu_torch.models import efficientnet as teff

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _configs(arch, num_classes=5):
    return (jeff.EfficientNetConfig(arch, num_classes=num_classes),
            teff.EfficientNetConfig(arch, num_classes=num_classes))


def _images(side, n=2, seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, side, side, 3)).astype(np.float32)


def _sane_params(arch, seed, num_classes=5):
    """Well-conditioned parameters: the torchvision-layout reference's
    weights with its BatchNorm folded in. He init without BatchNorm
    explodes through efficientnetv2_s (logits ~1e4 at 64 px), where float
    rounding differences are amplified to O(1) by the depth."""

    from torch_effnet_ref import make_torch_effnet

    model = make_torch_effnet(arch, num_classes=num_classes, seed=seed)
    return teff.convert_torchvision_state_dict(
        model.state_dict(), teff.EfficientNetConfig(arch, num_classes))


def _port(config, params, dtype=torch.float32):
    return teff.EfficientNet(config).load_params(params) \
        .set_compute_dtype(dtype).eval()


def _run(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def _leaves(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_config_tables_equal_the_jax_module():
    assert teff.EFFICIENTNET_V2_CONFIGS == jeff.EFFICIENTNET_V2_CONFIGS
    for arch in jeff.EFFICIENTNET_V2_CONFIGS:
        jc, tc = _configs(arch, 11)
        assert vars(tc) == vars(jc)
    with pytest.raises(AssertionError):
        teff.EfficientNetConfig('efficientnetv2_xl')


@pytest.mark.parametrize('arch,train_init', [
    ('efficientnetv2_test', False), ('efficientnetv2_test', True),
    ('efficientnetv2_s', False)])
def test_init_params_bit_identical(arch, train_init):
    jc, tc = _configs(arch)
    jp = jeff.init_params(jc, seed=4, train_init=train_init)
    tp = teff.init_params(tc, seed=4, train_init=train_init)
    jl, tl = list(_leaves(jp)), list(_leaves(tp))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_param_counts():
    jc, tc = _configs('efficientnetv2_s', 1000)
    params = teff.init_params(tc)
    n = teff.num_params(params)
    assert n == jeff.num_params(jeff.init_params(jc))
    # torchvision efficientnet_v2_s has ~21.46M parameters
    assert 20e6 < n < 23e6
    # static scales are not parameters
    q = teff.quantize_params_chain(params, tc)
    q['head']['y_scale'] = 0.5
    assert teff.num_params(q) == jeff.num_params(
        jeff.quantize_params_chain(jeff.init_params(jc), jc))


@pytest.mark.parametrize('arch,side', [('efficientnetv2_test', 48),
                                       ('efficientnetv2_s', 64)])
def test_float32_forward_matches_jax(arch, side):
    jc, tc = _configs(arch)
    params = _sane_params(arch, 1)
    x = _images(side)
    ref = np.asarray(jeff.apply(jc, params, jnp.asarray(x)))
    got = _run(_port(tc, params), x)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_bf16_rounds_as_jax_and_no_further_than_jax_bf16():
    """Every float conv, SE gate and block output of the bf16 network is
    bf16 (logits float32), and the logits are no further from JAX's bf16
    apply than that is from JAX's float32 apply."""

    jc, tc = _configs('efficientnetv2_s')
    params = _sane_params('efficientnetv2_s', 2)
    x = _images(64, seed=3)
    jp16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  params)
    ref16 = np.asarray(jeff.apply(jc, jp16, jnp.asarray(x),
                                  dtype=jnp.bfloat16))
    ref32 = np.asarray(jeff.apply(jc, params, jnp.asarray(x)))
    model = _port(tc, params, torch.bfloat16)
    dtypes = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: dtypes.append((type(m).__name__, o.dtype)))
        for m in model.modules()
        if isinstance(m, (teff.FloatConv, teff.Block))]
    got = _run(model, x)
    for h in hooks:
        h.remove()
    assert got.dtype == np.float32
    assert len(dtypes) == sum(1 for m in model.modules() if isinstance(
        m, (teff.FloatConv, teff.Block)))
    assert all(d == torch.bfloat16 for _, d in dtypes), dtypes
    assert np.abs(got - ref16).max() <= np.abs(ref16 - ref32).max()


def test_bf16_matches_jax_on_the_tiny_net():
    """On the tiny net the bf16 rounding points line up: the port's bf16
    logits equal JAX's but for the fc's float32 sums, which add in
    another order (relative 1e-6)."""

    jc, tc = _configs('efficientnetv2_test')
    params = teff.init_params(tc, seed=0)
    x = _images(48, seed=0)
    jp16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  params)
    ref = np.asarray(jeff.apply(jc, jp16, jnp.asarray(x),
                                dtype=jnp.bfloat16))
    got = _run(_port(tc, params, torch.bfloat16), x)
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize('mode', ['w2', 'w4'])
def test_unfold_stem_is_the_exact_inverse_of_fold_stem(mode):
    jc, tc = _configs('efficientnetv2_test')
    params = teff.init_params(tc, seed=5)
    params['stem']['b'] = np.random.RandomState(6).standard_normal(
        params['stem']['b'].shape).astype(np.float32)
    folded = jeff.fold_stem(params, mode=mode)
    assert teff.stem_is_folded(folded) and not teff.stem_is_folded(params)
    unfolded = teff.unfold_stem(folded)
    for key in ('w', 'b'):
        assert unfolded['stem'][key].dtype == np.float32
        assert np.array_equal(unfolded['stem'][key], params['stem'][key])
    assert unfolded['stage0'] is params['stage0']
    # A folded checkpoint runs as the unfolded one, and as JAX runs it
    x = _images(48, seed=7)
    got = _run(_port(tc, folded), x)
    np.testing.assert_array_equal(got, _run(_port(tc, params), x))
    ref = np.asarray(jeff.apply(jc, folded, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_unfold_stem_refuses_other_kernels():
    _, tc = _configs('efficientnetv2_test')
    params = teff.init_params(tc, seed=5)
    folded = jeff.fold_stem(params, mode='w4')
    folded['stem']['w'] = folded['stem']['w'].copy()
    folded['stem']['w'][0, 1, 4, -1] += 1.0   # phase 1 no longer repeats
    with pytest.raises(ValueError, match='not a fold_stem output'):
        teff.unfold_stem(folded)
    with pytest.raises(ValueError, match='w2'):
        teff.unfold_stem({'stem': {'w': np.zeros((3, 2, 5, 4), np.float32),
                                   'b': np.zeros(4, np.float32)}})


@pytest.mark.parametrize('arch', ['efficientnetv2_test', 'efficientnetv2_s'])
def test_convert_torchvision_state_dict_bit_identical(arch):
    from torch_effnet_ref import make_torch_effnet

    model = make_torch_effnet(arch, num_classes=7, seed=0)
    state = model.state_dict()
    jc, tc = _configs(arch, 7)
    ref = jeff.convert_torchvision_state_dict(
        {k: v.detach().numpy() for k, v in state.items()}, jc)
    got = teff.convert_torchvision_state_dict(state, tc)
    jl, tl = list(_leaves(ref)), list(_leaves(got))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # and the converted net is the torch model's function
    x = _images(64, seed=2)
    with torch.no_grad():
        want = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(_run(_port(tc, got), x), want, rtol=1e-3,
                               atol=5e-3)


def test_launch_counts_of_v2m():
    """The counts the card's run asserts: EfficientNetV2-M's 109 int8
    chain convs (54 of them project convs without SiLU), 92 bias + SiLU
    convs in int8, 147 in bf16."""

    config = teff.EfficientNetConfig('efficientnetv2_m', 2000)
    shapes = teff.chain_conv_shapes(config, 480, 64)
    assert len(shapes) == 109
    assert sum(not s['act'] for s in shapes) == 54
    assert teff.forward_launches(config, True, torch.bfloat16) == (109, 92)
    assert teff.forward_launches(config, False, torch.bfloat16) == (0, 147)
    assert teff.forward_launches(config, False, torch.float32) == (0, 0)
    assert teff.forward_launches(config, True, torch.float32) == (109, 0)
    assert len({(s['cin'], s['cout'], s['k'], s['stride'], s['h'],
                 s['act']) for s in shapes}) == 23
    assert shapes[-1]['name'] == 'head' and shapes[-1]['h'] == 15


@pytest.mark.parametrize('quantized,dtype', [
    (False, torch.bfloat16), (True, torch.bfloat16), (True, torch.float32)])
def test_forward_launches_and_shapes_count_the_modules(quantized, dtype):
    """forward_launches and chain_conv_shapes agree with the modules a
    forward runs (efficientnetv2_s at 64 px, batch 2)."""

    from megadetector_tpu_torch.ops import quantization as tq

    config = teff.EfficientNetConfig('efficientnetv2_s', 5)
    params = teff.init_params(config, seed=0)
    x = _images(64, seed=1)
    if quantized:
        params = teff.quantize_params_chain(params, config)
        tq.calibrate_chain_scales(config, params, x, device='cpu')
    model = _port(config, params, dtype)
    calls = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: calls.append((name, m, i[0], o)))
        for name, m in model.named_modules()
        if isinstance(m, (teff.FloatConv, teff.ChainConv))]
    _run(model, x)
    for h in hooks:
        h.remove()
    chain = [(n, i, o) for n, m, i, o in calls
             if isinstance(m, teff.ChainConv)]
    silu = [n for n, m, _, _ in calls if isinstance(m, teff.FloatConv) and
            m.act and dtype == torch.bfloat16]
    assert teff.forward_launches(config, quantized, dtype) == (
        len(chain), len(silu))
    want = teff.chain_conv_shapes(config, 64, 2) if quantized else []
    assert [d['name'] for d in want] == [n[len('layers.'):]
                                         for n, _, _ in chain]
    for d, (_, inp, out) in zip(want, chain):
        q_in = inp.q if isinstance(inp, tq.QTensor) else inp.permute(
            0, 2, 3, 1)
        assert tuple(q_in.shape) == (2, d['h'], d['w'], d['cin'])
        assert tuple(out.q.shape) == (2, d['ho'], d['wo'], d['cout'])
