"""
The port's fused stem (ops/l0_fused.py, kernel B4) on the CPU: its plain
version against the JAX package's Pallas l0_fused in interpret mode
(megadetector_tpu/ops/pallas_l0.py), and against the float32 XLA conv.

The JAX kernel works on the width-folded layout: it sums 216 terms (half
of them zero) in its matmul's order and returns [B, H/2, W/4, 2C], whose
column 2w'+p lives in channels p*C:(p+1)*C; reshaped, that is [B, H/2,
W/2, C]. The port sums the 108 real taps in (ky, kx, c) order. Every
uint8 x bf16 product is exact in float32, so only the order of the adds
differs: the two agree to within 1 bf16 ulp, on a small share of
elements (bounded below).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jax.experimental import pallas as pl

from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu.ops import folding, pallas_l0
from megadetector_tpu_torch.models.convert_weights import \
    unfold_early_params
from megadetector_tpu_torch.models.yolov5 import YoloV5Config
from megadetector_tpu_torch.ops import l0_fused

# Share of elements allowed to differ (by exactly 1 bf16 ulp) from the JAX
# kernel, where the f32 sums of the two orders straddle a bf16 rounding
# point: measured 1.05e-5 at (2, 128, 256) and 8.1e-6 at (1, 96, 160)
MAX_ULP_SHARE = 1e-4


@pytest.fixture(scope='module')
def l0_nodes():
    config = YoloV5Config('yolov5l6', num_classes=3)
    folded = folding.fold_early_params(
        jax_yolov5.init_params(config, seed=0), config, h2=False)
    unfolded = unfold_early_params(folded, config)
    return folded['l0'], unfolded['l0']


def _interp(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs['interpret'] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, 'pallas_call', patched)


def _ulps(a, b):
    """|a - b| in bf16 ulps (monotone integer map of the bit patterns)."""

    def key(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return (key(a) - key(b)).abs()


@pytest.mark.parametrize('shape,rows', [((2, 128, 256), 16),
                                        ((1, 96, 160), 16)])
def test_plain_matches_jax_l0_fused(l0_nodes, monkeypatch, shape, rows):
    _interp(monkeypatch)
    folded, unfolded = l0_nodes
    b, h, w = shape
    images = np.random.RandomState(0).randint(0, 256, (b, h, w, 3),
                                              dtype=np.uint8)
    w_i, b_i = pallas_l0.prepare_l0_weights(folded)
    ref = np.asarray(pallas_l0.l0_fused(jnp.asarray(images), w_i, b_i,
                                        rows_per_band=rows))
    c = ref.shape[-1] // 2
    ref = torch.from_numpy(ref.astype(np.float32).reshape(
        b, h // 2, w // 2, c)).to(torch.bfloat16)

    wt, bt = l0_fused.prepare_l0_weights(unfolded)
    out = l0_fused.l0_fused(torch.from_numpy(images), wt, bt)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape

    ulps = _ulps(out, ref)
    share = float((ulps > 0).float().mean())
    assert int(ulps.max()) <= 1, int(ulps.max())
    assert share <= MAX_ULP_SHARE, share


def test_weights_are_the_folded_real_taps(l0_nodes):
    """prepare_l0_weights rounds w / 255 as the JAX one does: every
    nonzero folded weight appears among the port's 108 x C values."""

    folded, unfolded = l0_nodes
    w_i, _ = pallas_l0.prepare_l0_weights(folded)
    wt, _ = l0_fused.prepare_l0_weights(unfolded)
    jax_vals = np.asarray(w_i, np.float32)
    c = wt.shape[1]
    ours = wt.float().numpy()
    # folded phase-0 output channels hold the 108 real taps, 108 nonzero
    # rows out of 216
    phase0 = jax_vals[:, :c]
    nonzero = phase0[np.any(phase0 != 0, axis=1)]
    assert nonzero.shape == (108, c)
    assert np.array_equal(np.sort(nonzero, axis=0), np.sort(ours, axis=0))


def test_plain_matches_f32_conv(l0_nodes):
    """Against the float32 XLA conv of the unfolded l0 on x / 255, below
    0.02 as tests/test_pallas_l0.py holds the JAX kernel (bf16 weights and
    output against float32)."""

    _, unfolded = l0_nodes
    images = np.random.RandomState(1).randint(0, 256, (2, 64, 96, 3),
                                              dtype=np.uint8)
    x = jnp.asarray(images, jnp.float32) / 255.0
    ref = np.asarray(jax_yolov5._conv(
        {'w': jnp.asarray(unfolded['w']), 'b': jnp.asarray(unfolded['b'])},
        x, 2, jnp.float32, pad=2))
    wt, bt = l0_fused.prepare_l0_weights(unfolded)
    out = l0_fused.l0_fused(torch.from_numpy(images), wt, bt).float()
    assert out.shape == ref.shape
    assert float(np.abs(out.numpy() - ref).max()) < 0.02


@pytest.mark.parametrize('shape,w_shape', [
    ((1, 63, 64, 3), (108, 64)),   # odd height
    ((1, 64, 65, 3), (108, 64)),   # odd width
    ((1, 64, 64, 4), (108, 64)),   # not RGB
    ((1, 64, 64, 3), (216, 64)),   # folded weights
])
def test_bad_geometry_raises(l0_nodes, shape, w_shape):
    images = torch.zeros(shape, dtype=torch.uint8)
    w = torch.zeros(w_shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        l0_fused.l0_fused(images, w, torch.zeros(w_shape[1]))
    with pytest.raises(ValueError):
        l0_fused.prepare_l0_weights({'w': np.zeros((6, 3, 12, 128)),
                                     'b': np.zeros(128)})
