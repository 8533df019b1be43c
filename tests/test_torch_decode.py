"""
Port parity: candidate selection (ops/decode.py) against the JAX package's
select_topk_candidates (approx=False) and merge_candidates, on the CPU.

Identical head tensors go to both. Classes, validity, candidate counts
and the selection order must be identical. Scores agree to 1e-6 and boxes
to 1e-4 px plus 2e-6 relative: torch's and XLA's float32 sigmoids can
differ by an ulp, and box widths reach 4x the largest anchor (~3700 px),
where one float32 ulp is already 2.4e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megadetector_tpu.models.yolov5 import ANCHORS_P5, ANCHORS_P6
from megadetector_tpu.ops import decode as jax_decode
from megadetector_tpu_torch.ops import decode

NO = 8  # 5 + 3 classes


def _heads(seed, grids, b=2, scale=3.0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal((b, h, w, 3 * NO)) * scale)
            .astype(np.float32) for h, w in grids]


def _select_both(heads, anchors, strides, k, conf=0.005):
    ref = jax_decode.select_topk_candidates(
        [jnp.asarray(h) for h in heads], np.asarray(anchors, np.float32),
        strides, 3, jnp.float32(conf), k, approx=False)
    got = decode.select_topk_candidates(
        [torch.from_numpy(h) for h in heads], anchors, strides, 3, conf, k)
    return got, {key: np.asarray(v) for key, v in ref.items()}


def _assert_same_selection(got, ref):
    for key in ('classes', 'valid', 'n_candidates'):
        np.testing.assert_array_equal(got[key].numpy(), ref[key],
                                      err_msg=key)
    np.testing.assert_allclose(got['scores'].numpy(), ref['scores'],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got['boxes_cxcywh'].numpy(),
                               ref['boxes_cxcywh'], rtol=2e-6, atol=1e-4)


@pytest.mark.parametrize('case', [
    ('p5', ((16, 20), (8, 10), (4, 5)), 512),
    ('p5-truncating', ((16, 20), (8, 10), (4, 5)), 64),
    ('p6', ((16, 16), (8, 8), (4, 4), (2, 2)), 512),
    ('p6-all', ((8, 8), (4, 4), (2, 2), (1, 1)), 4096),
])
def test_select_matches_jax(case):
    name, grids, k = case
    p6 = name.startswith('p6')
    anchors = ANCHORS_P6 if p6 else ANCHORS_P5
    strides = (8, 16, 32, 64) if p6 else (8, 16, 32)
    got, ref = _select_both(_heads(len(name), grids), anchors, strides, k)
    assert got['scores'].shape == ref['scores'].shape
    assert got['boxes_cxcywh'].dtype == torch.float32
    assert got['classes'].dtype == torch.int32
    _assert_same_selection(got, ref)


def test_exact_ties_resolve_to_lower_index():
    """All above-floor anchors carry bit-identical logits, so every score
    ties: the selection must come out in ascending flat index, as
    lax.top_k orders it."""

    heads = _heads(7, ((8, 8), (4, 4), (2, 2)), scale=0.1)
    for h in heads:
        blocks = h.reshape(h.shape[:3] + (3, NO))
        blocks[..., 4] = -9.0          # below the floor ...
        blocks[..., 5:] = 0.0
        blocks[:, ::2, 1::3, :, 4] = 2.0   # ... except a tied grid
        blocks[:, ::2, 1::3, :, 5:] = (1.0, 1.0, 0.5)
    got, ref = _select_both(heads, ANCHORS_P5, (8, 16, 32), 64)
    _assert_same_selection(got, ref)
    scores = got['scores'].numpy()
    assert (scores[got['valid'].numpy()] == scores[0, 0]).all()

    # The first 8 winners lie in grid row 0 of the finest level (stride
    # 8); their cells in flat-index order are x = 1, 4, 7, three anchors
    # each
    gx = np.round(got['boxes_cxcywh'][0, :8, 0].numpy() / 8.0 - 0.5)
    assert got['valid'][0, :8].all()
    np.testing.assert_array_equal(gx, [1, 1, 1, 4, 4, 4, 7, 7])


def test_topk_lower_index_first_matches_lax_top_k():
    rng = np.random.RandomState(0)
    values = rng.randint(-3, 3, (3, 500)).astype(np.float32)
    values[1, :] = 2.0
    values[2, ::7] = -0.0  # lax.top_k orders -0.0 below +0.0
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(values), 100)
    vals, idx = decode.topk_lower_index_first(torch.from_numpy(values), 100)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


def test_saturated_class_logits_pick_lower_class():
    """Two class logits above ~16.6 both sigmoid to 1.0: the class is the
    lower index, not the larger logit."""

    heads = _heads(3, ((4, 4), (2, 2), (1, 1)), scale=0.1)
    blocks = heads[0].reshape(heads[0].shape[:3] + (3, NO))
    blocks[..., 4] = 5.0
    blocks[..., 5:] = (17.0, 30.0, 0.0)
    got, ref = _select_both(heads, ANCHORS_P5, (8, 16, 32), 32)
    _assert_same_selection(got, ref)
    top = got['classes'][:, :16].numpy()
    assert (top == 0).all()


def test_merge_candidates_matches_jax():
    rng = np.random.RandomState(4)
    sets = []
    for kk in (40, 24):
        sets.append({
            'boxes_cxcywh': rng.uniform(0, 500, (2, kk, 4)).astype(
                np.float32),
            'scores': np.round(rng.uniform(-1, 1, (2, kk)), 1).astype(
                np.float32),
            'classes': rng.randint(0, 3, (2, kk)).astype(np.int32),
        })
    ref = jax_decode.merge_candidates(
        [{k: jnp.asarray(v) for k, v in s.items()} for s in sets], 50)
    got = decode.merge_candidates(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in sets], 50)
    for key in ('boxes_cxcywh', 'scores', 'classes', 'valid'):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)
