"""
Port parity: greedy NMS (ops/cuda_nms.py, ops/nms.py) against the JAX
package, on the CPU. The CUDA kernel's own tests are in
tests/test_torch_cuda.py.

The plain keep mask must be identical to the JAX package's three
suppressors (_greedy_suppress, _fixpoint_suppress and the Pallas kernel
in interpret mode) on identical boxes; nms_on_candidates, batched_nms and
nms_xyxy must give identical outputs on the valid rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megadetector_tpu.ops import nms as jax_nms
from megadetector_tpu.ops.pallas_nms import pallas_greedy_nms
from megadetector_tpu_torch.ops import _build, cuda_nms, nms


def _sorted_boxes(rng, b, k, canvas=600.0, n_classes=3, offset=True):
    xy = rng.uniform(0, canvas, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(10, 150, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    if offset:
        classes = rng.randint(0, n_classes, (b, k)).astype(np.float32)
        boxes += classes[..., None] * np.float32(8192.0)
    return boxes


def _chain():
    # A overlaps B, B overlaps C, A does not overlap C: A and C are kept
    return np.array([[[100, 100, 140, 140], [120, 100, 160, 140],
                      [140, 100, 180, 140], [500, 500, 540, 540]]],
                    np.float32), np.ones((1, 4), bool)


def _duplicates(rng):
    boxes = _sorted_boxes(rng, 2, 130)
    valid = rng.rand(2, 130) > 0.1
    boxes[:, 1] = boxes[:, 0]
    boxes[:, 64] = boxes[:, 0]       # across the 64-box word boundary
    boxes[:, 65] = boxes[:, 3]
    valid[:, 0] = True
    valid[:, 3] = False              # an invalid box suppresses nothing
    valid[:, 100:110] = False
    return boxes, valid


def _cases():
    rng = np.random.RandomState(0)
    cases = [('chain', _chain(), 0.2), ('duplicates', _duplicates(rng),
                                        0.45)]
    for thresh in (0.2, 0.45, 0.6):
        boxes = _sorted_boxes(rng, 3, 200)
        cases.append(('random-{}'.format(thresh),
                      (boxes, rng.rand(3, 200) > 0.15), thresh))
    return cases


CASES = _cases()


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_plain_keep_identical_to_jax_suppressors(case):
    _, (boxes, valid), thresh = case
    got = cuda_nms.greedy_nms_keep_reference(
        torch.from_numpy(boxes), torch.from_numpy(valid), thresh).numpy()
    pallas = np.asarray(pallas_greedy_nms(boxes, valid, thresh,
                                          interpret=True))
    np.testing.assert_array_equal(got, pallas)
    for b in range(boxes.shape[0]):
        iou = jax_nms._pairwise_iou_xyxy(jnp.asarray(boxes[b]))
        v = jnp.asarray(valid[b])
        t = jnp.float32(thresh)
        np.testing.assert_array_equal(
            got[b], np.asarray(jax_nms._greedy_suppress(iou, v, t)))
        np.testing.assert_array_equal(
            got[b], np.asarray(jax_nms._fixpoint_suppress(iou, v, t)))
    if case[0] == 'chain':
        assert got.tolist() == [[True, False, True, True]]


def test_pairwise_iou_bit_identical_to_jax():
    boxes = _sorted_boxes(np.random.RandomState(2), 1, 300)[0]
    got = cuda_nms.pairwise_iou_xyxy(torch.from_numpy(boxes)).numpy()
    ref = np.asarray(jax_nms._pairwise_iou_xyxy(jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, ref)


def _candidates(rng, b=2, k=256, large_coords=False):
    cxcy = rng.uniform(0, 640, (b, k, 2)).astype(np.float32)
    if large_coords:
        cxcy *= 20.0  # beyond the 8192 offset floor
    wh = rng.uniform(8, 160, (b, k, 2)).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, (b, k)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    valid = scores > 0.2
    scores[~valid] = -1.0
    return {
        'boxes_cxcywh': np.concatenate([cxcy, wh], axis=-1),
        'scores': scores,
        'classes': rng.randint(0, 3, (b, k)).astype(np.int32),
        'valid': valid,
        'n_candidates': valid.sum(axis=1).astype(np.int32),
    }


def _assert_outputs_identical(got, ref):
    valid = np.asarray(ref['valid'])
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    for key in ('boxes', 'scores', 'classes'):
        np.testing.assert_array_equal(got[key].numpy()[valid],
                                      np.asarray(ref[key])[valid],
                                      err_msg=key)
    if 'n_candidates' in ref:
        np.testing.assert_array_equal(got['n_candidates'].numpy(),
                                      np.asarray(ref['n_candidates']))


@pytest.mark.parametrize('variant', ['per-class', 'class-agnostic',
                                     'large-coords', 'max-det-40'])
def test_nms_on_candidates_identical_to_jax(variant):
    cands = _candidates(np.random.RandomState(len(variant)),
                        large_coords=(variant == 'large-coords'))
    agnostic = variant == 'class-agnostic'
    max_det = 40 if variant == 'max-det-40' else 300
    ref = jax_nms.nms_on_candidates(
        {k: jnp.asarray(v) for k, v in cands.items()}, jnp.float32(0.45),
        max_det=max_det, class_agnostic=agnostic)
    got = nms.nms_on_candidates(
        {k: torch.from_numpy(v) for k, v in cands.items()}, 0.45,
        max_det=max_det, class_agnostic=agnostic)
    assert tuple(got['boxes'].shape) == tuple(ref['boxes'].shape)
    _assert_outputs_identical(got, ref)


@pytest.mark.parametrize('num_classes', [1, 3])
def test_batched_nms_identical_to_jax(num_classes):
    rng = np.random.RandomState(num_classes)
    b, a = 2, 900
    pred = np.concatenate([
        rng.uniform(0, 512, (b, a, 2)), rng.uniform(8, 120, (b, a, 2)),
        rng.uniform(0, 1, (b, a, 1 + num_classes))], axis=-1).astype(
            np.float32)
    ref = jax_nms.batched_nms(jnp.asarray(pred), jnp.float32(0.3),
                              jnp.float32(0.45), max_det=100,
                              pre_nms_topk=256)
    got = nms.batched_nms(torch.from_numpy(pred), 0.3, 0.45, max_det=100,
                          pre_nms_topk=256)
    _assert_outputs_identical(got, ref)


def test_nms_xyxy_identical_to_jax():
    rng = np.random.RandomState(9)
    boxes = _sorted_boxes(rng, 1, 150, offset=False)[0]
    scores = rng.uniform(-0.2, 1, 150).astype(np.float32)
    ref_idx, ref_valid = jax_nms.nms_xyxy(jnp.asarray(boxes),
                                          jnp.asarray(scores), 0.5,
                                          max_det=60)
    idx, valid = nms.nms_xyxy(torch.from_numpy(boxes),
                              torch.from_numpy(scores), 0.5, max_det=60)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy()[valid.numpy()],
                                  np.asarray(ref_idx)[np.asarray(ref_valid)])


def test_cpu_tensors_take_the_plain_version():
    boxes, valid = _chain()
    before = cuda_nms.launches
    keep = cuda_nms.greedy_nms_keep(torch.from_numpy(boxes),
                                    torch.from_numpy(valid), 0.2)
    assert keep.tolist() == [[True, False, True, True]]
    assert cuda_nms.launches == before


def test_other_devices_raise():
    boxes = torch.zeros((1, 4, 4), device='meta')
    valid = torch.ones((1, 4), dtype=torch.bool, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        cuda_nms.greedy_nms_keep(boxes, valid, 0.5)


def test_missing_nvcc_raises_kernel_error(monkeypatch, tmp_path):
    """No fallback: without nvcc the build raises KernelError."""

    monkeypatch.setattr(_build, '_lib', None)
    monkeypatch.setattr(_build, 'find_nvcc', lambda: None)
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(_build, 'library_path',
                        lambda: str(tmp_path / 'libnone.so'))
    with pytest.raises(_build.KernelError, match='nvcc not found'):
        _build.load_library()
