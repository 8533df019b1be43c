"""
The bf16 configuration of the port on the CPU, against the JAX package's:

- the yolov5n / yolov5s bf16 forward (YoloV5 with set_compute_dtype bf16)
  against JAX yolov5.apply(dtype=bfloat16) on bf16(u8) / bf16(255), with
  l0 as the plain bf16 conv (strict) or the fused stem from the uint8
  pixels (default). The bar is the JAX forward's own bf16 error: the port
  must sit no further from JAX bf16 than JAX bf16 sits from JAX float32
  (strict: within 0.75 of it, as only the conv sums' order differs;
  default: its mean, and 1.25 of its max, since the stem rounds w / 255
  where JAX rounds x / 255 and w);
- the bf16 detector on the sharpened yolov5n checkpoint against the JAX
  TPUDetector(dtype='bfloat16'), IoU-matched, no further from it than the
  JAX bf16 detector is from the JAX float32 one on the same images;
- int8 with dtype bf16 (the int8 chain with bf16 l0 and heads, the JAX
  bench's int8 step) on the JAX-made int8 yolov5s6 checkpoint, against
  the JAX int8 + bf16 TPUDetector with the int8 golden comparator (conf
  0.02, coord 0.01, best-IoU matching), under both conv backends. The
  share matched must reach the share at which the JAX int8 + bf16
  detector matches the JAX int8 float32 one. That share is 0.677 on this
  random-weight checkpoint, not the 0.9 of the float32 comparison: a bf16
  l0 output that differs by one ulp moves the chain's entry quantization
  to the next int8 step, and the random model's near-tied boxes turn that
  into other detections. The port's strict bf16 path, the same graph as
  JAX's with only the conv sums in another order, matches JAX bf16 at the
  same 0.678;
- the fused decode on bf16 heads equals it on the same heads in float32
  (to 1e-6: the CPU's sigmoid may take another code path on the strided
  float32 view).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu.models.convert_weights import \
    quantize_checkpoint as jax_quantize_checkpoint
from megadetector_tpu.models.detector import TPUDetector
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.ops import l0_fused, silu_bf16
from megadetector_tpu_torch.ops.decode import select_topk_candidates

import torch_port_data as data
from test_int8_golden import IMAGE_SIZE as INT8_IMAGE_SIZE
from test_int8_golden import INT8_MATCH_FRACTION, _run_pipeline
from test_torch_int8 import _matched

FORWARD_SIZE = 128


@pytest.fixture(scope='module')
def jax_heads():
    """Per arch: (params, uint8 batch, JAX bf16 heads, JAX f32 heads)."""

    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jax_yolov5.YoloV5Config(arch, num_classes=3)
            params = jax_yolov5.init_params(cfg, seed=0)
            u8 = np.random.RandomState(0).randint(
                0, 256, (2, FORWARD_SIZE, FORWARD_SIZE, 3), dtype=np.uint8)
            x16 = jnp.asarray(u8).astype(jnp.bfloat16) / jnp.bfloat16(255.0)
            x32 = jnp.asarray(u8, jnp.float32) / jnp.float32(255.0)
            # jitted, as the JAX detector runs it (one compile, not one
            # per op)
            h16 = [np.asarray(h.astype(jnp.float32)) for h in jax.jit(
                functools.partial(jax_yolov5.apply, cfg, dtype=jnp.bfloat16,
                                  decode=False))(params, x16)]
            h32 = [np.asarray(h) for h in jax.jit(
                functools.partial(jax_yolov5.apply, cfg, dtype=jnp.float32,
                                  decode=False))(params, x32)]
            cache[arch] = (params, u8, h16, h32)
        return cache[arch]

    return get


@pytest.mark.parametrize('arch', ['yolov5n', 'yolov5s'])
@pytest.mark.parametrize('fused_stem', [False, True],
                         ids=['strict', 'fused_stem'])
def test_bf16_forward_matches_jax(jax_heads, arch, fused_stem):
    params, u8, ref16, ref32 = jax_heads(arch)
    cfg = yolov5.YoloV5Config(arch, num_classes=3)
    model = yolov5.YoloV5(cfg).load_params(params).set_compute_dtype(
        torch.bfloat16, fused_stem=fused_stem).eval()
    assert (model.stem_w is not None) == fused_stem
    with torch.inference_mode():
        got = model(torch.from_numpy(u8), decode=False)
    for lvl, (g, r16, r32) in enumerate(zip(got, ref16, ref32)):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == r16.shape
        g = g.float().numpy()
        own_max = np.abs(r16 - r32).max()
        own_mean = np.abs(r16 - r32).mean()
        d_max, d_mean = np.abs(g - r16).max(), np.abs(g - r16).mean()
        if fused_stem:
            assert d_mean <= own_mean and d_max <= 1.25 * own_max, \
                (lvl, d_mean, own_mean, d_max, own_max)
        else:
            assert d_mean <= 0.75 * own_mean and d_max <= 0.75 * own_max, \
                (lvl, d_mean, own_mean, d_max, own_max)


def _iou(a, b):
    iw = min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0])
    ih = min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1])
    inter = max(iw, 0.0) * max(ih, 0.0)
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def _distance(results_a, results_b, floor=0.02, iou_match=0.85):
    """IoU-matched distance from A's detections (conf >= floor, nonzero
    area) to B's: (unmatched count, max and mean conf error)."""

    unmatched, errors = 0, []
    for a, b in zip(results_a, results_b):
        assert a['file'] == b['file']
        for d in a['detections']:
            if d['conf'] < floor or d['bbox'][2] * d['bbox'][3] == 0:
                continue
            same = [e for e in b['detections']
                    if e['category'] == d['category']]
            best = max(same, key=lambda e: _iou(d['bbox'], e['bbox']),
                       default=None)
            if best is None or _iou(d['bbox'], best['bbox']) < iou_match:
                unmatched += 1
            else:
                errors.append(abs(best['conf'] - d['conf']))
    return unmatched, max(errors), float(np.mean(errors))


def test_bf16_detector_matches_jax_bf16(tmp_path):
    images = data.images()
    model = str(tmp_path / 'md_v5a.0.0_test.npz')
    save_checkpoint(data.sharpened_params(images), model, data.METADATA)
    ids = ['im{}'.format(i) for i in range(len(images))]

    def run(detector):
        return detector.generate_detections_one_batch(images, ids, 0.005)

    jax32 = run(TPUDetector(model, {'force_cpu': True}))
    jax16 = run(TPUDetector(model, {'force_cpu': True,
                                    'dtype': 'bfloat16'}))
    port = run_detector.load_detector(model, device='cpu',
                                      detector_options={'dtype': 'bf16'})
    assert port.model.stem_w is not None
    ours = run(port)

    own = _distance(jax16, jax32)
    got = _distance(jax16, ours)
    assert sum(len(r['detections']) for r in ours) > 100
    assert got[0] <= own[0] + 1 and got[1] <= own[1] and \
        got[2] <= 1.25 * own[2], (got, own)


@pytest.fixture(scope='module')
def int8_checkpoint(tmp_path_factory):
    folder = tmp_path_factory.mktemp('torch_int8_bf16')
    cfg = yolov5.YoloV5Config('yolov5s6', num_classes=3)
    f_path = str(folder / 'float.npz')
    save_checkpoint(yolov5.init_params(cfg, seed=0), f_path, {
        'arch': 'yolov5s6', 'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'],
        'image_size': INT8_IMAGE_SIZE, 'anchors': cfg.anchors.tolist()})
    q_path = str(folder / 'int8_jax.npz')
    jax_quantize_checkpoint(f_path, q_path,
                            calibration_image_size=INT8_IMAGE_SIZE,
                            mode='chain')
    ref16 = _run_pipeline(TPUDetector(q_path, {'dtype': 'bfloat16'}))
    ref32 = _run_pipeline(TPUDetector(q_path))
    total, matched = _matched(ref16, ref32)
    return q_path, ref16, matched / total


@pytest.mark.parametrize('conv_backend', ['xla', 'pallas'])
def test_int8_bf16_matches_jax_int8_bf16(int8_checkpoint, conv_backend):
    q_path, ref, own_share = int8_checkpoint
    detector = run_detector.load_detector(
        q_path, device='cpu', detector_options={
            'dtype': 'bfloat16', 'conv_backend': conv_backend})
    model = detector.model
    assert isinstance(model.layers['l1'], yolov5.QConv)
    assert model.stem_w is not None
    head = model.layers['l{}'.format(len(model.config.layers) - 1)].m0
    assert head.weight.dtype == torch.bfloat16
    ours = _run_pipeline(detector)
    total_exp, total_matched = _matched(ref, ours)
    assert total_exp >= 10
    assert 0.6 <= own_share < INT8_MATCH_FRACTION
    assert total_matched >= own_share * total_exp, \
        '{}/{} matched, JAX bf16 vs float32 {}'.format(
            total_matched, total_exp, own_share)


def test_fused_decode_takes_bf16_heads():
    cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
    model = yolov5.YoloV5(cfg).load_params(
        data.sharpened_params(data.images())).set_compute_dtype(
            torch.bfloat16, fused_stem=True).eval()
    u8 = torch.from_numpy(np.stack(data.images()[:4]))[:, :192, :256]
    with torch.inference_mode():
        heads = model(u8.contiguous(), decode=False)
    assert all(h.dtype == torch.bfloat16 for h in heads)
    args = (cfg.anchors, cfg.strides, cfg.num_classes, 0.005, 256)
    got = select_topk_candidates(heads, *args)
    want = select_topk_candidates([h.float() for h in heads], *args)
    assert set(got) == set(want)
    for k in got:
        if got[k].is_floating_point():
            assert got[k].dtype == torch.float32
            assert float((got[k] - want[k]).abs().max()) <= 1e-6, k
        else:
            assert torch.equal(got[k], want[k]), k
    # l0 went through the stem, every later activated conv through the
    # bf16 epilogue (the plain versions here; the counters count kernel
    # launches only)
    assert l0_fused.launches == 0 and silu_bf16.launches == 0
