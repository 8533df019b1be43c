"""
The int8 activation chain as a whole slice, on the CPU: the JAX package's
quantize_checkpoint on yolov5s6 at 128 px (as tests/test_int8_golden.py
builds it, width-folded on disk) through the port's TorchDetector.

- The port reproduces the stored golden tests/data/int8_s6_golden_results
  .json at that file's own IoU-matched int8 tolerances, under both
  conv_backend values.
- The port and the JAX TPUDetector agree on that checkpoint.
- The port's own quantize_checkpoint writes an unfolded checkpoint with
  the same int8 weights and (within calibration's float noise) the same
  scales, which the JAX TPUDetector loads and runs.
"""

import json

import numpy as np
import pytest
import torch

from megadetector_tpu.models.convert_weights import (
    load_checkpoint as jax_load_checkpoint, quantize_checkpoint as
    jax_quantize_checkpoint)
from megadetector_tpu.models.detector import TPUDetector
from megadetector_tpu.ops.folding import params_are_folded
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import (
    flatten_params, load_checkpoint, quantize_checkpoint, save_checkpoint,
    unfold_early_params)

from test_int8_golden import (GOLDEN_FILE, IMAGE_SIZE,
                              INT8_MATCH_FRACTION, _run_pipeline,
                              _tolerant_match)


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    folder = tmp_path_factory.mktemp('torch_int8')
    cfg = yolov5.YoloV5Config('yolov5s6', num_classes=3)
    f_path = str(folder / 'float.npz')
    save_checkpoint(yolov5.init_params(cfg, seed=0), f_path, {
        'arch': 'yolov5s6', 'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'],
        'image_size': IMAGE_SIZE, 'anchors': cfg.anchors.tolist()})
    q_path = str(folder / 'int8_jax.npz')
    jax_quantize_checkpoint(f_path, q_path,
                            calibration_image_size=IMAGE_SIZE, mode='chain')
    return f_path, q_path


def _matched(expected, got):
    total_exp = total_matched = 0
    for exp_im, got_im in zip(expected['images'], got['images']):
        assert exp_im['file'] == got_im['file']
        n_exp, n_matched = _tolerant_match(exp_im['detections'],
                                           got_im['detections'])
        total_exp += n_exp
        total_matched += n_matched
    return total_exp, total_matched


@pytest.mark.parametrize('conv_backend', ['xla', 'pallas'])
def test_port_reproduces_int8_golden(checkpoints, conv_backend):
    _, q_path = checkpoints
    detector = run_detector.load_detector(
        q_path, device='cpu', detector_options={'conv_backend':
                                                conv_backend})
    assert isinstance(detector.model.layers['l1'], yolov5.QConv)
    got = _run_pipeline(detector)
    with open(GOLDEN_FILE) as f:
        expected = json.load(f)
    assert len(got['images']) == len(expected['images'])
    total_exp, total_matched = _matched(expected, got)
    assert total_exp >= 10
    assert total_matched >= INT8_MATCH_FRACTION * total_exp, \
        '{}/{} matched'.format(total_matched, total_exp)


def test_port_agrees_with_jax_detector(checkpoints):
    _, q_path = checkpoints
    ours = _run_pipeline(run_detector.load_detector(q_path, device='cpu'))
    ref = _run_pipeline(TPUDetector(q_path))
    total_exp, total_matched = _matched(ref, ours)
    assert total_exp >= 10
    assert total_matched >= INT8_MATCH_FRACTION * total_exp, \
        '{}/{} matched'.format(total_matched, total_exp)


def test_quantized_checkpoint_loads(checkpoints):
    """load_checkpoint takes the JAX package's folded int8 checkpoint:
    int8 w_q leaves, Python-float scales; unfolded, its l1 is the plain
    3x3 stride-2 layout."""

    _, q_path = checkpoints
    params, metadata = load_checkpoint(q_path)
    assert metadata['quantized'] is True
    assert params['l1']['w_q'].dtype == np.int8
    assert isinstance(params['l1']['y_scale'], float)
    assert 'cv12' in params['l2']
    cfg = yolov5.YoloV5Config('yolov5s6', num_classes=3)
    plain = unfold_early_params(params, cfg)
    assert plain['l1']['w_q'].shape == (3, 3, 32, 64)
    assert plain['l2']['cv1']['y_scale'] == params['l2']['cv12']['y_scale']
    assert plain['l0']['w'].shape == (6, 6, 3, 32)


def test_port_written_checkpoint_runs_in_jax(checkpoints, tmp_path):
    f_path, q_path = checkpoints
    port_path = str(tmp_path / 'int8_port.npz')
    quantize_checkpoint(f_path, port_path,
                        calibration_image_size=IMAGE_SIZE, device='cpu')
    cfg = yolov5.YoloV5Config('yolov5s6', num_classes=3)

    # Same int8 weights and policy as the JAX package's, unfolded. The
    # scales: l1-l3 agree to float32 noise (the JAX package calibrates its
    # folded l0, which sums in another order). Deeper, each layer of the
    # calibration forward quantizes at its input's dynamic abs-max, so a
    # flipped rounding moves every later abs-max a little: measured median
    # 0.3 %, largest 2.5 % on this checkpoint.
    port, metadata = load_checkpoint(port_path)
    assert metadata['quantization'] == 'int8-chain'
    jax_params = flatten_params(unfold_early_params(
        load_checkpoint(q_path)[0], cfg))
    port = flatten_params(port)
    assert sorted(port) == sorted(jax_params)
    rel = []
    for k, v in port.items():
        if k.endswith(('x_scale', 'y_scale')):
            rel.append(abs(float(v) / float(jax_params[k]) - 1.0))
            assert rel[-1] <= (1e-5 if k.startswith(('l1/', 'l2/', 'l3/'))
                               else 5e-2), k
        else:
            assert v.dtype == jax_params[k].dtype, k
            assert v.tobytes() == jax_params[k].tobytes(), k
    assert len(rel) > 100 and np.median(rel) <= 1e-2

    # The JAX TPUDetector loads the unfolded checkpoint as it is, and
    # agrees with the port on it
    assert not params_are_folded(jax_load_checkpoint(port_path)[0])
    ref = _run_pipeline(TPUDetector(port_path))
    ours = _run_pipeline(run_detector.load_detector(port_path,
                                                    device='cpu'))
    total_exp, total_matched = _matched(ref, ours)
    assert total_exp >= 10
    assert total_matched >= INT8_MATCH_FRACTION * total_exp


def test_conv_backends_agree_exactly_on_cpu(checkpoints):
    """Fused and unfused bottlenecks give the same detections."""

    _, q_path = checkpoints
    x = torch.from_numpy(np.random.RandomState(5).rand(
        2, 128, 192, 3).astype(np.float32))
    heads = []
    for backend in ('xla', 'pallas-interpret'):
        detector = run_detector.load_detector(
            q_path, device='cpu', detector_options={'conv_backend': backend})
        with torch.inference_mode():
            heads.append(detector.model(x, decode=False))
    for a, b in zip(*heads):
        assert torch.equal(a, b)


def test_quantize_checkpoint_calibrates_on_a_folder(tmp_path):
    """Calibration images from a folder, letterboxed to the square
    calibration canvas, as the JAX package's calibration_folder does."""

    from PIL import Image

    cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
    f_path = str(tmp_path / 'float.npz')
    save_checkpoint(yolov5.init_params(cfg, seed=0), f_path, {
        'arch': 'yolov5n', 'model_type': 'yolov5', 'num_classes': 3,
        'image_size': 64})
    folder = tmp_path / 'calib'
    folder.mkdir()
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(48, 80), (90, 60)]):
        Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(
            np.uint8)).save(str(folder / 'c{}.png'.format(i)))
    q_path = str(tmp_path / 'int8.npz')
    quantize_checkpoint(f_path, q_path, calibration_folder=str(folder),
                        device='cpu')
    params, metadata = load_checkpoint(q_path)
    assert metadata['quantized'] is True
    # l0 float; l1 on int8 with scales; l2's cv1/cv2 share theirs
    assert 'w' in params['l0'] and params['l1']['w_q'].dtype == np.int8
    assert params['l1']['x_scale'] > 0 and params['l1']['y_scale'] > 0
    assert params['l2']['cv1']['y_scale'] == params['l2']['cv2']['y_scale']
    assert params['l2']['cv1']['x_scale'] == params['l2']['cv2']['x_scale']
    with pytest.raises(ValueError, match='already quantized'):
        quantize_checkpoint(q_path, str(tmp_path / 'again.npz'),
                            device='cpu')
