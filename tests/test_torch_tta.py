"""
Test-time augmentation (augment=True) in the port, on the CPU, against the
JAX package in the same process:

- tta_passes, _tta_transform_input (F.interpolate against
  jax.image.resize at non-square canvases, both scaled passes) and
  tta_concatenated_predictions (random-init yolov5n; also against the
  torch oracle tests/reference_pipeline.reference_forward_augment);
- the stored TTA golden tests/data/stub_golden_results_tta.json through
  the port's detector with the torch stub, at tests/test_stored_goldens.py's
  tolerances;
- the port's augment=True detections against the JAX detector's, fused and
  unfused: float32 at the golden tolerances, int8 yolov5s6 at the int8 bar,
  bf16 at the bf16 bar (ROADMAP C);
- augment with preprocess_mode=device refused as JAX refuses it.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megadetector_tpu.models import detector as jax_detector
from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu.models.detector import TPUDetector
from megadetector_tpu.utils import md_tests as comparator
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.models import detector as port_detector
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models.detector import TorchDetector

import torch_port_data as data
from reference_pipeline import reference_forward_augment
from test_int8_golden import INT8_MATCH_FRACTION
from test_reference_golden import IMAGE_SIZE, _structured_images
from test_stored_goldens import SIZES, TTA_GOLDEN_FILE
from test_torch_bf16 import _distance
from test_torch_int8 import _matched, checkpoints  # noqa: F401  (fixture)
from test_torch_stored_goldens import TorchStub


@pytest.mark.parametrize('height,width,stride', [
    (256, 256, 32), (192, 320, 32), (320, 192, 64), (960, 1280, 64),
    (768, 1280, 64), (128, 96, 32)])
def test_tta_passes_match_jax(height, width, stride):
    ours = port_detector.tta_passes(height, width, stride)
    assert ours == jax_detector.tta_passes(height, width, stride)
    for _, _, sh, sw, ph, pw in ours[1:]:
        assert ph % stride == 0 and pw % stride == 0
        assert 0 <= ph - sh < stride and 0 <= pw - sw < stride


@pytest.mark.parametrize('height,width', [(192, 320), (320, 256),
                                          (960, 1280)])
@pytest.mark.parametrize('i_pass', [1, 2])
def test_tta_transform_input_matches_jax(height, width, i_pass):
    """F.interpolate (half-pixel centres, no antialiasing) against
    jax.image.resize(bilinear, antialias=False): at scales 0.83 and 0.67
    every sample lies inside the image, where the two agree to float
    rounding."""

    rng = np.random.RandomState(height + i_pass)
    x = rng.rand(2, height, width, 3).astype(np.float32)
    s, flip, sh, sw, ph, pw = port_detector.tta_passes(height, width,
                                                       64)[i_pass]
    ours = port_detector._tta_transform_input(
        torch.from_numpy(x), height, width, s, flip, sh, sw, ph, pw,
        torch.float32).numpy()
    ref = np.asarray(jax_detector._tta_transform_input(
        jnp.asarray(x), height, width, s, flip, sh, sw, ph, pw,
        jnp.float32))
    assert ours.shape == ref.shape == (2, ph, pw, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    assert np.all(ours[:, sh:] == np.float32(0.447))
    assert np.all(ours[:, :, sw:] == np.float32(0.447))


@pytest.fixture(scope='module')
def yolov5n():
    config = yolov5.YoloV5Config('yolov5n', num_classes=3)
    params = yolov5.init_params(config, seed=0)
    model = yolov5.YoloV5(config).load_params(params).eval()
    return config, params, model


@pytest.mark.parametrize('height,width', [(256, 256), (192, 320)])
def test_tta_concatenated_predictions_match_jax(yolov5n, height, width):
    config, params, model = yolov5n
    x = np.random.RandomState(3).randint(
        0, 256, (2, height, width, 3), dtype=np.uint8)
    with torch.inference_mode():
        ours = port_detector.tta_concatenated_predictions(
            config, model, torch.from_numpy(x), height, width, 32,
            torch.float32).numpy()
    jax_config = jax_yolov5.YoloV5Config('yolov5n', num_classes=3)
    ref = np.asarray(jax_detector.tta_concatenated_predictions(
        jax_config, jax_yolov5.apply, params,
        jnp.asarray(x.astype(np.float32) / np.float32(255.0)), height,
        width, 32, jnp.float32))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)

    # The torch oracle of yolov5's forward_augment, on the port's network
    def oracle_model(x_nchw):
        return model(x_nchw.permute(0, 2, 3, 1), decode=True)

    xf = torch.from_numpy(x).float() / 255.0
    with torch.inference_mode():
        oracle = reference_forward_augment(
            oracle_model, xf.permute(0, 3, 1, 2).contiguous(), 32,
            nl=len(config.strides)).numpy()
    np.testing.assert_allclose(ours, oracle, rtol=1e-4, atol=1e-4)


def _tta_stub_detector(tmp_path, **options):
    path = str(tmp_path / 'stub.npz')
    save_checkpoint(yolov5.init_params(
        yolov5.YoloV5Config('yolov5n', num_classes=3), seed=0), path, {
        'arch': 'yolov5n', 'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'],
        'image_size': IMAGE_SIZE})
    options = dict({'canvas_mode': 'auto', 'pre_nms_topk': 640}, **options)
    detector = TorchDetector(path, options, device='cpu')
    detector.model = TorchStub()
    detector._fused_decode = False
    # Single-level stand-in: _clip_augmented does not apply
    detector._tta_nl = 1
    return detector


def test_port_matches_stored_tta_golden(tmp_path):
    detector = _tta_stub_detector(tmp_path)
    got = [detector.generate_detections_one_image(
        img, image_id='golden_{:02d}.jpg'.format(i),
        detection_threshold=0.005, augment=True)
        for i, img in enumerate(_structured_images(SIZES))]
    with open(TTA_GOLDEN_FILE) as f:
        expected = json.load(f)
    options = comparator.MDTestOptions()
    options.comparison_confidence_threshold = 0.005
    options.iou_match_threshold = 0.85
    options.max_conf_error = 0.005
    options.max_coord_error = 0.001
    assert len(got) == len(expected['images'])
    n_dets = 0
    for got_im, exp_im in zip(got, expected['images']):
        assert got_im['file'] == exp_im['file']
        assert 'pre_nms_truncation' not in got_im
        result = comparator.compare_detection_lists(
            exp_im['detections'], got_im['detections'], options=options,
            image_id=got_im['file'])
        assert result['errors'] == [], result['errors']
        n_dets += len(got_im['detections'])
    assert n_dets > 0
    # One augment program a canvas, no escalation
    assert detector.programs_run == len(SIZES)


@pytest.fixture(scope='module')
def sharpened_model(tmp_path_factory):
    images = data.images()
    path = str(tmp_path_factory.mktemp('tta') / 'md_v5a.0.0_tta.npz')
    save_checkpoint(data.sharpened_params(images), path, data.METADATA)
    return path, images


def _run(detector, images, augment=True):
    ids = ['im{}'.format(i) for i in range(len(images))]
    return detector.generate_detections_one_batch(
        images, ids, detection_threshold=0.005, augment=augment)


@pytest.mark.parametrize('fused', [True, False])
def test_augment_matches_jax_detector_float32(sharpened_model, fused):
    path, images = sharpened_model
    options = {'fused_decode': str(fused).lower()}
    ref = _run(TPUDetector(path, dict(options, force_cpu=True)), images)
    port = run_detector.load_detector(path, device='cpu',
                                      detector_options=options)
    ours = _run(port, images)
    assert port._fused_decode == fused

    golden = data.golden_options()
    n_dets = 0
    for exp_im, got_im in zip(ref, ours):
        assert exp_im['file'] == got_im['file']
        result = comparator.compare_detection_lists(
            exp_im['detections'], got_im['detections'], options=golden,
            image_id=got_im['file'])
        assert result['errors'] == [], result['errors'][:5]
        n_dets += len(got_im['detections'])
    assert n_dets > 20
    # TTA finds what the plain program finds, and more boxes for it
    plain = _run(port, images, augment=False)
    assert sum(len(r['detections']) for r in ours) >= \
        sum(len(r['detections']) for r in plain)


def test_augment_matches_jax_detector_bf16(sharpened_model):
    """bf16 TTA: no further from the JAX package's bf16 TTA than the JAX
    package's own bf16 TTA is from its float32 TTA (the bf16 bar)."""

    path, images = sharpened_model
    jax32 = _run(TPUDetector(path, {'force_cpu': True}), images)
    jax16 = _run(TPUDetector(path, {'force_cpu': True,
                                    'dtype': 'bfloat16'}), images)
    port = run_detector.load_detector(path, device='cpu',
                                      detector_options={'dtype': 'bf16'})
    assert port.model.stem_w is not None
    ours = _run(port, images)
    own = _distance(jax16, jax32)
    got = _distance(jax16, ours)
    assert sum(len(r['detections']) for r in ours) > 20
    assert got[0] <= own[0] + 1 and got[1] <= own[1] and \
        got[2] <= 1.25 * own[2], (got, own)


@pytest.mark.parametrize('fused', [True, False])
def test_augment_matches_jax_detector_int8(checkpoints, fused):  # noqa: F811
    """int8 yolov5s6 (the JAX package's int8-chain checkpoint) at the
    int8 bar: the share of the JAX detections matched at the int8
    tolerances."""

    from test_int8_golden import SIZES as INT8_SIZES

    _, q_path = checkpoints
    images = _structured_images(INT8_SIZES)
    options = {'fused_decode': str(fused).lower()}
    ref = _run(TPUDetector(q_path, dict(options, force_cpu=True)), images)
    ours = _run(run_detector.load_detector(q_path, device='cpu',
                                           detector_options=options),
                images)
    total_exp, total_matched = _matched({'images': ref}, {'images': ours})
    assert total_exp >= 10
    assert total_matched >= INT8_MATCH_FRACTION * total_exp, \
        '{}/{} matched'.format(total_matched, total_exp)


def test_augment_with_device_preprocess_is_refused(sharpened_model):
    path, images = sharpened_model
    ours = run_detector.load_detector(path, device='cpu', detector_options={
        'preprocess_mode': 'device'})
    ref = TPUDetector(path, {'force_cpu': True,
                             'preprocess_mode': 'device'})
    for detector in (ours, ref):
        with pytest.raises(ValueError, match='preprocess_mode=host'):
            detector.generate_detections_one_image(images[0], 'a',
                                                   augment=True)
