"""
The committed stub goldens (tests/data/stub_golden_results.json, square
canvas, and stub_golden_results_auto.json, auto canvases; and their
preprocess_mode=device twins stub_golden_results_device.json and
stub_golden_results_auto_device.json) through the port's TorchDetector on
the CPU, unchanged and at the same tolerances tests/test_stored_goldens.py
holds the JAX detector to.

The forward is a torch twin of tests/stub_model.stub_apply (deterministic,
image-dependent, well-separated predictions), routed through the port's
decode=True + batched_nms branch exactly as the JAX stub detector routes
through its own.
"""

import json
import os

import pytest
import torch

from megadetector_tpu.utils import md_tests as comparator
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models.detector import TorchDetector

from stub_model import CELL
from test_reference_golden import _structured_images, IMAGE_SIZE
from test_stored_goldens import (AUTO_DEVICE_GOLDEN_FILE, AUTO_GOLDEN_FILE,
                                 DEVICE_GOLDEN_FILE, GOLDEN_FILE, SIZES)


class TorchStub(torch.nn.Module):
    """Torch twin of stub_model.stub_apply: NHWC uint8 pixels (the host
    path) or float [0, 1] (the device letterbox) -> [B, A, 8] decoded
    predictions in canvas pixels."""

    def forward(self, x, decode=True):
        assert decode, 'the stub emits decoded predictions only'
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        b, hgt, wid, _ = x.shape
        ny, nx = hgt // CELL, wid // CELL
        cells = x.reshape(b, ny, CELL, nx, CELL, 3)
        mean_rgb = cells.mean(dim=(2, 4))
        flat = cells.permute(0, 1, 3, 2, 4, 5).reshape(
            b, ny, nx, CELL * CELL * 3)
        std_all = flat.std(dim=-1, correction=0)
        ci = torch.arange(ny, dtype=torch.float32)[None, :, None]
        cj = torch.arange(nx, dtype=torch.float32)[None, None, :]
        r, g, bl = mean_rgb[..., 0], mean_rgb[..., 1], mean_rgb[..., 2]
        pred = torch.stack([
            (cj + 0.5) * CELL + (r - bl) * 8.0,
            (ci + 0.5) * CELL + (g - r) * 8.0,
            12.0 + g * 80.0,
            12.0 + r * 80.0,
            1.0 / (1.0 + torch.exp(-(200.0 * std_all - 8.0))),
            0.15 + r * 0.8,
            0.10 + g * 0.8,
            0.05 + bl * 0.8,
        ], dim=-1)
        return pred.reshape(b, ny * nx, 8)


def _stub_detector(tmp_path_factory, canvas_mode, preprocess_mode='host'):
    config = yolov5.YoloV5Config('yolov5n', num_classes=3)
    path = str(tmp_path_factory.mktemp('torch_stub') / 'stub.npz')
    save_checkpoint(yolov5.init_params(config, seed=0), path, {
        'arch': 'yolov5n', 'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'],
        'image_size': IMAGE_SIZE})
    # pre_nms_topk above the stub's one candidate per cell, as in
    # tests/stub_model.make_stub_detector
    detector = TorchDetector(path, {'canvas_mode': canvas_mode,
                                    'preprocess_mode': preprocess_mode,
                                    'pre_nms_topk': 131}, device='cpu')
    detector.model = TorchStub()
    detector._fused_decode = False
    return detector


@pytest.mark.parametrize('canvas_mode,golden_file', [
    ('square', GOLDEN_FILE), ('auto', AUTO_GOLDEN_FILE)])
def test_port_matches_stored_golden(tmp_path_factory, canvas_mode,
                                    golden_file):
    detector = _stub_detector(tmp_path_factory, canvas_mode)
    _check_golden(detector, canvas_mode, golden_file)


@pytest.mark.parametrize('canvas_mode,golden_file', [
    ('square', DEVICE_GOLDEN_FILE), ('auto', AUTO_DEVICE_GOLDEN_FILE)])
def test_port_matches_stored_device_golden(tmp_path_factory, canvas_mode,
                                           golden_file):
    """preprocess_mode=device: the device letterbox (ops/preprocess_device
    letterbox_batch) feeds the stub, as the JAX device golden was made."""

    detector = _stub_detector(tmp_path_factory, canvas_mode, 'device')
    _check_golden(detector, canvas_mode, golden_file)
    assert detector.programs_run == len(SIZES)


def _check_golden(detector, canvas_mode, golden_file):
    got = [detector.generate_detections_one_image(
        img, image_id='golden_{:02d}.jpg'.format(i),
        detection_threshold=0.005)
        for i, img in enumerate(_structured_images(SIZES))]
    if canvas_mode == 'auto':
        assert any(s[0] != s[1] for s in detector._auto_canvases)

    assert os.path.isfile(golden_file)
    with open(golden_file) as f:
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
        result = comparator.compare_detection_lists(
            exp_im['detections'], got_im['detections'],
            options=options, image_id=got_im['file'])
        assert result['errors'] == [], result['errors']
        n_dets += len(got_im['detections'])
    assert n_dets > 0
