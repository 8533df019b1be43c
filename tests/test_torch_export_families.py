"""
The port's exported artifact for the other detector families on the CPU:
yolov8n (MDv1000's anchor-free YOLOv8), rfdetr_test (RF-DETR) and
detr_tiny (DETR), random weights from a seed, each exported at batch 4 on
its square canvas and run through the batch driver on four images against
the live detector it was exported from: byte-identical results.
"""

import json
import os

import pytest
from PIL import Image

from megadetector_tpu_torch.detection import export_detector as ed
from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.models import detr, rfdetr, yolov8
from megadetector_tpu_torch.models.convert_weights import save_checkpoint

import torch_port_data as data

FAMILIES = {
    'yolov8n': (lambda: yolov8.init_params(yolov8.YoloV8Config('yolov8n', 3),
                                           seed=0),
                {'arch': 'yolov8n', 'model_type': 'ultralytics',
                 'image_size': 128}),
    'rfdetr_test': (lambda: rfdetr.init_params(
        rfdetr.RFDetrConfig('rfdetr_test', 3, image_size=168), seed=0),
        {'arch': 'rfdetr_test', 'model_type': 'rfdetr', 'image_size': 168}),
    'detr_tiny': (lambda: detr.init_params(detr.DetrConfig('detr_tiny', 3),
                                           seed=2),
                  {'arch': 'detr_tiny', 'model_type': 'detr',
                   'image_size': 96}),
}


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_export_families')
    images = root / 'images'
    images.mkdir()
    for i, img in enumerate(data.images()[:4]):
        Image.fromarray(img[:240, 40:280]).save(
            str(images / 'sq{:02d}.png'.format(i)))
    return root, str(images)


def _results(model, images):
    results = run_detector_batch.load_and_run_detector_batch(
        model, images, batch_size=4, quiet=True, device='cpu',
        confidence_threshold=0.005)
    for r in results:
        r['file'] = os.path.basename(r['file'])
    return json.dumps(sorted(results, key=lambda r: r['file'])).encode()


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_artifact_matches_the_live_detector(folder, family):
    root, images = folder
    make_params, metadata = FAMILIES[family]
    model = str(root / '{}.npz'.format(family))
    save_checkpoint(make_params(), model, dict(
        metadata, num_classes=3,
        class_names=['animal', 'person', 'vehicle']))
    artifact = str(root / '{}.mdpkg'.format(family))
    manifest = ed.export_detector(model, artifact, batch_sizes=[4],
                                  aspects=[], platforms=['cpu'])
    size = metadata['image_size']
    assert manifest['canvases'] == [[size, size]]
    assert manifest['fused_decode'] is False
    live = _results(model, images)
    assert b'"detections": []' not in live
    assert _results(artifact, images) == live
