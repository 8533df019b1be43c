"""
The port's exported detector artifact (detection/export_detector.py) on the
CPU:

- the artifact against the live detector it was exported from, through the
  batch driver: byte-identical results for yolov5n in float32 and bf16
  on seven images in two canvas buckets (a whole and a padded batch; two
  capacities in float32), and for the int8 chain under both conv
  backends on four square crops (one canvas, one capacity: each int8
  program takes seconds to trace); the other families are in
  tests/test_torch_export_families.py;
- one exported selection program serves every threshold (the thresholds
  are tensor inputs: its program-cache key holds none);
- a live detector gives the same real tensors before and after an export
  in the same process;
- the JAX package's artifact, the committed pico artifact, the refusals
  and the manifest are in tests/test_torch_export_artifact.py.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from megadetector_tpu.detection import export_detector as jax_export
from megadetector_tpu_torch import device as port_device
from megadetector_tpu_torch.detection import export_detector as ed
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.models.convert_weights import (
    quantize_checkpoint, save_checkpoint)

import torch_port_data as data

# Square, 4:3 (the (240, 320) images) and 3:4 (the (300, 200) ones)
ASPECTS = ['4:3', '3:4']
LADDER = [512, 1024]


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_export')
    folder = root / 'images'
    folder.mkdir()
    square = root / 'square'
    square.mkdir()
    images = data.images()
    for i, img in enumerate(images):
        Image.fromarray(img).save(str(folder / 'im{:02d}.png'.format(i)))
    for i, img in enumerate(images[:4]):
        Image.fromarray(img[:240, 40:280]).save(
            str(square / 'sq{:02d}.png'.format(i)))
    float_path = str(root / 'md_v5a.0.0_export.npz')
    save_checkpoint(data.sharpened_params(images), float_path, data.METADATA)
    int8_path = str(root / 'md_v5a.0.0_export_int8.npz')
    quantize_checkpoint(float_path, int8_path,
                        calibration_images=[im[:192, :256]
                                            for im in images[:4]],
                        calibration_image_size=256, device='cpu')
    return {'root': root, 'folder': str(folder), 'square': str(square),
            'float': float_path, 'int8': int8_path}


# (checkpoint, detector options, image folder, aspects, capacities)
CASES = {
    'float32': ('float', {}, 'folder', ASPECTS, LADDER),
    'bf16': ('float', {'dtype': 'bf16'}, 'folder', ASPECTS, [512]),
    'int8_xla': ('int8', {}, 'square', [], [512]),
    'int8_pallas': ('int8', {'conv_backend': 'pallas'}, 'square', [],
                    [512]),
}


def _results_bytes(results, folder):
    """The images of a results file as written: the driver's records,
    relative filenames, serialized."""

    for r in results:
        r['file'] = os.path.relpath(r['file'], folder)
    return json.dumps(sorted(results, key=lambda r: r['file']),
                      indent=1).encode()


def _batch_results(model, folder, options=None):
    return run_detector_batch.load_and_run_detector_batch(
        model, folder, batch_size=4, quiet=True, device='cpu',
        confidence_threshold=0.005, detector_options=options)


@pytest.mark.parametrize('case', sorted(CASES))
def test_artifact_matches_the_live_detector(world, case):
    kind, options, folder, aspects, ladder = CASES[case]
    folder = world[folder]
    artifact = str(world['root'] / '{}.mdpkg'.format(case))
    manifest = ed.export_detector(world[kind], artifact, batch_sizes=[4],
                                  aspects=aspects, topk_ladder=ladder,
                                  platforms=['cpu'],
                                  detector_options=options)
    assert manifest['format_version'] == ed.FORMAT_VERSION != \
        jax_export.FORMAT_VERSION
    assert manifest['canvases'] == ([[192, 256], [256, 192], [256, 256]]
                                    if aspects else [[256, 256]])
    assert manifest['compute_dtype'] == ('bfloat16' if case == 'bf16'
                                         else 'float32')
    assert manifest['conv_backend'] == options.get('conv_backend', 'xla')
    live = _batch_results(world[kind], folder, options)
    exported = _batch_results(artifact, folder)
    assert sum(len(r['detections']) for r in live) > 0
    assert _results_bytes(exported, folder) == _results_bytes(live, folder)


def test_one_program_serves_every_threshold(world):
    artifact = str(world['root'] / 'thresholds.mdpkg')
    ed.export_detector(world['float'], artifact, batch_sizes=[4],
                       aspects=['4:3'], platforms=['cpu'])
    live = run_detector.load_detector(world['float'], device='cpu')
    exported = run_detector.load_detector(artifact, device='cpu')
    images = data.images()[:4]
    for threshold in (0.005, 0.2, 0.6, 0.005):
        assert exported.generate_detections_one_batch(
            images, detection_threshold=threshold) == \
            live.generate_detections_one_batch(
                images, detection_threshold=threshold)
    # One forward and one selection program for four thresholds (and the
    # IoU threshold a tensor input too)
    assert sorted(exported._programs.entries) == [
        ('forward', 4, 192, 256, True),
        ('forward', 4, 192, 256, True, 'select', 512)]
    assert exported._programs.entries[
        ('forward', 4, 192, 256, True, 'select', 512)].calls >= 4
    with torch.inference_mode():
        batch = np.stack([exported.preprocess_image(im)['img_processed']
                          for im in images])
        for iou in (0.3, 0.45, 0.8):
            got, _ = exported.run_program(batch, 0.005, iou)
            want, _ = live.run_program(batch, 0.005, iou)
            for k in want:
                assert np.array_equal(got[k], want[k]), (iou, k)


def test_live_detector_is_unchanged_by_an_export(world):
    live = run_detector.load_detector(world['float'], device='cpu',
                                      detector_options={'dtype': 'bf16'})
    batch = np.stack([live.preprocess_image(im)['img_processed']
                      for im in data.images()[:4]])
    before, _ = live.run_program(batch, 0.005, 0.45)
    ed.export_detector(world['float'], str(world['root'] / 'again.mdpkg'),
                       batch_sizes=[4], aspects=['4:3'], platforms=['cpu'],
                       detector_options={'dtype': 'bf16'})
    after, _ = live.run_program(batch, 0.005, 0.45)
    for k in before:
        assert np.array_equal(before[k], after[k]), k
    assert all(type(t) is torch.Tensor
               for t in port_device._CONSTANTS.values())
