"""
The detector options and the load_detector signature that the port
shares with the JAX package, held to the JAX detector on the CPU:

- arch overrides the checkpoint metadata's architecture;
- fused_decode picks the selection path as the JAX detector does (default
  on outside the strict modes, either way on request);
- batch_axis is refused with NotImplementedError, as mesh is;
  preprocess_only=true builds a detector without weights whose
  preprocess_image is the full detector's;
- load_detector(model_file, force_cpu=False, detector_options=None,
  verbose=False), with device keyword-only;
- use_mesh, the JAX driver's option: both CLIs given
  --detector_options use_mesh=false write the same JSON, and the detector
  takes it as a no-op (one card);
- is_gpu_available(detector_file=None), called both ways.

Each parity case runs the port's and the JAX package's
load_and_run_detector_batch on the same yolov5n .npz and image folder and
compares them under md_tests.compare_results at the golden tolerances, as
tests/test_torch_detector.py does.
"""

import json
import sys

import numpy as np
import pytest
import torch

from PIL import Image

from megadetector_tpu.detection import run_detector as jax_run_detector
from megadetector_tpu.detection import run_detector_batch as jax_batch
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector, \
    run_detector_batch
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models.detector import TorchDetector

import torch_port_data as data

BATCH = 4


@pytest.fixture(scope='module')
def option_inputs(tmp_path_factory):
    """(root, image folder, yolov5n model, the same weights under metadata
    that names yolov5s)."""

    root = tmp_path_factory.mktemp('torch_options')
    images = data.images()
    folder = root / 'images'
    folder.mkdir()
    for i, img in enumerate(images):
        Image.fromarray(img).save(str(folder / 'im{:02d}.png'.format(i)))
    params = data.sharpened_params(images)
    model = str(root / 'md_v5a.0.0_test.npz')
    save_checkpoint(params, model, data.METADATA)
    mislabeled = str(root / 'md_mislabeled.npz')
    save_checkpoint(params, mislabeled, dict(data.METADATA, arch='yolov5s'))
    return root, str(folder), model, mislabeled


def _assert_matches_jax(root, folder, model, options, tag):
    ours = run_detector_batch.load_and_run_detector_batch(
        model, folder, batch_size=BATCH, quiet=True, device='cpu',
        detector_options=options)
    # use_mesh off: the test session's 8 virtual CPU devices would
    # otherwise round the JAX package's batch up to 8
    ref = jax_batch.load_and_run_detector_batch(
        model, folder, batch_size=BATCH, quiet=True, loader_workers=1,
        detector_options=dict(options, force_cpu=True, use_mesh='false'))
    ours_out = run_detector_batch.write_results_to_file(
        ours, str(root / 'ours_{}.json'.format(tag)),
        relative_path_base=folder, detector_file=model)
    ref_out = jax_batch.write_results_to_file(
        ref, str(root / 'ref_{}.json'.format(tag)),
        relative_path_base=folder, detector_file=model)
    counts = [len(im['detections']) for im in ours_out['images']]
    assert all(0 < n < 300 for n in counts), counts
    result = md_tests.compare_results(ref_out, ours_out,
                                      data.golden_options())
    assert result['n_images_compared'] == len(data.SIZES)
    assert result['errors'] == [], result['errors'][:5]


@pytest.mark.parametrize('mode,fused', [('classic', 'false'),
                                        ('classic-strict', 'true')])
def test_fused_decode_matches_jax(option_inputs, mode, fused):
    """fused_decode against the mode's default: false outside the strict
    modes runs the decoded forward and batched_nms, true in classic-strict
    the fused selection; the JAX detector does the same."""

    root, folder, model, _ = option_inputs
    options = {'compatibility_mode': mode, 'fused_decode': fused}
    detector = run_detector.load_detector(model, device='cpu',
                                          detector_options=options)
    assert detector._fused_decode == (fused == 'true')
    default = run_detector.load_detector(model, device='cpu',
                                         detector_options={
                                             'compatibility_mode': mode})
    assert default._fused_decode == (mode == 'classic')
    _assert_matches_jax(root, folder, model, options,
                        'fused_{}_{}'.format(mode, fused))


def test_arch_override_matches_jax(option_inputs):
    """arch replaces the metadata's architecture: weights saved under a
    wrong arch load and detect as the JAX detector does with the same
    override; without it the port refuses the weights."""

    root, folder, _, mislabeled = option_inputs
    detector = run_detector.load_detector(
        mislabeled, device='cpu', detector_options={'arch': 'yolov5n'})
    assert detector.config.arch == 'yolov5n'
    with pytest.raises(RuntimeError):
        run_detector.load_detector(mislabeled, device='cpu')
    _assert_matches_jax(root, folder, mislabeled, {'arch': 'yolov5n'},
                        'arch')


@pytest.mark.parametrize('options', [{'batch_axis': 'data'}])
def test_unported_multicard_and_loader_options_are_refused(option_inputs,
                                                           options):
    _, _, model, _ = option_inputs
    with pytest.raises(NotImplementedError, match=list(options)[0]):
        run_detector.load_detector(model, device='cpu',
                                   detector_options=options)


@pytest.mark.parametrize('mode', ['classic', 'modern'])
def test_preprocess_only_loads_no_weights_and_preprocesses_alike(
        option_inputs, mode):
    """preprocess_only=true (the loader pool's detector): no weights are
    read and no device is taken, inference raises, and preprocess_image
    gives the full detector's dicts, array for array. Its stride is the
    JAX detector's fixed 64, so the full detector is a P6 model
    (MDv5a's family: yolov5n6 here)."""

    root, _, _, _ = option_inputs
    model = str(root / 'md_n6.npz')
    config = yolov5.YoloV5Config('yolov5n6', num_classes=3)
    save_checkpoint(yolov5.init_params(config, seed=0), model,
                    dict(data.METADATA, arch='yolov5n6'))
    options = {'compatibility_mode': mode, 'image_size': data.IMAGE_SIZE}
    full = run_detector.load_detector(model, device='cpu',
                                      detector_options=options)
    only = TorchDetector('/no/such/weights.npz', dict(
        options, preprocess_only='true'))
    assert only.device is None and not hasattr(only, 'model')
    assert only.letterbox_stride == full.letterbox_stride == 64
    for i, img in enumerate(data.images()):
        a = only.preprocess_image(img, image_id=str(i))
        b = full.preprocess_image(img, image_id=str(i))
        assert sorted(a) == sorted(b)
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert np.array_equal(a[key], b[key]), key
            else:
                assert a[key] == b[key], key
    with pytest.raises(RuntimeError, match='preprocess_only'):
        only.generate_detections_one_image(data.images()[0])


def test_preprocess_only_false_is_the_default(option_inputs):
    _, _, model, _ = option_inputs
    img = data.images()[4]
    base = run_detector.load_detector(model, device='cpu')
    same = run_detector.load_detector(
        model, device='cpu', detector_options={'preprocess_only': 'false'})
    assert same.generate_detections_one_image(img, 'a', 0.005) == \
        base.generate_detections_one_image(img, 'a', 0.005)


@pytest.mark.parametrize('call', ['positional', 'keyword'])
def test_load_detector_force_cpu(option_inputs, call):
    """force_cpu is load_detector's second argument, as in the JAX
    package: load_detector(m, True) and load_detector(m, force_cpu=True)
    both load on the CPU."""

    _, _, model, _ = option_inputs
    if call == 'positional':
        detector = run_detector.load_detector(model, True)
    else:
        detector = run_detector.load_detector(model, force_cpu=True)
    assert detector.device == torch.device('cpu')
    assert next(detector.model.parameters()).device.type == 'cpu'
    r = detector.generate_detections_one_image(data.images()[0], 'a', 0.005)
    assert r['file'] == 'a' and np.isfinite(
        [d['conf'] for d in r['detections']]).all()


def test_load_detector_device_is_keyword_only(option_inputs):
    """device cannot be passed by position (the JAX signature's fourth
    argument is verbose), and contradicting force_cpu raises."""

    _, _, model, _ = option_inputs
    with pytest.raises(TypeError):
        run_detector.load_detector(model, False, None, False, 'cpu')
    with pytest.raises(ValueError, match='force_cpu'):
        run_detector.load_detector(model, True, device='cuda')
    detector = run_detector.load_detector(model, True, device='cpu')
    assert detector.device == torch.device('cpu')


@pytest.mark.parametrize('value', ['false', 'true'])
def test_use_mesh_clis_write_the_same_json(option_inputs, tmp_path,
                                           monkeypatch, value):
    """--detector_options use_mesh=<value> through the port's CLI and the
    JAX package's: the port's driver pops it as the JAX driver does (it
    used to reach the detector and raise), and both write the same
    JSON."""

    root, folder, model, _ = option_inputs
    ours_file = str(tmp_path / 'ours.json')
    ref_file = str(tmp_path / 'ref.json')
    common = ['--output_relative_filenames', '--batch_size', str(BATCH),
              '--detector_options', 'use_mesh=' + value]
    run_detector_batch.main([model, folder, ours_file, '--device', 'cpu'] +
                            common)
    # the JAX driver shards over the session's virtual CPU devices with
    # use_mesh=true, which rounds its batch up: compare at false there
    monkeypatch.setattr(sys, 'argv', ['x', model, folder, ref_file] +
                        common[:-1] + ['use_mesh=false', 'force_cpu=true'])
    jax_batch.main()
    with open(ours_file) as f:
        ours = json.load(f)
    with open(ref_file) as f:
        ref = json.load(f)
    assert ours['info']['format_version'] == ref['info']['format_version']
    result = md_tests.compare_results(ref, ours, data.golden_options())
    assert result['n_images_compared'] == len(data.SIZES)
    assert result['errors'] == [], result['errors'][:5]


def test_detector_takes_use_mesh_as_a_no_op(option_inputs):
    _, _, model, _ = option_inputs
    img = data.images()[0]
    base = run_detector.load_detector(model, device='cpu')
    for value in ('false', 'true', True):
        detector = run_detector.load_detector(
            model, device='cpu', detector_options={'use_mesh': value})
        assert detector.generate_detections_one_image(img, 'a', 0.005) == \
            base.generate_detections_one_image(img, 'a', 0.005)


def test_is_gpu_available_takes_the_jax_arguments(option_inputs):
    """is_gpu_available() and is_gpu_available(model_file), as in the JAX
    package (detector_file is ignored): both say whether torch sees a
    card."""

    _, _, model, _ = option_inputs
    want = torch.cuda.is_available()
    assert run_detector.is_gpu_available() is want
    assert run_detector.is_gpu_available(model) is want
    assert run_detector.is_gpu_available(detector_file=model) is want
    jax_run_detector.is_gpu_available(model)
