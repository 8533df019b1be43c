"""
Port parity for the whole slice: the port's load_and_run_detector_batch +
write_results_to_file against the JAX package's, on the same yolov5n .npz
and image folder, on the CPU, in default and classic-strict modes; they
must agree under md_tests.compare_results at the golden tolerances
(conf 0.005, coord 0.001, IoU match 0.85).

Random weights give near-tied, saturated-at-max_det detections, so the
shared numpy parameters are sharpened first (torch_port_data
.sharpened_params): fewer than max_det detections survive and their
scores are spread out, so float differences between the two packages
cannot flip a match. Two aspect buckets, 4 images filling one batch and
3 in one tail bucket, so no tail merge happens and processing order
cannot change any canvas.

Also: the TorchDetector's option handling, its failure containment, the
device policy and the CLI.
"""

import json
import os

import pytest
import torch

from PIL import Image

from megadetector_tpu.detection import run_detector_batch as jax_batch
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector, \
    run_detector_batch
from megadetector_tpu_torch.device import get_device
from megadetector_tpu_torch.models import detector as detector_module
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.ops import _build

import torch_port_data as data

BATCH = 4


@pytest.fixture(scope='module')
def slice_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_slice')
    images = data.images()
    folder = root / 'images'
    folder.mkdir()
    for i, img in enumerate(images):
        Image.fromarray(img).save(str(folder / 'im{:02d}.png'.format(i)))
    model = str(root / 'md_v5a.0.0_test.npz')
    save_checkpoint(data.sharpened_params(images), model, data.METADATA)
    return root, str(folder), model


def _assert_no_ambiguous_matches(output, options):
    """The golden comparator matches greedily; two same-category
    detections at IoU >= the match threshold in one image (e.g. boxes in
    the letterbox padding, clipped to the same zero-width edge box) could
    be paired crosswise even between identical files."""

    t = options.comparison_confidence_threshold
    for im in output['images']:
        dets = [d for d in im['detections'] if d['conf'] >= t]
        for i, a in enumerate(dets):
            for b in dets[i + 1:]:
                assert a['category'] != b['category'] or md_tests._safe_iou(
                    a['bbox'], b['bbox']) < options.iou_match_threshold, \
                    (im['file'], a, b)


@pytest.mark.parametrize('mode,batch,threshold', [
    ('classic', BATCH, None), ('classic-strict', BATCH, None),
    # batch 8: both aspect buckets are part-full tails, which merge onto
    # the square canvas in either package, whatever the order. Its wide
    # padding holds off-image boxes that clip to identical zero-width
    # edge boxes below conf 0.02 (see _assert_no_ambiguous_matches)
    ('classic', 8, 0.02)])
def test_slice_matches_jax_package(slice_inputs, mode, batch, threshold):
    root, folder, model = slice_inputs
    ours = run_detector_batch.load_and_run_detector_batch(
        model, folder, batch_size=batch, quiet=True, device='cpu',
        confidence_threshold=threshold,
        detector_options={'compatibility_mode': mode})
    # use_mesh off: the test session's 8 virtual CPU devices would
    # otherwise round the JAX package's batch up to 8
    ref = jax_batch.load_and_run_detector_batch(
        model, folder, batch_size=batch, quiet=True, loader_workers=1,
        confidence_threshold=threshold,
        detector_options={'compatibility_mode': mode, 'force_cpu': True,
                          'use_mesh': 'false'})
    tag = '{}_{}'.format(mode, batch)
    ours_out = run_detector_batch.write_results_to_file(
        ours, str(root / 'ours_{}.json'.format(tag)),
        relative_path_base=folder, detector_file=model)
    ref_out = jax_batch.write_results_to_file(
        ref, str(root / 'ref_{}.json'.format(tag)),
        relative_path_base=folder, detector_file=model)

    assert ours_out['info']['format_version'] == '1.6'
    assert ours_out['info']['detector'] == ref_out['info']['detector']
    assert ours_out['detection_categories'] == \
        ref_out['detection_categories']
    assert [im['file'] for im in ours_out['images']] == \
        [im['file'] for im in ref_out['images']]
    counts = [len(im['detections']) for im in ours_out['images']]
    assert all(0 < n < 300 for n in counts), counts

    options = data.golden_options()
    _assert_no_ambiguous_matches(ours_out, options)
    result = md_tests.compare_results(ref_out, ours_out, options)
    assert result['n_images_compared'] == len(data.SIZES)
    assert result['errors'] == [], result['errors'][:5]


def test_in_memory_pairs_match_files_and_failures_are_contained(
        slice_inputs):
    _, folder, model = slice_inputs
    detector = run_detector.load_detector(model, device='cpu')
    files = sorted(os.path.join(folder, f) for f in os.listdir(folder))
    broken = os.path.join(folder, '..', 'broken.jpg')
    with open(broken, 'wb') as f:
        f.write(b'not a jpeg')
    from_files = run_detector_batch.load_and_run_detector_batch(
        detector, files + [broken], batch_size=BATCH, quiet=True)
    pairs = [(name, img) for name, img in zip(files, data.images())]
    from_pairs = run_detector_batch.load_and_run_detector_batch(
        detector, pairs, batch_size=BATCH, quiet=True,
        include_image_size=True)

    assert from_files[-1] == {'file': broken, 'detections': None,
                              'failure': 'image access failure'}
    for a, b, img in zip(from_files, from_pairs, data.images()):
        assert a['detections'] == b['detections']
        assert (b['height'], b['width']) == img.shape[:2]


def test_capacity_escalation_and_truncation(slice_inputs):
    _, _, model = slice_inputs
    img = data.images()[0]
    full = run_detector.load_detector(model, device='cpu')
    small = run_detector.load_detector(model, device='cpu',
                                       detector_options={'pre_nms_topk': 8})
    capped = run_detector.load_detector(
        model, device='cpu', detector_options={
            'pre_nms_topk': 8, 'auto_escalate_topk': 'false'})
    ref = full.generate_detections_one_image(img, 'a', 0.005)
    escalated = small.generate_detections_one_image(img, 'a', 0.005)
    truncated = capped.generate_detections_one_image(img, 'a', 0.005)
    assert escalated == ref
    assert 'pre_nms_truncation' not in ref
    assert truncated['pre_nms_truncation'] > 8
    assert len(truncated['detections']) <= 8


def test_kernel_errors_are_never_contained(slice_inputs, monkeypatch):
    _, _, model = slice_inputs
    detector = run_detector.load_detector(model, device='cpu')
    monkeypatch.setattr(detector_module, 'reraise_programming_errors',
                        lambda: False)

    def broken_kernel(*args, **kwargs):
        raise _build.KernelError('launch failed')

    monkeypatch.setattr(detector_module, 'nms_on_candidates',
                        lambda *a, **k: broken_kernel())
    with pytest.raises(_build.KernelError):
        detector.generate_detections_one_image(data.images()[0], 'a', 0.005)


def test_data_errors_become_failure_records(slice_inputs, monkeypatch):
    _, _, model = slice_inputs
    detector = run_detector.load_detector(model, device='cpu')

    def device_fault(*args, **kwargs):
        raise RuntimeError('device fault')

    monkeypatch.setattr(detector, 'run_program', device_fault)
    r = detector.generate_detections_one_batch(
        [data.images()[0], None], ['a', 'b'], detection_threshold=0.005)
    assert r == [{'file': 'a', 'detections': None,
                  'failure': 'inference failure'},
                 {'file': 'b', 'detections': None,
                  'failure': 'image access failure'}]


@pytest.mark.parametrize('options,error', [
    # a mesh that is not the port's mesh class (parallel/mesh.DataMesh)
    ({'mesh': object()}, TypeError),
    ({'xla_compiler_options': 'xla_foo=1'}, NotImplementedError),
])
def test_unported_options_are_refused(slice_inputs, options, error):
    _, _, model = slice_inputs
    with pytest.raises(error):
        run_detector.load_detector(model, detector_options=options,
                                   device='cpu')


@pytest.mark.parametrize('options', [
    {'preprocess_mode': 'device'},
    {'conv_backend': 'pallas', 'dtype': 'bfloat16'},
    {'dtype': 'bfloat16'},
])
def test_bf16_and_device_options_load_and_run(slice_inputs, options):
    """preprocess_mode=device and dtype bf16 (under either conv backend)
    load and run on the CPU; their parity with the JAX package is held in
    test_torch_bf16.py and test_torch_preprocess_device.py."""

    _, _, model = slice_inputs
    detector = run_detector.load_detector(model, detector_options=options,
                                          device='cpu')
    r = detector.generate_detections_one_image(data.images()[4], 'a', 0.005)
    assert r['file'] == 'a' and 0 < len(r['detections']) < 300
    want = torch.bfloat16 if 'dtype' in options else torch.float32
    assert detector.model.compute_dtype == want
    assert detector.model.layers['l1'].weight.dtype == want
    with pytest.raises(ValueError):
        run_detector.load_detector(model, device='cpu', detector_options=dict(
            options, dtype='float16', preprocess_mode='disk'))


@pytest.mark.parametrize('backend', ['pallas', 'pallas-interpret'])
def test_conv_backend_pallas_is_accepted_and_runs(slice_inputs, backend):
    """A float checkpoint has no int8 bottlenecks to fuse: the option is
    taken and leaves the output as it is. An unknown backend raises."""

    _, _, model = slice_inputs
    img = data.images()[4]
    base = run_detector.load_detector(model, device='cpu')
    fused = run_detector.load_detector(
        model, device='cpu', detector_options={'conv_backend': backend})
    assert fused.conv_backend == backend
    assert all(m.fused for m in fused.model.modules()
               if hasattr(m, 'fused'))
    assert fused.generate_detections_one_image(img, 'a', 0.005) == \
        base.generate_detections_one_image(img, 'a', 0.005)
    with pytest.raises(ValueError, match='conv_backend'):
        run_detector.load_detector(model, device='cpu', detector_options={
            'conv_backend': 'cudnn'})


def test_no_op_options_and_unknown_options(slice_inputs):
    _, _, model = slice_inputs
    base = run_detector.load_detector(model, device='cpu')
    no_ops = run_detector.load_detector(model, device='cpu',
                                        detector_options={
        'folded_early': 'true', 'folded_h2': 'true',
        'approx_select': 'false', 'select_cm': 'true',
        'stem_gemm': 'true', 'bottleneck_variant': 'im2col',
        'force_cpu': 'true'})
    img = data.images()[4]
    assert no_ops.device == torch.device('cpu')
    assert no_ops.generate_detections_one_image(img, 'a', 0.005) == \
        base.generate_detections_one_image(img, 'a', 0.005)
    with pytest.raises(ValueError, match='Unknown detector options'):
        run_detector.load_detector(model, device='cpu',
                                   detector_options={'fused_decod': 'x'})
    # augment=True (test-time augmentation) runs since it was ported;
    # its parity with the JAX detector is held in test_torch_tta.py
    r = base.generate_detections_one_image(img, 'a', augment=True)
    assert r['file'] == 'a' and 'pre_nms_truncation' not in r


def test_cuda_request_without_card_raises(slice_inputs):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA card')
    _, _, model = slice_inputs
    with pytest.raises(RuntimeError, match='CUDA'):
        get_device('cuda')
    with pytest.raises(RuntimeError, match='CUDA'):
        run_detector.load_detector(model, device='cuda')
    # No device means the card: without one, None raises too
    with pytest.raises(RuntimeError, match='CUDA'):
        get_device(None)


def test_known_model_name_needs_a_converted_file(tmp_path, monkeypatch):
    monkeypatch.setenv('MD_MODEL_FOLDER', str(tmp_path))
    with pytest.raises(FileNotFoundError, match='md_v5a.0.1.npz'):
        run_detector.resolve_model_file('MDV5A')
    (tmp_path / 'md_v5a.0.1.npz').write_bytes(b'')
    assert run_detector.resolve_model_file('MDV5A') == \
        str(tmp_path / 'md_v5a.0.1.npz')
    with pytest.raises(FileNotFoundError):
        run_detector.resolve_model_file('no_such_model.npz')


def test_cli_writes_md_json(slice_inputs, monkeypatch):
    root, folder, model = slice_inputs
    out = str(root / 'cli' / 'out.json')
    monkeypatch.setattr('sys.argv', [
        'run_detector_batch', model, folder, out,
        '--output_relative_filenames', '--batch_size', '4', '--quiet',
        '--device', 'cpu', '--detector_options',
        'compatibility_mode=classic-strict'])
    run_detector_batch.main()
    with open(out) as f:
        written = json.load(f)
    assert written['info']['format_version'] == '1.6'
    assert [im['file'] for im in written['images']] == \
        sorted(os.listdir(folder))
    for im in written['images']:
        confs = [d['conf'] for d in im['detections']]
        assert confs == sorted(confs, reverse=True)
        assert 'max_detection_conf' not in im
