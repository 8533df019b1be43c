"""
The weight-validation gate (utils/validate_weights.py) in the port, held
to the JAX package's on the CPU, on tests/test_validate_weights.py's stub
checkpoint (yolov5n, seed 5, 160 px); its comparator, utils/md_tests.py,
is held to JAX's in tests/test_torch_md_tests.py:

- the gate with skip_int8 and skip_export, on the first three images of
  the gate's synthetic set (three aspects; the whole set of six is
  JAX's byte for byte): the same stages and statuses as JAX's gate, its
  golden file at the golden tolerances (conf 0.005, coord 0.001) against
  JAX's; a doctored expected file fails the golden stage in both;
- the int8 stage on the port (quantize_checkpoint mode='chain', force_cpu)
  and the CLI's --dry_run --skip_export;
- the export stage runs by default (skip_export false): the port's
  artifact exported, identical to the live detector on three images with
  escalation off, a one-byte tamper of its programs refused;
- _match_drift identical to JAX's on seeded detection lists; on boxes
  that truncation left with no width (random weights give them), JAX's
  raises (get_iou's assertion; ROADMAP C) and the port's matches a box
  only to an equal one, as md_tests does.
"""

import copy
import json
import os
import zipfile

import numpy as np
import pytest

from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu.models.convert_weights import \
    save_checkpoint as jax_save_checkpoint
from megadetector_tpu.utils import md_tests as jax_md_tests
from megadetector_tpu.utils import validate_weights as jax_vw
from megadetector_tpu_torch.utils import validate_weights as vw


@pytest.fixture(scope='module')
def stub_checkpoint(tmp_path_factory):
    folder = tmp_path_factory.mktemp('torch_validate_model')
    cfg = jax_yolov5.YoloV5Config('yolov5n', num_classes=3)
    path = str(folder / 'stub.npz')
    jax_save_checkpoint(jax_yolov5.init_params(cfg, seed=5), path, {
        'model_version_string': 'v5a.0.1', 'arch': 'yolov5n',
        'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'],
        'image_size': 160, 'anchors': cfg.anchors.tolist()})
    return path


@pytest.fixture(scope='module')
def image_dir(tmp_path_factory):
    """The first three images of the gate's synthetic set (640x480,
    480x640, 512x512): the JAX gate compiles a program a canvas."""

    return jax_vw._build_image_set(
        str(tmp_path_factory.mktemp('torch_validate_images')), n=3)


def test_synthetic_image_set_is_jax_s(tmp_path):
    ours = vw._build_image_set(str(tmp_path / 'ours'))
    ref = jax_vw._build_image_set(str(tmp_path / 'ref'))
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names and len(names) == 6
    for name in names:
        with open(os.path.join(ours, name), 'rb') as a, \
                open(os.path.join(ref, name), 'rb') as b:
            assert a.read() == b.read(), name


def _options(module, checkpoint, scratch, **kwargs):
    options = module.ValidateWeightsOptions()
    options.checkpoint = checkpoint
    options.scratch_dir = scratch
    options.force_cpu = True
    options.skip_int8 = True
    options.skip_export = True
    options.verbose = False
    for k, v in kwargs.items():
        setattr(options, k, v)
    return options


@pytest.fixture(scope='module')
def jax_driver_in_order():
    """The JAX gate's batch driver with one loader and use_mesh off: in
    the test session its mesh rounds a batch up to the 8 virtual CPU
    devices, and with several loaders its batches depend on their timing
    (ROADMAP C); the port's driver takes images in input order."""

    from megadetector_tpu.detection import run_detector_batch as jax_batch

    original = jax_batch.load_and_run_detector_batch

    def in_order(*args, **kwargs):
        kwargs['loader_workers'] = 1
        kwargs['detector_options'] = dict(
            kwargs.get('detector_options') or {}, use_mesh='false')
        return original(*args, **kwargs)

    jax_batch.load_and_run_detector_batch = in_order
    yield
    jax_batch.load_and_run_detector_batch = original


@pytest.fixture(scope='module')
def gates(stub_checkpoint, image_dir, tmp_path_factory, jax_driver_in_order):
    """(port's report, JAX's report) of the fast gate."""

    root = tmp_path_factory.mktemp('torch_validate_gates')
    ours = vw.validate_weights(_options(vw, stub_checkpoint,
                                        str(root / 'ours'),
                                        image_dir=image_dir))
    ref = jax_vw.validate_weights(_options(jax_vw, stub_checkpoint,
                                           str(root / 'ref'),
                                           image_dir=image_dir))
    return ours, ref


def test_options_match_jax():
    assert vars(vw.ValidateWeightsOptions()) == \
        vars(jax_vw.ValidateWeightsOptions())


def test_fast_gate_matches_jax(gates):
    ours, ref = gates
    stages = ('convert', 'golden', 'int8', 'capacity', 'export')
    assert ours['status'] == ref['status'] == 'ok', (ours, ref)
    assert ours['failed_stages'] == ref['failed_stages'] == []
    assert [ours[s]['status'] for s in stages] == \
        [ref[s]['status'] for s in stages]
    assert ours['convert'] == ref['convert']
    assert ours['int8'] == ref['int8'] == {'status': 'skipped'}
    assert ours['export'] == ref['export'] == {'status': 'skipped'}
    # random weights overflow 512 candidates at the floor in both: the
    # scan recommends the same ladder
    assert ours['capacity'] == ref['capacity']
    with open(ours['golden']['golden_file']) as f:
        golden = json.load(f)
    assert golden['info']['format_version'] == '1.6'
    assert len(golden['images']) == 3
    options = jax_md_tests.MDTestOptions()
    options.comparison_confidence_threshold = 0.1
    result = jax_md_tests.compare_results(ref['golden']['golden_file'],
                                          ours['golden']['golden_file'],
                                          options)
    assert result['n_images_compared'] == 3
    assert result['errors'] == [], result['errors'][:5]


def test_doctored_expected_file_fails_the_golden_stage(gates,
                                                       stub_checkpoint,
                                                       image_dir, tmp_path,
                                                       jax_driver_in_order):
    ours, _ = gates
    with open(ours['golden']['golden_file']) as f:
        doctored = json.load(f)
    moved = 0
    for im in doctored['images']:
        for d in im.get('detections') or []:
            d['conf'] = min(1.0, d['conf'] + 0.3)
            moved += 1
    assert moved > 0
    expected = str(tmp_path / 'expected_doctored.json')
    with open(expected, 'w') as f:
        json.dump(doctored, f)
    reports = [module.validate_weights(_options(
        module, stub_checkpoint, str(tmp_path / name), image_dir=image_dir,
        expected_results_file=expected))
        for name, module in (('ours', vw), ('ref', jax_vw))]
    for report in reports:
        assert report['status'] == 'FAILED'
        assert report['failed_stages'] == ['golden']
    assert reports[0]['golden']['n_comparison_errors'] == \
        reports[1]['golden']['n_comparison_errors'] > 0


def test_int8_stage_and_the_dry_run_cli(stub_checkpoint, image_dir,
                                        tmp_path, capsys):
    report = vw.validate_weights(_options(
        vw, stub_checkpoint, str(tmp_path / 'int8'), image_dir=image_dir,
        skip_int8=False, int8_p99_score_drift=1.0))
    assert report['status'] == 'ok', report
    assert report['int8']['status'] == 'ok'
    assert os.path.isfile(os.path.join(str(tmp_path / 'int8'),
                                       'validated.int8.npz'))
    assert report['int8']['n_matched'] + report['int8']['n_unmatched'] > 0

    out = str(tmp_path / 'dry.json')
    with pytest.raises(SystemExit) as e:
        vw.main(['--dry_run', '--skip_export', '--skip_int8',
                 '--scratch_dir', str(tmp_path / 'dry'),
                 '--output_file', out])
    assert e.value.code == 0
    with open(out) as f:
        dry = json.load(f)
    assert dry['status'] == 'ok' and dry['export'] == {'status': 'skipped'}
    capsys.readouterr()


def test_export_stage_is_refused_before_any_stage(stub_checkpoint,
                                                  image_dir, tmp_path):
    """The export stage is no longer refused: it runs by default, after
    the four other stages, and passes on the stub."""

    assert vw.ValidateWeightsOptions().skip_export is False
    scratch = str(tmp_path / 'export')
    report = vw.validate_weights(_options(vw, stub_checkpoint, scratch,
                                          image_dir=image_dir,
                                          skip_export=False))
    assert report['status'] == 'ok', report
    stage = report['export']
    assert stage['status'] == 'ok' and stage['tamper_rejected'] is True
    assert stage['n_images_checked'] == 3
    assert stage['artifact'] == os.path.join(scratch, 'validated.mdpkg')
    with zipfile.ZipFile(stage['artifact']) as z:
        manifest = json.loads(z.read('manifest.json'))
    assert manifest['batch_sizes'] == [1, 4]
    assert manifest['topk_ladder'] == [512, 2048]
    assert manifest['platforms'] == ['cpu']
    assert len(manifest['canvases']) == 4
    assert list(report)[:6] == ['checkpoint', 'convert', 'golden', 'int8',
                                'capacity', 'export']


def _random_detections(rng, files, n):
    out = []
    for fn in files:
        dets = []
        for _ in range(rng.randint(0, n)):
            x, y = rng.uniform(0, 0.8, 2)
            dets.append({'category': str(rng.randint(1, 4)),
                         'conf': float(np.round(rng.uniform(0, 1), 3)),
                         'bbox': [float(x), float(y),
                                  float(rng.uniform(0.01, 0.2)),
                                  float(rng.uniform(0.01, 0.2))]})
        out.append({'file': fn, 'detections': dets})
    return out


def test_match_drift_identical_to_jax():
    rng = np.random.RandomState(0)
    files = ['im{}.jpg'.format(i) for i in range(20)]
    for trial in range(5):
        a = _random_detections(rng, files, 12)
        b = copy.deepcopy(a)
        for im in b:
            for d in im['detections']:
                d['conf'] = float(np.clip(d['conf'] + rng.normal(0, 0.02),
                                          0, 1))
                x, y, w, h = d['bbox']
                d['bbox'] = [x + rng.normal(0, 0.01), y + rng.normal(0, 0.01),
                             w * rng.uniform(0.9, 1.1),
                             h * rng.uniform(0.9, 1.1)]
        b[0]['detections'] = []
        b = b[:-1] + _random_detections(rng, files[-1:], 12)
        for iou in (0.5, 0.8):
            assert vw._match_drift(a, b, iou) == \
                jax_vw._match_drift(a, b, iou)


def test_match_drift_takes_degenerate_boxes_where_jax_raises():
    flat = [0.25, 0.5, 0.0, 0.1]
    float_ims = [{'file': 'a.jpg', 'detections': [
        {'category': '1', 'conf': 0.9, 'bbox': flat},
        {'category': '1', 'conf': 0.8, 'bbox': [0.5, 0.5, 0.0, 0.2]},
        {'category': '2', 'conf': 0.7, 'bbox': [0.1, 0.1, 0.2, 0.2]}]}]
    int8_ims = [{'file': 'a.jpg', 'detections': [
        {'category': '1', 'conf': 0.85, 'bbox': list(flat)},
        {'category': '2', 'conf': 0.72, 'bbox': [0.1, 0.1, 0.2, 0.21]}]}]
    with pytest.raises(AssertionError, match='Malformed'):
        jax_vw._match_drift(float_ims, int8_ims)
    scores, coords, unmatched = vw._match_drift(float_ims, int8_ims)
    assert unmatched == 1
    assert scores == pytest.approx([0.05, 0.02])
    assert max(coords) == pytest.approx(0.01)

