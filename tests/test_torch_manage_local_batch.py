"""
The port's folder workflow (workflows/manage_local_batch.py: BatchJob)
against the JAX package's on the CPU, end to end over two camera folders
with torch_port_data's yolov5n (its objectness raised so that some boxes
pass the preview and RDE thresholds) at batch 8 and a small
efficientnetv2_test classifier: detections within the golden tolerances
and classifications equal; given the JAX job's detections file, every
later stage's files (validation, RDE and its filtering folder, the
classified and smoothed file, the previews, the report) byte-identical,
and so are the operator affordances (audits, sequences, sequence
smoothing, custom taxa, subsets, the interesting preview, the zip). A job
resumed from its checkpoint equals an unbroken one; plan_chunks writes the
port's modules and its script's commands run; estimate_time uses the measured rate;
the job runs alike with tqdm and sklearn hidden.
"""

import importlib
import json
import os
import shlex
import shutil
import sys
import zipfile

import numpy as np
import pytest
from PIL import Image

from megadetector_tpu.models import efficientnet as jeff
from megadetector_tpu.models.convert_weights import save_checkpoint
from megadetector_tpu.utils import md_tests
from megadetector_tpu.workflows import manage_local_batch as jmlb
from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.workflows import manage_local_batch as tmlb

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_data as data  # noqa: E402
import torch_workflow_data as wd  # noqa: E402

CLASSES = ['deer', 'fox', 'cow', 'other']


def _detector_params(images):
    """torch_port_data's sharpened yolov5n with every objectness logit
    raised by 1: about 200 boxes an image, a few above 0.2."""

    params = data.sharpened_params(images)
    config = yolov5.YoloV5Config('yolov5n', 3)
    detect = params['l{}'.format(len(config.layers) - 1)]
    no = config.num_outputs
    for level in range(3):
        for anchor in range(3):
            detect['m{}'.format(level)]['b'][anchor * no + 4] += 1.0
    return params


def _classifier_params():
    cfg = jeff.EfficientNetConfig('efficientnetv2_test', num_classes=4)
    params = jeff.init_params(cfg, seed=3)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (v * np.float32(0.6) if v.ndim == 4 else v)
                for k, v in node.items()}
    params = walk(params)
    params['fc']['w'] = params['fc']['w'] * np.float32(8.0)
    return params


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """Two camera folders of 8 JPEGs, each image shown about three times
    at its camera (the repeats RDE flags), one aspect a camera so that
    every canvas fills whole batches of 8 (the JAX driver re-letterboxes
    partial tail buckets onto the square canvas), the detector and
    classifier checkpoints, and the JAX package's run_all."""

    root = tmp_path_factory.mktemp('batch_job')
    images = data.images()
    folder = root / 'images'
    for i in range(16):
        cam = folder / 'cam{}'.format(i % 2)
        cam.mkdir(parents=True, exist_ok=True)
        Image.fromarray(images[(i // 2) % 3 + 4 * (i % 2)]).save(
            str(cam / 'im{:02d}.jpg'.format(i)), quality=95)
    detector = str(root / 'detector.npz')
    save_checkpoint(_detector_params(images), detector, data.METADATA)
    classifier = str(root / 'classifier.npz')
    save_checkpoint(_classifier_params(), classifier, {
        'arch': 'efficientnetv2_test', 'num_classes': 4,
        'class_names': CLASSES, 'image_size': 64})
    assets = {'root': root, 'folder': str(folder), 'detector': detector,
              'classifier': classifier}
    job = jmlb.BatchJob(_options(jmlb, assets, 'jax_jobs'))
    job.run_all()
    assets['jax'] = job
    return assets


def _options(module, assets, base, **fields):
    options = module.BatchJobOptions()
    options.input_path = assets['folder']
    options.output_base = str(assets['root'] / base)
    options.job_name = 'job'
    options.model_file = assets['detector']
    options.batch_size = 8
    options.confidence_threshold = 0.02
    options.rde_occurrence_threshold = 3
    options.preview_sample_size = -1
    options.classifier_model = assets['classifier']
    options.classification_confidence_threshold = 0.05
    options.preview_each_stage = True
    if module is jmlb:
        # One loader and no mesh: the JAX driver's batches then do not
        # depend on loader timing or on the 8 virtual CPU devices
        options.loader_workers = 1
        options.detector_options = {'force_cpu': 'true',
                                    'use_mesh': 'false'}
    else:
        options.device = 'cpu'
    for k, v in fields.items():
        setattr(options, k, v)
    return options


def _load(path):
    with open(path) as f:
        return json.load(f)


def _assert_detections_match(got, want):
    got, want = _load(got), _load(want)
    counts = [len(im['detections']) for im in got['images']]
    assert all(0 < n < 300 for n in counts), counts
    result = md_tests.compare_results(want, got, data.golden_options())
    assert result['n_images_compared'] == 16
    assert result['errors'] == [], result['errors'][:5]


@pytest.fixture(scope='module')
def port_job(assets):
    job = tmlb.BatchJob(_options(tmlb, assets, 'port_jobs'))
    final = job.run_all()
    return job, final


def test_run_all_matches_jax(assets, port_job):
    job, final = port_job
    ref = assets['jax']
    assert os.path.relpath(final, job.job_dir) == \
        os.path.relpath(ref.final_file, ref.job_dir) == \
        'job_detections_filtered_classified.json'
    _assert_detections_match(job.detections_file, ref.detections_file)
    # RDE flagged each camera's repeats
    filtered = _load(job.filtered_file)
    assert sum(d['conf'] < 0 for im in filtered['images']
               for d in im['detections']) >= 20
    got, want = _load(final), _load(ref.final_file)
    assert got['classification_categories'] == \
        want['classification_categories']
    n = 0
    for a, b in zip(got['images'], want['images']):
        for d, r in zip(a['detections'], b['detections']):
            assert ('classifications' in d) == ('classifications' in r)
            if 'classifications' in d:
                n += 1
                assert [c[0] for c in d['classifications']] == \
                    [c[0] for c in r['classifications']]
                np.testing.assert_allclose(
                    [c[1] for c in d['classifications']],
                    [c[1] for c in r['classifications']], rtol=0,
                    atol=1e-4)
    assert n >= 20
    assert sorted(wd.tree(job.job_dir)) == sorted(wd.tree(ref.job_dir))
    assert job.detection_images_per_second > 0
    assert job.estimate_time() == 16 / job.detection_images_per_second


def _given_jax_detections(assets, base, **fields):
    """A port job whose detection stage is the JAX job's file."""

    job = tmlb.BatchJob(_options(tmlb, assets, base, **fields))
    shutil.copyfile(assets['jax'].detections_file, job.detections_file)
    job.enumerate_images()
    return job


def _later_stages(job):
    job.validate()
    job.build_preview(stage='pre_rde')
    job.run_rde()
    job.validate()
    job.build_preview(stage='post_rde')
    job.run_classifier()
    job.build_preview(stage='post_classification')
    job.build_preview()
    job.build_report()


def test_later_stages_identical_given_jax_detections(assets):
    """Every file byte-identical but the classified file, whose
    classifier scores (written unrounded) agree to 1e-6 (the two
    packages' float32 sums in another order)."""

    job = _given_jax_detections(assets, 'given')
    _later_stages(job)
    names = wd.assert_same_tree(
        job.job_dir, assets['jax'].job_dir,
        close=('job_detections_filtered_classified.json',))
    for name in ('preview/index.html', 'report.csv',
                 'preview_post_rde/index.html',
                 'job_detections_filtered.json',
                 'job_detections_filtered_classified.json'):
        assert name in names
    assert any(n.startswith('rde/filtering_STAMP/detection_')
               for n in names)
    # The report's rows are the final file's images
    with open(os.path.join(job.job_dir, 'report.csv')) as f:
        rows = f.read().splitlines()
    assert len(rows) == 1 + len(_load(job.final_file)['images'])


def test_affordances_identical(assets, tmp_path):
    """The operator affordances on the same final file in both
    packages."""

    outs = {}
    for module, side in ((jmlb, 'jax'), (tmlb, 'port')):
        options = _options(module, assets, 'afford_' + side,
                           sequence_method='folder',
                           allow_same_family_smoothing=True)
        job = module.BatchJob(options)
        os.makedirs(job.job_dir, exist_ok=True)
        shutil.copyfile(assets['jax'].final_file, job.detections_file)
        job.final_file = job.detections_file
        job.enumerate_images()
        results = [job.audit_results(), job.audit_classification_results(),
                   job.audit_classification_results(threshold=0.5)]
        sequences = job.build_sequences()
        job.smooth_sequences()
        exif = job.build_sequences(method='exif', max_gap_seconds=5.0)
        cct = wd.write_json(os.path.join(job.job_dir, 'cct.json'),
                            {'images': exif})
        job.options.cct_formatted_json = cct
        results += [sequences, exif, job.build_sequences(method='json')]
        taxa = os.path.join(job.job_dir, 'taxa.txt')
        with open(taxa, 'w') as f:
            f.write('deer\nfox\n')
        job.apply_custom_taxa(taxa, None)
        job.strip_nonanimal_classifications()
        job.remove_unused_categories()
        results.append(sorted(job.split_results_by_top_folder()))
        job.build_interesting_preview(['animal', 'person'], threshold=0.1)
        zipped = job.zip_results()
        with zipfile.ZipFile(zipped) as zf:
            results.append(zf.read(os.path.basename(job.final_file))
                           .decode())
        os.remove(zipped)
        outs[side] = (job.job_dir, json.dumps(results, default=str))
    assert outs['port'][1] == outs['jax'][1]
    wd.assert_same_tree(outs['port'][0], outs['jax'][0],
                        replace=((b'afford_jax', b'afford_port'),))


def test_resumed_job_equals_unbroken(assets, port_job):
    """A job folder holding a checkpoint of the first 8 results (a crashed
    run) resumes from it; the detections file is the unbroken job's."""

    job = tmlb.BatchJob(_options(tmlb, assets, 'resumed', run_rde=False,
                                 classifier_model=None))
    files = job.enumerate_images()
    done = run_detector_batch.load_and_run_detector_batch(
        assets['detector'], files[:8], batch_size=8, quiet=True,
        confidence_threshold=0.02, device='cpu')
    run_detector_batch.write_checkpoint(
        os.path.join(job.job_dir, 'md_checkpoint.json'), done)
    job.run_detector()
    assert not os.path.exists(os.path.join(job.job_dir,
                                           'md_checkpoint.json'))
    got, want = _load(job.detections_file), \
        _load(port_job[0].detections_file)
    for d in (got, want):
        d['info'].pop('detection_completion_time')
    assert got == want


def test_plan_chunks_writes_the_port_modules(assets, port_job,
                                             monkeypatch):
    job = tmlb.BatchJob(_options(tmlb, assets, 'chunks'))
    script = job.plan_chunks(2, per_chunk_detector_options=[
        'use_mesh=false'])
    with open(script) as f:
        text = f.read()
    assert text.count('python -m megadetector_tpu_torch.detection.'
                      'run_detector_batch ') == 2
    assert 'python -m megadetector_tpu_torch.postprocessing.' \
        'combine_batch_outputs ' in text
    assert text.count('--device cpu') == 2
    assert 'megadetector_tpu.' not in text
    ref = jmlb.BatchJob(_options(jmlb, assets, 'chunks_jax'))
    with open(ref.plan_chunks(2, per_chunk_detector_options=[
            'use_mesh=false'])) as f:
        assert text.replace('megadetector_tpu_torch.', 'megadetector_tpu.') \
            .replace(' --device cpu', '').replace(
                str(assets['root'] / 'chunks') + os.sep,
                str(assets['root'] / 'chunks_jax') + os.sep) == f.read()
    # The script is its shebang, set -e, comments and three commands; each
    # command runs, in order, through its module's main() in this process
    # (a subprocess a command would import torch anew)
    lines = text.splitlines()
    commands = [shlex.split(line) for line in lines
                if line.startswith('python -m ')]
    assert len(commands) == 3 and all(
        line.startswith('python -m ') or line.startswith('#') or
        line == 'set -e' for line in lines)
    for argv in commands:
        module = importlib.import_module(argv[2])
        monkeypatch.setattr(sys, 'argv', [argv[2]] + argv[3:])
        module.main()
    # The chunks at the CLI's defaults, merged: every image once
    merged = _load(job.detections_file)
    assert sorted(im['file'] for im in merged['images']) == \
        sorted(job.image_files)
    # The card's rate where no detection stage ran
    assert job.estimate_time() == 16 / tmlb.CARD_IMAGES_PER_SECOND
    assert job.estimate_time(images_per_second=230.0) == \
        ref.estimate_time(images_per_second=230.0)


def test_run_all_without_tqdm_and_sklearn(assets, port_job, monkeypatch):
    """tqdm and sklearn hidden: the same job folder, file for file."""

    for name in ('tqdm', 'sklearn', 'sklearn.cluster'):
        monkeypatch.setitem(sys.modules, name, None)
    job = tmlb.BatchJob(_options(tmlb, assets, 'hidden'))
    job.run_all()
    ref = port_job[0]
    stamp = _load(ref.detections_file)['info']['detection_completion_time']
    ours = _load(job.detections_file)['info']['detection_completion_time']
    wd.assert_same_tree(job.job_dir, ref.job_dir,
                        replace=((stamp.encode(), ours.encode()),))


def test_cli_runs_the_port_job(assets, monkeypatch):
    out = str(assets['root'] / 'cli')
    monkeypatch.setattr(sys, 'argv', [
        'manage_local_batch', assets['folder'], out, '--model_file',
        assets['detector'], '--job_name', 'cli', '--device', 'cpu'])
    tmlb.main()
    for name in ('cli_detections.json', 'cli_detections_filtered.json',
                 'preview/index.html', 'report.csv'):
        assert os.path.isfile(os.path.join(out, 'cli', name))
