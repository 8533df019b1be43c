"""
Self-contained integration test harness (the reference's md_tests layer):
the port's counterpart of megadetector_tpu/utils/integration_tests.py,
driving the port's modules and, in its CLI tier, the port's CLIs (python
-m megadetector_tpu_torch.<module>).

Behavioral contract follows megadetector/utils/md_tests.py:1699
(run_tests): exercise the real pipelines end-to-end — single image,
folder batch (multiple batch sizes, compared for consistency), augmented
inference, video, tiled inference, postprocessing, RDE — and compare
outputs with the IoU-matched tolerance comparator. The reference
downloads a golden test package; this harness is hermetic: it generates a
synthetic test package (images, videos, a random-weight converted
checkpoint) so it runs in air-gapped CI, and uses run-vs-run consistency
(batch-size invariance, single-vs-batch equality) as the correctness
oracle. Point [options.model_file] at a real converted checkpoint and
[options.expected_results_file] at a golden file for true golden testing.

Differences from the JAX harness, on purpose:
- the detectors run on the card unless options.force_cpu is set (the JAX
  harness defaults to the CPU; the port's entry points default to the
  card);
- the CLI tier's export -> batch-from-artifact comparison requires
  identical detections: the port's artifact runs the live detector's ATen
  ops and kernels (the JAX one allows a tolerance, because XLA on the CPU
  compiles the deserialized program anew);
- known model names resolve only to converted checkpoints already on disk
  (models/registry.find_converted_checkpoint); nothing downloads a model.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np


class MDTestOptions:
    """Options controlling run_tests()."""

    def __init__(self):
        # Use this model instead of the synthetic one (a converted .npz)
        self.model_file = None
        # Golden results to compare the folder run against (optional)
        self.expected_results_file = None
        self.max_conf_error = 0.005
        self.max_coord_error = 0.001
        self.iou_match_threshold = 0.85
        self.scratch_dir = None
        self.canvas_size = 96
        self.cli_working_dir = None
        self.skip_video_tests = False
        self.skip_tiled_tests = False
        # CLI tier: drive the module CLIs as subprocesses and require
        # byte-identical detections vs the Python-API run (the
        # reference's run_cli_tests, md_tests.py:1116). Slow (each
        # subprocess pays the torch import and its own kernel-library
        # load).
        self.skip_cli_tests = True
        # Run the detectors on the CPU (default: the card)
        self.force_cpu = False
        self.verbose = True


def _build_test_package(options):
    """Synthetic test package: images, videos, and a tiny checkpoint."""

    from PIL import Image
    from megadetector_tpu_torch.models import yolov5
    from megadetector_tpu_torch.models.convert_weights import save_checkpoint

    scratch = options.scratch_dir or tempfile.mkdtemp(
        prefix='md_torch_tests_')
    os.makedirs(scratch, exist_ok=True)
    image_dir = os.path.join(scratch, 'images')
    rng = np.random.RandomState(0)

    for i, (w, h) in enumerate([(160, 120), (120, 160), (96, 96),
                                (200, 80)]):
        p = os.path.join(image_dir, 'cam{}'.format(i % 2),
                         'img_{:02d}.jpg'.format(i))
        os.makedirs(os.path.dirname(p), exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (h, w, 3),
                                    dtype=np.uint8)).save(p)
    with open(os.path.join(image_dir, 'corrupt.jpg'), 'wb') as f:
        f.write(b'not a jpeg')

    video_dir = os.path.join(scratch, 'videos')
    os.makedirs(video_dir, exist_ok=True)
    try:
        import cv2
        out = cv2.VideoWriter(
            os.path.join(video_dir, 'v.mp4'),
            cv2.VideoWriter_fourcc(*'mp4v'), 5.0, (96, 64))
        for _ in range(10):
            out.write(rng.randint(0, 255, (64, 96, 3), dtype=np.uint8))
        out.release()
    except Exception:
        options.skip_video_tests = True

    model_file = options.model_file
    if model_file is None:
        cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
        params = yolov5.init_params(cfg, seed=7)
        model_file = os.path.join(scratch, 'md_test.npz')
        save_checkpoint(params, model_file, {
            'model_version_string': 'v5a.0.1', 'arch': 'yolov5n',
            'model_type': 'yolov5', 'num_classes': 3,
            'class_names': ['animal', 'person', 'vehicle'],
            'image_size': options.canvas_size,
            'anchors': cfg.anchors.tolist()})

    return scratch, image_dir, video_dir, model_file


#: The reference's hosted test package; downloads activate when egress
#: exists (reference: md_tests.py:83)
TEST_DATA_URL = 'https://lila.science/public/md-test-package.zip'


def download_test_data(options=None):
    """
    Stage the test-data package into options.scratch_dir (reference:
    md_tests.py:221-316): download + unzip TEST_DATA_URL when the
    hosted package is reachable, else fall back to the hermetic
    synthetic package builder (the zero-egress default in this
    framework). options.test_data_url replaces the hosted URL (a file://
    URL or a local server's). A known model name resolves only to a
    converted checkpoint already on disk. Returns (scratch, image_dir,
    video_dir, model_file).
    """

    import zipfile

    if options is None:
        options = MDTestOptions()

    test_data_url = getattr(options, 'test_data_url', TEST_DATA_URL)
    if options.scratch_dir is not None:
        zip_path = os.path.join(options.scratch_dir,
                                test_data_url.split('/')[-1])
        try:
            if not os.path.isfile(zip_path):
                from megadetector_tpu_torch.utils.url_utils import \
                    download_url
                download_url(test_data_url, zip_path)
            with zipfile.ZipFile(zip_path) as zf:
                zf.extractall(options.scratch_dir)
            print('Staged test package from {}'.format(test_data_url))

            # Use the hosted package's own folders: any extracted
            # directory containing images/videos becomes the test set
            from megadetector_tpu_torch.utils.path_utils import find_images
            scratch = options.scratch_dir
            image_dir = None
            video_dir = None
            for entry in sorted(os.listdir(scratch)):
                p = os.path.join(scratch, entry)
                if not os.path.isdir(p):
                    continue
                if image_dir is None and len(find_images(
                        p, recursive=True)) > 0:
                    image_dir = p
                if video_dir is None and any(
                        f.lower().endswith(('.mp4', '.avi', '.mov'))
                        for _, _, files in os.walk(p) for f in files):
                    video_dir = p
            if image_dir is not None:
                model_file = options.model_file
                if model_file is None:
                    # The hosted package carries expected-results files
                    # but no model; a converted checkpoint on disk
                    # supplies it
                    from megadetector_tpu_torch.detection.run_detector \
                        import resolve_model_file
                    model_file = resolve_model_file('MDV5A')
                if video_dir is None:
                    options.skip_video_tests = True
                return scratch, image_dir, video_dir, model_file
            print('Extracted package contains no images; building the '
                  'synthetic package')
        except Exception as e:
            print('Hosted test package unavailable ({}); building the '
                  'synthetic package'.format(e))

    return _build_test_package(options)


def get_expected_results_filename(gpu_is_available,
                                  model_string='mdv5a',
                                  test_type='image', augment=False,
                                  options=None):
    """
    Expected-results filename for the current inference environment
    (reference: md_tests.py:155-219): keyed by GPU availability and
    torch major.minor.
    """

    import torch

    hw_string = 'gpu' if gpu_is_available else 'cpu'
    torch_version = '.'.join(torch.__version__.split('+')[0].split('.')[:2])
    backend_string = 'pt{}'.format(torch_version)

    aug_string = 'augment-' if augment else ''
    if test_type == 'image':
        fn = '{}-{}{}-{}-{}.json'.format(model_string, aug_string,
                                         test_type, hw_string,
                                         backend_string)
    else:
        fn = '{}-{}.json'.format(model_string, test_type)

    if options is not None and options.scratch_dir is not None:
        fn = os.path.join(options.scratch_dir, fn)
    return fn


def run_download_tests(options=None):
    """
    Test the known models (reference: md_tests.py:1604-1694): every known
    model resolves by canonical version to a converted checkpoint on disk
    (the port downloads nothing), and the file's sniffed version matches;
    every short name maps to a known model. Models with no checkpoint on
    disk are reported as skipped rather than failed. Returns
    {model: 'ok'|'skipped: ...'}.
    """

    from megadetector_tpu_torch.models.registry import (
        find_converted_checkpoint, get_detector_version_from_model_file,
        known_models, model_string_to_model_version)

    if options is None:
        options = MDTestOptions()

    status = {}
    for model_name in known_models:
        try:
            fn = find_converted_checkpoint(model_name)
            assert fn is not None and os.path.exists(fn), \
                'no converted checkpoint on disk'

            version_string = get_detector_version_from_model_file(fn)
            assert version_string.replace('.0.1', '.0.0') == \
                model_name.replace('.0.1', '.0.0')
            status[model_name] = 'ok'
        except Exception as e:
            status[model_name] = 'skipped: {}'.format(e)

    for short_name in model_string_to_model_version:
        assert model_string_to_model_version[short_name] in \
            known_models
    return status


def run_python_tests(options=None):
    """
    The Python-API test tiers (reference: md_tests.py:788-1111) —
    run_tests() without the CLI tier.
    """

    if options is None:
        options = MDTestOptions()
    options.skip_cli_tests = True
    return run_tests(options)


def run_tests(options=None):
    """
    Run the integration tiers. Raises AssertionError on the first
    failure; returns a dict of per-tier status on success.
    """

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import (
        load_and_run_detector_batch, write_results_to_file)
    from megadetector_tpu_torch.postprocessing.validate_batch_results import (
        ValidateBatchResultsOptions, validate_batch_results)
    from megadetector_tpu_torch.utils import md_tests as comparator
    from megadetector_tpu_torch.utils.path_utils import find_images
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image

    if options is None:
        options = MDTestOptions()

    status = {}
    scratch, image_dir, video_dir, model_file = \
        _build_test_package(options)
    detector_options = {'force_cpu': 'true'} if options.force_cpu else {}

    def log(msg):
        if options.verbose:
            print('[md-tests] ' + msg)

    # --- Tier 1: single image vs batch consistency. With
    # pad_batches_to, the single-image call pads to the same program as
    # the batch call, so results must match EXACTLY (with a
    # real model they also match across programs within tolerance; with
    # random weights, thousands of near-tied scores churn at the max_det
    # boundary between different batch programs, so program identity is
    # the right oracle here).
    tier1_options = dict(detector_options)
    tier1_options['pad_batches_to'] = 2
    detector = load_detector(model_file, detector_options=tier1_options)
    images = find_images(image_dir, recursive=True)
    good_images = [fn for fn in images if 'corrupt' not in fn]
    pil = load_image(good_images[0])
    single = detector.generate_detections_one_image(
        pil, good_images[0], detection_threshold=0.005)
    assert single['detections'] is not None
    batch = detector.generate_detections_one_batch(
        [load_image(fn) for fn in good_images[:2]], good_images[:2],
        detection_threshold=0.005)
    cmp_options = comparator.MDTestOptions()
    cmp_options.comparison_confidence_threshold = 0.1
    cmp_options.max_conf_error = options.max_conf_error
    cmp_options.max_coord_error = options.max_coord_error
    r = comparator.compare_detection_lists(
        single['detections'], batch[0]['detections'], cmp_options,
        image_id=good_images[0])
    assert not r['errors'], \
        'single-vs-batch mismatch: {}'.format(r['errors'][:3])
    log('tier 1 (single vs batch) OK')
    status['single_image'] = 'ok'

    # --- Tier 2: folder runs at two batch sizes must agree
    results_b2 = load_and_run_detector_batch(
        model_file, list(images), quiet=True, batch_size=2,
        detector_options=dict(detector_options))
    results_b4 = load_and_run_detector_batch(
        model_file, list(images), quiet=True, batch_size=4,
        detector_options=dict(detector_options))
    out_b2 = os.path.join(scratch, 'results_b2.json')
    out_b4 = os.path.join(scratch, 'results_b4.json')
    write_results_to_file(results_b2, out_b2,
                          relative_path_base=image_dir,
                          detector_file=model_file)
    write_results_to_file(results_b4, out_b4,
                          relative_path_base=image_dir,
                          detector_file=model_file)
    # Different batch sizes run different programs whose conv
    # reductions may differ in the last float bits; with a real model this is
    # far inside the tolerances, with random weights near-tied scores
    # churn at the max_det cut — so require a high match fraction rather
    # than exactness
    r = comparator.compare_results(out_b2, out_b4, cmp_options)
    n_matched = sum(len(im.get('detections') or [])
                    for im in results_b2 if im.get('detections'))
    assert len(r['errors']) <= max(3, n_matched // 10), \
        'batch-size variance: {} errors (sample: {})'.format(
            len(r['errors']), r['errors'][:3])
    v_options = ValidateBatchResultsOptions()
    v_options.raise_errors = True
    validate_batch_results(out_b2, v_options)
    log('tier 2 (batch-size invariance + format) OK')
    status['batch_folder'] = 'ok'

    # --- Optional golden comparison
    if options.expected_results_file is not None:
        r = comparator.compare_results(options.expected_results_file,
                                       out_b2, cmp_options)
        assert not r['errors'], \
            'golden mismatch: {}'.format(r['errors'][:5])
        log('golden comparison OK')
        status['golden'] = 'ok'

    # --- Tier 3: augmented inference runs and yields valid output
    augmented = detector.generate_detections_one_image(
        pil, good_images[0], detection_threshold=0.1, augment=True)
    assert augmented['detections'] is not None
    log('tier 3 (augmented) OK')
    status['augmented'] = 'ok'

    # --- Tier 4: video
    if not options.skip_video_tests:
        from megadetector_tpu_torch.detection.process_video import (
            ProcessVideoOptions, process_videos)
        v_opts = ProcessVideoOptions()
        v_opts.model_file = model_file
        v_opts.input_video_file = video_dir
        v_opts.output_json_file = os.path.join(scratch, 'videos.json')
        v_opts.frame_sample = 4
        v_opts.detector_options = dict(detector_options)
        process_videos(v_opts)
        with open(v_opts.output_json_file) as f:
            vd = json.load(f)
        assert vd['images'][0]['frames_processed'] == [0, 4, 8]
        log('tier 4 (video) OK')
        status['video'] = 'ok'

    # --- Tier 5: tiled inference
    if not options.skip_tiled_tests:
        from megadetector_tpu_torch.detection.run_tiled_inference import \
            run_tiled_inference
        run_tiled_inference(
            model_file, image_dir, os.path.join(scratch, 'tiles'),
            os.path.join(scratch, 'tiled.json'),
            tile_size_x=options.canvas_size,
            tile_size_y=options.canvas_size,
            detection_threshold=0.2,
            detector_options=dict(detector_options))
        log('tier 5 (tiled) OK')
        status['tiled'] = 'ok'

    # --- Tier 6: postprocessing + RDE on the folder results
    from megadetector_tpu_torch.postprocessing.postprocess_batch_results \
        import PostProcessingOptions, process_batch_results
    p_opts = PostProcessingOptions()
    p_opts.md_results_file = out_b2
    p_opts.output_dir = os.path.join(scratch, 'preview')
    p_opts.image_base_dir = image_dir
    p_opts.num_images_to_sample = 10
    p_opts.parallelize_rendering = False
    process_batch_results(p_opts)

    from megadetector_tpu_torch.postprocessing.repeat_detection_elimination \
        import repeat_detections_core as rde
    rde_options = rde.RepeatDetectionOptions()
    rde_options.bWriteFilteringFolder = False
    rde_options.nWorkers = 1
    rde.find_repeat_detections(
        out_b2, os.path.join(scratch, 'rde.json'), rde_options)
    log('tier 6 (postprocessing + RDE) OK')
    status['postprocessing'] = 'ok'

    # --- Tier 7: CLI tier — subprocess CLIs must produce detections
    # byte-identical to the API run (reference: md_tests.py:1116 +
    # output_files_are_identical :363-415)
    if not options.skip_cli_tests:
        status['cli'] = run_cli_tests(
            model_file, image_dir, scratch, verbose=options.verbose,
            video_dir=None if options.skip_video_tests else video_dir,
            force_cpu=options.force_cpu)
        log('tier 7 (CLI) OK')

    if options.scratch_dir is None:
        shutil.rmtree(scratch, ignore_errors=True)

    log('all tiers passed')
    return status


def _cli_env():
    """The environment of a CLI subprocess: this one's, with the folder
    that holds the package first on PYTHONPATH (so that -m finds it from
    any working directory)."""

    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env['PYTHONPATH'] = os.pathsep.join(
        [root] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    return env


def _run_cli(module, args, timeout=900, expect_rc=0):
    """Run one module CLI as a subprocess; returns CompletedProcess."""

    cmd = [sys.executable, '-m', 'megadetector_tpu_torch.' + module] + \
        [str(a) for a in args]
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=timeout, env=_cli_env())
    assert r.returncode == expect_rc, \
        '{} CLI failed (rc {}):\n{}'.format(
            module, r.returncode, (r.stderr or r.stdout)[-3000:])
    return r


def run_cli_tests(model_file, image_dir, scratch,
                  api_results_file=None, verbose=True,
                  video_dir=None, force_cpu=False):
    """
    Drive EVERY console script ([project.scripts] in pyproject.toml) as
    a subprocess end-to-end (the reference's run_cli_tests contract,
    md_tests.py:1116-1604): batch (+checkpoint resume), single-image
    render, video, frame extraction, validation, subset, crops, mAP
    evaluation, AOT export -> batch-from-artifact exact match, the
    serving daemon round trip via the client, and the weight-validation
    gate. Detection outputs are compared with
    output_files_are_identical semantics where determinism allows. The
    CLIs run on the card, or on the CPU with [force_cpu].
    Returns 'ok' or raises.
    """

    from megadetector_tpu_torch.utils.md_tests import \
        output_files_are_identical

    # The detector options every detector CLI takes
    cpu_options = ['force_cpu=true'] if force_cpu else []

    def log(msg):
        if verbose:
            print('[md-tests] CLI tier: ' + msg)

    # --- md-run-detector-batch (the workhorse; capacity pinned so the
    # AOT comparison below runs the identical program)
    cli_out = os.path.join(scratch, 'results_cli.json')
    # Options are pinned (no escalation, one square canvas) so every
    # identity comparison below runs the exact same program
    batch_args = [model_file, image_dir, cli_out,
                  '--recursive', '--output_relative_filenames',
                  '--batch_size', '2', '--detector_options'] + \
        cpu_options + ['auto_escalate_topk=false', 'canvas_mode=square']
    _run_cli('detection.run_detector_batch', batch_args)
    log('run-detector-batch OK')

    # --- md-validate-results
    _run_cli('postprocessing.validate_batch_results', [cli_out])
    log('validate-results OK')

    if api_results_file is None:
        # Self-contained API reference run with the SAME pinned options
        # as the CLI run; the CLI must be byte-identical to it
        from megadetector_tpu_torch.detection.run_detector_batch import (
            load_and_run_detector_batch, write_results_to_file)
        from megadetector_tpu_torch.utils.path_utils import find_images
        api_results = load_and_run_detector_batch(
            model_file, find_images(image_dir, recursive=True),
            quiet=True, batch_size=2,
            detector_options={'force_cpu': force_cpu,
                              'auto_escalate_topk': False,
                              'canvas_mode': 'square'})
        api_results_file = os.path.join(scratch, 'results_api_ref.json')
        write_results_to_file(api_results, api_results_file,
                              relative_path_base=image_dir,
                              detector_file=model_file)
    with open(api_results_file) as f:
        api = json.load(f)
    with open(cli_out) as f:
        cli = json.load(f)
    # Identity modulo the info block (completion timestamps differ)
    assert api['images'] == cli['images'], \
        'CLI detections differ from the API run'
    assert api['detection_categories'] == cli['detection_categories']
    log('CLI-vs-API identity OK')

    # --- checkpoint-resume: craft a partial checkpoint from the full
    # run, resume from it, and require the resumed output to be
    # identical to the straight-through run (reference: md_tests
    # checkpoint tier)
    with open(cli_out) as f:
        full = json.load(f)
    if len(full['images']) >= 2:
        checkpoint_file = os.path.join(scratch, 'partial_checkpoint.json')
        # Checkpoint records carry the ENUMERATED (absolute) path form;
        # the results file was written with relative filenames
        partial_records = []
        for im in full['images'][:2]:
            rec = dict(im)
            rec['file'] = os.path.join(image_dir, im['file'])
            partial_records.append(rec)
        partial = {'checkpoint': partial_records}
        with open(checkpoint_file, 'w') as f:
            json.dump(partial, f)
        resumed_out = os.path.join(scratch, 'results_resumed.json')
        r = _run_cli('detection.run_detector_batch',
                     [model_file, image_dir, resumed_out,
                      '--recursive', '--output_relative_filenames',
                      '--batch_size', '2',
                      '--resume_from_checkpoint', checkpoint_file,
                      '--detector_options'] + cpu_options +
                     ['auto_escalate_topk=false', 'canvas_mode=square'])
        assert 'Bypassing' in r.stdout + r.stderr, \
            'resume did not report bypassed images'
        assert output_files_are_identical(cli_out, resumed_out), \
            'resumed results differ from the straight-through run'
        log('checkpoint resume OK')

    # --- md-run-detector (single-image render CLI)
    from megadetector_tpu_torch.utils.path_utils import find_images
    good_images = [fn for fn in find_images(image_dir, recursive=True)
                   if 'corrupt' not in fn]
    render_dir = os.path.join(scratch, 'cli_render')
    _run_cli('detection.run_detector',
             [model_file, '--image_file', good_images[0],
              '--output_dir', render_dir, '--detector_options'] +
             cpu_options)
    assert os.path.isdir(render_dir) and os.listdir(render_dir)
    log('run-detector OK')

    # --- md-process-video + md-extract-frames
    if video_dir is not None and os.path.isdir(video_dir):
        video_out = os.path.join(scratch, 'videos_cli.json')
        _run_cli('detection.process_video',
                 [model_file, video_dir, '--output_json_file', video_out,
                  '--frame_sample', '4', '--detector_options'] +
                 cpu_options)
        with open(video_out) as f:
            vd = json.load(f)
        assert len(vd['images']) > 0
        log('process-video OK')

        frames_dir = os.path.join(scratch, 'frames_cli')
        _run_cli('utils.extract_frames_from_video',
                 [video_dir, frames_dir, '--frame_sample', '4'])
        assert os.path.isdir(frames_dir)
        log('extract-frames OK')

    # --- subset CLI round trip
    subset_out = os.path.join(scratch, 'subset_cli.json')
    _run_cli('postprocessing.subset_json_detector_output',
             [cli_out, subset_out, '--confidence_threshold', '0.5'])
    log('subset OK')

    # --- md-crop-detections
    crops_dir = os.path.join(scratch, 'crops_cli')
    _run_cli('classification.crop_detections',
             [cli_out, crops_dir, '--images_dir', image_dir,
              '--threshold', '0.3'])
    log('crop-detections OK')

    # --- md-evaluate-detections: GT synthesized from the results
    # themselves must score a perfect mAP@0.5
    gt_file = os.path.join(scratch, 'gt_cli.json')
    categories = sorted(set(
        d['category'] for im in full['images']
        for d in (im.get('detections') or [])))
    gt = {'images': [], 'annotations': [], 'categories': [
        {'id': int(c), 'name': full['detection_categories'][c]}
        for c in categories]}
    for im in full['images']:
        if im.get('detections') is None:
            continue
        gt['images'].append({'id': im['file'], 'file_name': im['file']})
        for d in im['detections']:
            if d['conf'] < 0.5 or d['bbox'][2] <= 0 or \
                    d['bbox'][3] <= 0:
                continue
            gt['annotations'].append({
                'id': len(gt['annotations']), 'image_id': im['file'],
                'category_id': int(d['category']), 'bbox': d['bbox']})
    with open(gt_file, 'w') as f:
        json.dump(gt, f)
    eval_out = os.path.join(scratch, 'map_cli.json')
    _run_cli('postprocessing.evaluate_detections',
             [cli_out, gt_file, '--min_confidence', '0.5',
              '--output_file', eval_out])
    with open(eval_out) as f:
        metrics = json.load(f)
    assert metrics['mAP'] is None or metrics['mAP'] >= 0.99, metrics
    log('evaluate-detections OK (mAP {})'.format(metrics['mAP']))

    # --- md-validate-weights (fast stages)
    gate_out = os.path.join(scratch, 'gate_cli.json')
    _run_cli('utils.validate_weights',
             [model_file, '--image_dir', image_dir, '--skip_int8',
              '--skip_export', '--scratch_dir',
              os.path.join(scratch, 'gate_scratch'),
              '--output_file', gate_out] +
             (['--force_cpu'] if force_cpu else []))
    with open(gate_out) as f:
        assert json.load(f)['status'] == 'ok'
    log('validate-weights OK')

    # --- md-convert-weights: requires a torch-format checkpoint; build
    # one from the repo's torch mirror when importable (dev checkouts),
    # otherwise record the stage as skipped
    convert_status = 'ok'
    try:
        import torch  # noqa: F401
        repo_tests = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), 'tests')
        build_script = (
            "import sys, torch\n"
            "sys.path.insert(0, {tests!r})\n"
            "from megadetector_tpu_torch.models.yolov5 import YoloV5Config\n"
            "from torch_yolo_ref import make_torch_model\n"
            "m = make_torch_model(YoloV5Config('yolov5n', num_classes=3),"
            " seed=3)\n"
            "m.names = ['animal', 'person', 'vehicle']\n"
            "torch.save({{'model': m}}, {out!r})\n").format(
                tests=repo_tests,
                out=os.path.join(scratch, 'cli_convert.pt'))
        r = subprocess.run([sys.executable, '-c', build_script],
                           capture_output=True, text=True, timeout=300,
                           env=_cli_env())
        if r.returncode != 0:
            raise RuntimeError(r.stderr[-500:])
        converted = os.path.join(scratch, 'cli_converted.npz')
        _run_cli('models.convert_weights',
                 [os.path.join(scratch, 'cli_convert.pt'), converted,
                  '--arch', 'yolov5n', '--model_version', 'v5a.0.1'])
        assert os.path.isfile(converted)
        log('convert-weights OK')
    except Exception as e:
        convert_status = 'skipped: {}'.format(e)
        log('convert-weights skipped ({})'.format(e))

    # --- md-convert-speciesnet: synthetic release bundle (weights +
    # labels.txt + taxonomy + geofence) -> dry run -> full conversion
    try:
        import torch  # noqa: F401
        repo_tests = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), 'tests')
        bundle = os.path.join(scratch, 'sn_bundle')
        os.makedirs(bundle, exist_ok=True)
        labels = [
            'aaaa0001-0000-0000-0000-000000000001;mammalia;rodentia;'
            'muridae;mus;musculus;house mouse',
            'f1856211-cfb7-4a5b-9158-c0f72fd09ee6;;;;;;blank',
        ]
        build_script = (
            "import sys, json, torch\n"
            "sys.path.insert(0, {tests!r})\n"
            "from torch_effnet_ref import make_torch_effnet\n"
            "m = make_torch_effnet('efficientnetv2_test',"
            " num_classes=2, seed=0)\n"
            "torch.save(m.state_dict(), {w!r})\n").format(
                tests=repo_tests,
                w=os.path.join(bundle, 'always_crop.pt'))
        r = subprocess.run([sys.executable, '-c', build_script],
                           capture_output=True, text=True, timeout=300,
                           env=_cli_env())
        if r.returncode != 0:
            raise RuntimeError(r.stderr[-500:])
        with open(os.path.join(bundle, 'labels.txt'), 'w') as f:
            f.write('\n'.join(labels) + '\n')
        with open(os.path.join(bundle, 'taxonomy_release.txt'),
                  'w') as f:
            f.write('\n'.join(labels) + '\n')
        with open(os.path.join(bundle, 'geofence_base.json'),
                  'w') as f:
            json.dump({labels[0]: {'allow': {'USA': []}}}, f)
        _run_cli('models.convert_speciesnet', [bundle, '--dry_run'])
        sn_out = os.path.join(scratch, 'sn_converted')
        _run_cli('models.convert_speciesnet',
                 [bundle, sn_out, '--arch', 'efficientnetv2_test',
                  '--image_size', '64'])
        assert os.path.isfile(os.path.join(sn_out, 'classifier.npz'))
        assert os.path.isfile(os.path.join(sn_out, 'geofence.json'))
        log('convert-speciesnet OK')
    except Exception as e:
        log('convert-speciesnet skipped ({})'.format(e))

    # --- md-export-detector -> batch from the artifact -> identity: the
    # artifact runs the live detector's ops and kernels, so its results
    # must be the checkpoint run's, detection for detection
    artifact = os.path.join(scratch, 'cli_model.mdpkg')
    _run_cli('detection.export_detector',
             [model_file, artifact, '--batch_sizes', '2',
              '--aspects', '1:1', '--detector_options'] + cpu_options +
             ['canvas_mode=square'])
    aot_out = os.path.join(scratch, 'results_aot_cli.json')
    _run_cli('detection.run_detector_batch',
             [artifact, image_dir, aot_out,
              '--recursive', '--output_relative_filenames',
              '--batch_size', '2', '--detector_options'] + cpu_options +
             ['auto_escalate_topk=false'])
    with open(aot_out) as f:
        aot = json.load(f)
    assert aot['images'] == cli['images'], \
        'exported artifact results differ from the checkpoint run'
    log('export-detector + batch-from-artifact identity OK')

    # --- md-serve + md-serve-client round trip (folder -> MD results)
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    serve_out = os.path.join(scratch, 'results_serve_cli.json')
    server = subprocess.Popen(
        [sys.executable, '-m', 'megadetector_tpu_torch.serving.server',
         model_file, '--port', str(port), '--max_batch_size', '2'] +
        (['--force_cpu'] if force_cpu else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_cli_env())
    try:
        import time
        import urllib.request
        deadline = time.time() + 300
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(
                        'http://127.0.0.1:{}/healthz'.format(port),
                        timeout=2):
                    break
            except Exception:
                if server.poll() is not None:
                    raise RuntimeError(
                        'md-serve exited early:\n{}'.format(
                            server.stdout.read()[-2000:]))
                time.sleep(1.0)
        else:
            raise RuntimeError('md-serve never became healthy')
        _run_cli('serving.client',
                 ['http://127.0.0.1:{}'.format(port), image_dir,
                  '--output_file', serve_out])
        with open(serve_out) as f:
            served = json.load(f)
        assert len(served['images']) == len(full['images'])
    finally:
        server.terminate()
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
    log('serve + serve-client round trip OK')

    if verbose:
        print('[md-tests] CLI tier: all console scripts OK '
              '(convert: {})'.format(convert_status))
    return 'ok'


def main():
    import argparse
    parser = argparse.ArgumentParser(
        description='Run the integration test tiers')
    parser.add_argument('--model_file', default=None,
                        help='converted .npz checkpoint (default: '
                             'synthetic random-weight model)')
    parser.add_argument('--expected_results_file', default=None)
    parser.add_argument('--scratch_dir', default=None)
    parser.add_argument('--skip_video_tests', action='store_true')
    parser.add_argument('--run_cli_tests', action='store_true',
                        help='also drive the module CLIs as '
                             'subprocesses (slow)')
    parser.add_argument('--force_cpu', action='store_true',
                        help='run the detectors on the CPU (default: the '
                             'card)')
    args = parser.parse_args()

    options = MDTestOptions()
    options.model_file = args.model_file
    options.expected_results_file = args.expected_results_file
    options.scratch_dir = args.scratch_dir
    options.skip_video_tests = args.skip_video_tests
    options.skip_cli_tests = not args.run_cli_tests
    options.force_cpu = args.force_cpu
    status = run_tests(options)
    print(json.dumps(status))
    sys.exit(0)


if __name__ == '__main__':
    main()
