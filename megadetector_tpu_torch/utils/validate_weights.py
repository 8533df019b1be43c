"""
One-command real-weight validation gate (the port's counterpart of
megadetector_tpu/utils/validate_weights.py): the moment real
MegaDetector weights become available,

    python -m megadetector_tpu_torch.utils.validate_weights ckpt

runs the acceptance chain on the port's batch driver and detector, on the
card (force_cpu runs it on the CPU) — conversion, golden
generation/comparison, int8-chain drift bounds, candidate-capacity
sufficiency and the exported artifact — so parity is a button, not a
week of ad-hoc scripts.

Stages (each reported, any failure fails the gate):

1. convert   — torch .pt checkpoints convert to .npz (already-converted
               .npz inputs pass through); metadata sanity-checked.
2. golden    — run the detector over a deterministic image set and write
               a stored-golden results file; when
               [expected_results_file] is given, compare against it with
               the reference comparator at conf 0.005 / coord 0.001 /
               IoU 0.85 (the reference contract:
               megadetector/utils/md_tests.py:418-649).
3. int8      — quantize the chain, re-run, and bound the anchor-aligned
               float-vs-int8 drift (p99 score / p99 coord), validating
               int8 deployment accuracy on the real score distribution.
4. capacity  — scan above-floor candidate counts at the 0.005 floor and
               report whether pre_nms_topk=512 suffices (and what the
               escalation ladder must cover).
5. export    — export the checkpoint as the port's artifact
               (detection/export_detector: batch sizes 1 and 4, aspects
               4:3, 3:4 and 16:9, capacities 512 and 2048), run it
               against the live detector on three images (escalation off
               on both sides) requiring identical detections, and require
               a one-byte tamper of its programs to be refused
               (ValueError).

Dry-run mode (--dry_run) exercises every stage on a synthetic
random-weight checkpoint on the CPU, proving the gate end-to-end in
zero-egress CI.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


class ValidateWeightsOptions:
    """Options controlling validate_weights()."""

    def __init__(self):
        self.checkpoint = None
        #: Reference-produced golden results for the same image set
        self.expected_results_file = None
        #: Folder of validation images (default: deterministic
        #: synthetic set, so runs are reproducible without data)
        self.image_dir = None
        self.scratch_dir = None
        self.arch = None
        self.model_version = None
        self.image_size = None
        #: Comparator tolerances (the reference golden contract)
        self.max_conf_error = 0.005
        self.max_coord_error = 0.001
        self.iou_match_threshold = 0.85
        #: int8 drift bounds (anchor-aligned vs float), hardware-derived
        #: defaults from the round-3 drift study (NEXT.md)
        self.int8_p99_score_drift = 0.02
        self.int8_p99_coord_drift_px = 2.0
        #: Capacity scan floor
        self.candidate_floor = 0.005
        self.skip_int8 = False
        self.skip_export = False
        self.force_cpu = False
        self.verbose = True


def _log(options, msg):
    if options.verbose:
        print('[validate-weights] ' + msg, flush=True)


def _build_image_set(scratch, seed=11, n=6):
    """Deterministic synthetic validation images (mixed aspects)."""

    from PIL import Image
    image_dir = os.path.join(scratch, 'validation_images')
    os.makedirs(image_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    sizes = [(640, 480), (480, 640), (512, 512), (1024, 768),
             (320, 180), (800, 600)]
    for i, (w, h) in enumerate(sizes[:n]):
        Image.fromarray(rng.randint(0, 255, (h, w, 3),
                                    dtype=np.uint8)).save(
            os.path.join(image_dir, 'val_{:02d}.jpg'.format(i)))
    return image_dir


def _stage_convert(options, scratch, report):
    from megadetector_tpu_torch.models import convert_weights

    checkpoint = options.checkpoint
    if checkpoint.endswith('.npz'):
        report['convert'] = {'status': 'ok', 'note': 'already converted'}
        return checkpoint

    converted = os.path.join(scratch, 'converted.npz')
    convert_weights.convert_megadetector_checkpoint(
        checkpoint, converted, arch=options.arch,
        model_version=options.model_version)
    report['convert'] = {'status': 'ok', 'output': converted}
    return converted


def _detector_options(options, extra=None):
    detector_options = dict(extra or {})
    if options.force_cpu:
        detector_options['force_cpu'] = True
    if options.image_size:
        detector_options['image_size'] = int(options.image_size)
    return detector_options


def _run_batch(model_file, image_dir, out_file, options, extra=None):
    from megadetector_tpu_torch.detection.run_detector_batch import (
        load_and_run_detector_batch, write_results_to_file)
    from megadetector_tpu_torch.utils.path_utils import find_images

    images = find_images(image_dir, recursive=True)
    results = load_and_run_detector_batch(
        model_file, images, quiet=True, batch_size=4,
        confidence_threshold=0.005,
        detector_options=_detector_options(options, extra))
    write_results_to_file(results, out_file,
                          relative_path_base=image_dir,
                          detector_file=model_file)
    return results


def _stage_golden(options, scratch, model_file, image_dir, report):
    from megadetector_tpu_torch.utils import md_tests as comparator

    golden_out = os.path.join(scratch, 'golden_results.json')
    _run_batch(model_file, image_dir, golden_out, options)
    stage = {'status': 'ok', 'golden_file': golden_out}

    if options.expected_results_file:
        cmp_options = comparator.MDTestOptions()
        cmp_options.max_conf_error = options.max_conf_error
        cmp_options.max_coord_error = options.max_coord_error
        cmp_options.iou_match_threshold = options.iou_match_threshold
        r = comparator.compare_results(
            options.expected_results_file, golden_out, cmp_options)
        stage['n_comparison_errors'] = len(r['errors'])
        if r['errors']:
            stage['status'] = 'FAILED'
            stage['errors'] = r['errors'][:10]
    else:
        stage['note'] = ('no expected_results_file; golden written for '
                         'future comparisons')
    report['golden'] = stage
    return golden_out


def _match_drift(float_results, int8_results, iou_threshold=0.5):
    """Anchor-aligned drift: greedily best-IoU match each float
    detection to an int8 detection of the same category; returns
    (score_drifts, coord_drifts_normalized, n_unmatched). Boxes that
    truncation to 4 digits left with no width or height match only a
    box equal to them (md_tests' IoU), where JAX's matcher raises."""

    from megadetector_tpu_torch.utils.md_tests import _safe_iou

    by_file = {im['file']: im for im in int8_results}
    score_drifts = []
    coord_drifts = []
    unmatched = 0
    for im in float_results:
        dets_f = [d for d in (im.get('detections') or [])
                  if d['conf'] >= 0.1]
        other = by_file.get(im['file'])
        dets_q = list((other or {}).get('detections') or [])
        used = set()
        for d in dets_f:
            best = None
            for j, dq in enumerate(dets_q):
                if j in used or dq['category'] != d['category']:
                    continue
                iou = _safe_iou(d['bbox'], dq['bbox'])
                if iou >= iou_threshold and \
                        (best is None or iou > best[1]):
                    best = (j, iou)
            if best is None:
                unmatched += 1
                continue
            used.add(best[0])
            dq = dets_q[best[0]]
            score_drifts.append(abs(d['conf'] - dq['conf']))
            coord_drifts.extend(
                abs(a - b) for a, b in zip(d['bbox'], dq['bbox']))
    return score_drifts, coord_drifts, unmatched


def _stage_int8(options, scratch, model_file, image_dir, float_results,
                report):
    from megadetector_tpu_torch.models.convert_weights import \
        quantize_checkpoint

    int8_model = os.path.join(scratch, 'validated.int8.npz')
    quantize_checkpoint(model_file, int8_model,
                        calibration_folder=image_dir, mode='chain',
                        device='cpu' if options.force_cpu else None)
    int8_out = os.path.join(scratch, 'int8_results.json')
    _run_batch(int8_model, image_dir, int8_out, options)
    with open(int8_out) as f:
        int8_results = json.load(f)['images']
    with open(float_results) as f:
        float_ims = json.load(f)['images']

    score_drifts, coord_drifts, unmatched = _match_drift(
        float_ims, int8_results)
    stage = {'status': 'ok', 'n_matched': len(score_drifts),
             'n_unmatched': unmatched}
    if score_drifts:
        p99_score = float(np.percentile(score_drifts, 99))
        stage['p99_score_drift'] = round(p99_score, 5)
        p99_coord = float(np.percentile(coord_drifts, 99))
        stage['p99_coord_drift_normalized'] = round(p99_coord, 6)
        if p99_score > options.int8_p99_score_drift:
            stage['status'] = 'FAILED'
            stage['reason'] = 'p99 score drift {} > bound {}'.format(
                p99_score, options.int8_p99_score_drift)
    else:
        stage['note'] = 'no matched detections above 0.1'
    report['int8'] = stage


def _stage_capacity(options, scratch, model_file, image_dir, report):
    """Count above-floor candidates per image through the detector's own
    counter: run with escalation ON and inspect truncation flags +
    the n_candidates the detector reports."""

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.utils.path_utils import find_images
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image

    # With escalation OFF at capacity 512, any image whose above-floor
    # candidate count exceeds 512 carries 'pre_nms_truncation' with the
    # TRUE count (models/detector.py floor contract) — exactly the scan
    # needed to size the production ladder
    detector = load_detector(
        model_file,
        detector_options=_detector_options(
            options, {'pre_nms_topk': 512,
                      'auto_escalate_topk': False}))
    max_needed = 0
    n_escalated = 0
    for fn in find_images(image_dir, recursive=True):
        try:
            pil = load_image(fn)
        except Exception:
            continue
        result = detector.generate_detections_one_image(
            pil, fn, detection_threshold=options.candidate_floor)
        n_cand = result.get('pre_nms_truncation',
                            len(result.get('detections') or []))
        max_needed = max(max_needed, int(n_cand))
        if int(n_cand) > 512:
            n_escalated += 1
    stage = {
        'status': 'ok',
        'max_candidates_at_floor': max_needed,
        'n_images_beyond_512': n_escalated,
        'topk_512_sufficient': max_needed <= 512,
    }
    if max_needed > 512:
        import math
        ladder_top = 2 ** math.ceil(math.log2(max_needed))
        stage['recommended_topk_ladder'] = [512, ladder_top]
        stage['note'] = ('export artifacts with --topk_ladder 512 {} '
                         'to preserve the 0.005-floor contract'
                         .format(ladder_top))
    report['capacity'] = stage


def _stage_export(options, scratch, model_file, image_dir, report):
    import zipfile

    from megadetector_tpu_torch.detection.export_detector import (
        MANIFEST_NAME, export_detector)
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.utils.path_utils import find_images
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image

    artifact = os.path.join(scratch, 'validated.mdpkg')
    export_detector(model_file, artifact, batch_sizes=[1, 4],
                    aspects=['4:3', '3:4', '16:9'],
                    topk_ladder=[512, 2048],
                    detector_options=_detector_options(options))

    # Live against artifact on the first three images. Escalation is
    # pinned off on both sides, so both run the 512-capacity program
    # (random-weight dry runs overflow the floor; escalation is the
    # capacity stage's); the artifact runs the live detector's ops and
    # kernels, so its detections must be identical
    live = load_detector(
        model_file,
        detector_options=_detector_options(
            options, {'auto_escalate_topk': False}))
    # The artifact bakes image_size in: only the options ExportedDetector
    # takes
    exported_options = {'auto_escalate_topk': False}
    if options.force_cpu:
        exported_options['force_cpu'] = True
    exported = load_detector(artifact, detector_options=exported_options)
    stage = {'status': 'ok', 'artifact': artifact,
             'artifact_mb': round(os.path.getsize(artifact) / 1e6, 3)}
    n_checked = 0
    for fn in find_images(image_dir, recursive=True)[:3]:
        pil = load_image(fn)
        a = live.generate_detections_one_image(
            pil, fn, detection_threshold=0.005)
        b = exported.generate_detections_one_image(
            pil, fn, detection_threshold=0.005)
        if a != b:
            stage['status'] = 'FAILED'
            stage['reason'] = 'artifact mismatch on {}: {} live against ' \
                '{} exported detections'.format(
                    fn, len(a.get('detections') or []),
                    len(b.get('detections') or []))
            break
        n_checked += 1
    stage['n_images_checked'] = n_checked

    # Tamper check: flipping one byte of every program must be refused
    tampered = os.path.join(scratch, 'tampered.mdpkg')
    with zipfile.ZipFile(artifact) as src, \
            zipfile.ZipFile(tampered, 'w') as dst:
        for name in src.namelist():
            blob = src.read(name)
            if name != MANIFEST_NAME and name.endswith('.pt2'):
                blob = blob[:-1] + bytes([blob[-1] ^ 0xFF])
            dst.writestr(name, blob)
    try:
        load_detector(tampered, detector_options=exported_options)
        stage['status'] = 'FAILED'
        stage['reason'] = 'tampered artifact loaded without error'
    except ValueError:
        stage['tamper_rejected'] = True
    report['export'] = stage


def validate_weights(options):
    """
    Run the gate. Returns the report dict; report['status'] is 'ok'
    only if every stage passed.
    """

    t_start = time.time()
    scratch = options.scratch_dir or tempfile.mkdtemp(
        prefix='md_validate_')
    os.makedirs(scratch, exist_ok=True)
    report = {'checkpoint': options.checkpoint}

    _log(options, 'stage 1/5: conversion')
    model_file = _stage_convert(options, scratch, report)

    image_dir = options.image_dir
    if image_dir is None:
        image_dir = _build_image_set(scratch)
        _log(options, 'using deterministic synthetic image set at '
             + image_dir)

    _log(options, 'stage 2/5: golden generation/comparison')
    golden_out = _stage_golden(options, scratch, model_file, image_dir,
                               report)

    if options.skip_int8:
        report['int8'] = {'status': 'skipped'}
    else:
        _log(options, 'stage 3/5: int8-chain drift bounds')
        _stage_int8(options, scratch, model_file, image_dir, golden_out,
                    report)

    _log(options, 'stage 4/5: candidate-capacity sufficiency')
    _stage_capacity(options, scratch, model_file, image_dir, report)

    if options.skip_export:
        report['export'] = {'status': 'skipped'}
    else:
        _log(options, 'stage 5/5: export + integrity')
        _stage_export(options, scratch, model_file, image_dir, report)

    failed = [k for k, v in report.items()
              if isinstance(v, dict) and v.get('status') == 'FAILED']
    report['status'] = 'FAILED' if failed else 'ok'
    report['failed_stages'] = failed
    report['elapsed_s'] = round(time.time() - t_start, 1)
    report['scratch_dir'] = scratch
    _log(options, 'gate {} in {}s{}'.format(
        report['status'], report['elapsed_s'],
        ' (failed: {})'.format(failed) if failed else ''))
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Validate a detector checkpoint end-to-end: '
                    'convert, golden, int8 drift, capacity scan, '
                    'exported-artifact integrity')
    parser.add_argument('checkpoint', nargs='?', default=None,
                        help='torch .pt or converted .npz checkpoint')
    parser.add_argument('--expected_results_file', default=None,
                        help='reference golden results for the same '
                             'image set (comparator at conf 0.005 / '
                             'coord 0.001 / IoU 0.85)')
    parser.add_argument('--image_dir', default=None,
                        help='validation images (default: deterministic '
                             'synthetic set)')
    parser.add_argument('--scratch_dir', default=None)
    parser.add_argument('--arch', default=None)
    parser.add_argument('--model_version', default=None)
    parser.add_argument('--image_size', type=int, default=None)
    parser.add_argument('--skip_int8', action='store_true')
    parser.add_argument('--skip_export', action='store_true')
    parser.add_argument('--force_cpu', action='store_true',
                        help='run on the CPU (default: the card)')
    parser.add_argument('--output_file', default=None,
                        help='write the JSON report here')
    parser.add_argument('--dry_run', action='store_true',
                        help='prove the gate on a synthetic '
                             'random-weight checkpoint (no real '
                             'weights needed)')
    args = parser.parse_args(argv)

    options = ValidateWeightsOptions()
    options.expected_results_file = args.expected_results_file
    options.image_dir = args.image_dir
    options.scratch_dir = args.scratch_dir
    options.arch = args.arch
    options.model_version = args.model_version
    options.image_size = args.image_size
    options.skip_int8 = args.skip_int8
    options.skip_export = args.skip_export
    options.force_cpu = args.force_cpu

    if args.dry_run:
        from megadetector_tpu_torch.models import yolov5
        from megadetector_tpu_torch.models.convert_weights import \
            save_checkpoint
        scratch = options.scratch_dir or tempfile.mkdtemp(
            prefix='md_validate_dry_')
        os.makedirs(scratch, exist_ok=True)
        options.scratch_dir = scratch
        cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
        params = yolov5.init_params(cfg, seed=5)
        stub = os.path.join(scratch, 'dryrun_stub.npz')
        save_checkpoint(params, stub, {
            'model_version_string': 'v5a.0.1', 'arch': 'yolov5n',
            'model_type': 'yolov5', 'num_classes': 3,
            'class_names': ['animal', 'person', 'vehicle'],
            'image_size': 160, 'anchors': cfg.anchors.tolist()})
        options.checkpoint = stub
        options.force_cpu = True
        # Random weights drift arbitrarily under int8; the dry run
        # proves the machinery, not the numerics
        options.int8_p99_score_drift = 1.0
    else:
        if args.checkpoint is None:
            parser.error('checkpoint is required (or use --dry_run)')
        options.checkpoint = args.checkpoint

    report = validate_weights(options)
    print(json.dumps(report, indent=1))
    if args.output_file:
        with open(args.output_file, 'w') as f:
            json.dump(report, f, indent=1)
    sys.exit(0 if report['status'] == 'ok' else 1)


if __name__ == '__main__':
    main()
