"""
Golden-file comparison harness: IoU-matched, tolerance-based comparison of
detection results, the framework's definition of cross-implementation
parity. The port's own copy of megadetector_tpu/utils/md_tests.py (same
names, tolerances and error strings).

Behavioral contract follows the reference test harness
(megadetector/utils/md_tests.py): detections are matched across files at
IoU >= 0.85 (:128), then confidences must agree within 0.005 and
coordinates within 0.001 (:90-97); unmatched above-threshold detections
are errors (compare_detection_lists :418-531, compare_results :534-649);
exact-identity comparison for runs that must match bit-for-bit (:363-415).
"""

import json

from megadetector_tpu_torch.utils import ct_utils


def _safe_iou(bb1, bb2):
    """
    IoU for MD xywh boxes that tolerates degenerate (zero-area) boxes:
    truncation to 4 digits can produce w/h == 0, and two identical
    degenerate boxes must still match (IoU 1.0).
    """

    a_degenerate = bb1[2] <= 0 or bb1[3] <= 0
    b_degenerate = bb2[2] <= 0 or bb2[3] <= 0
    if a_degenerate or b_degenerate:
        if max(abs(x - y) for x, y in zip(bb1, bb2)) < 1e-6:
            return 1.0
        return 0.0
    return ct_utils.get_iou(bb1, bb2)


class MDTestOptions:
    """Tolerances controlling compare_results()."""

    def __init__(self):
        # Detections with conf below this are ignored entirely
        self.comparison_confidence_threshold = 0.1
        # Two boxes are "the same detection" above this IoU
        self.iou_match_threshold = 0.85
        self.max_conf_error = 0.005
        self.max_coord_error = 0.001
        self.warning_mode = False


def compare_detection_lists(dets_a, dets_b, options=None, image_id=''):
    """
    Compare two detection lists with IoU matching.

    Returns a dict: {'matched': [(i_a, i_b)], 'unmatched_a', 'unmatched_b',
    'max_conf_error', 'max_coord_error', 'errors': [str]}.
    """

    if options is None:
        options = MDTestOptions()

    t = options.comparison_confidence_threshold
    a = [(i, d) for i, d in enumerate(dets_a or []) if d['conf'] >= t]
    b = [(i, d) for i, d in enumerate(dets_b or []) if d['conf'] >= t]

    matched = []
    used_b = set()
    max_conf_error = 0.0
    max_coord_error = 0.0
    errors = []

    for i_a, det_a in a:
        best = None
        best_iou = options.iou_match_threshold
        for i_b, det_b in b:
            if i_b in used_b:
                continue
            if det_b['category'] != det_a['category']:
                continue
            iou = _safe_iou(det_a['bbox'], det_b['bbox'])
            if iou >= best_iou:
                best_iou = iou
                best = (i_b, det_b)
        if best is None:
            errors.append(
                '{}: unmatched detection (cat {}, conf {:.3f})'.format(
                    image_id, det_a['category'], det_a['conf']))
            continue
        i_b, det_b = best
        used_b.add(i_b)
        matched.append((i_a, i_b))
        conf_error = abs(det_a['conf'] - det_b['conf'])
        coord_error = max(abs(x - y) for x, y in
                          zip(det_a['bbox'], det_b['bbox']))
        max_conf_error = max(max_conf_error, conf_error)
        max_coord_error = max(max_coord_error, coord_error)
        if conf_error > options.max_conf_error:
            errors.append('{}: conf error {:.4f}'.format(image_id,
                                                         conf_error))
        if coord_error > options.max_coord_error:
            errors.append('{}: coord error {:.4f}'.format(image_id,
                                                          coord_error))

    unmatched_b = [i_b for i_b, _ in b if i_b not in used_b]
    for i_b in unmatched_b:
        errors.append('{}: extra detection in B (cat {}, '
                      'conf {:.3f})'.format(
                          image_id, dets_b[i_b]['category'],
                          dets_b[i_b]['conf']))

    return {'matched': matched,
            'unmatched_a': [i_a for i_a, _ in a
                            if i_a not in [m[0] for m in matched]],
            'unmatched_b': unmatched_b,
            'max_conf_error': max_conf_error,
            'max_coord_error': max_coord_error,
            'errors': errors}


def compare_results(results_a, results_b, options=None):
    """
    Compare two MD results files (paths or dicts).

    Returns {'n_images_compared', 'max_conf_error', 'max_coord_error',
    'errors': [str]}. Empty 'errors' means parity within tolerance.
    """

    if options is None:
        options = MDTestOptions()

    if isinstance(results_a, str):
        with open(results_a) as f:
            results_a = json.load(f)
    if isinstance(results_b, str):
        with open(results_b) as f:
            results_b = json.load(f)

    images_a = {im['file']: im for im in results_a['images']}
    images_b = {im['file']: im for im in results_b['images']}

    errors = []
    only_a = set(images_a) - set(images_b)
    only_b = set(images_b) - set(images_a)
    for fn in sorted(only_a):
        errors.append('Image {} only in A'.format(fn))
    for fn in sorted(only_b):
        errors.append('Image {} only in B'.format(fn))

    max_conf_error = 0.0
    max_coord_error = 0.0
    n_compared = 0

    for fn in sorted(set(images_a) & set(images_b)):
        im_a = images_a[fn]
        im_b = images_b[fn]
        failure_a = im_a.get('detections') is None
        failure_b = im_b.get('detections') is None
        if failure_a != failure_b:
            errors.append('Image {}: failure mismatch'.format(fn))
            continue
        if failure_a:
            continue
        n_compared += 1
        r = compare_detection_lists(im_a['detections'],
                                    im_b['detections'],
                                    options, image_id=fn)
        errors.extend(r['errors'])
        max_conf_error = max(max_conf_error, r['max_conf_error'])
        max_coord_error = max(max_coord_error, r['max_coord_error'])

    return {'n_images_compared': n_compared,
            'max_conf_error': max_conf_error,
            'max_coord_error': max_coord_error,
            'errors': errors}


def output_files_are_identical(file_a, file_b,
                               ignore_fields=('detection_completion_time',)):
    """
    Exact-identity comparison of two results files, ignoring volatile info
    fields (reference: md_tests.py:363-415).
    """

    with open(file_a) as f:
        a = json.load(f)
    with open(file_b) as f:
        b = json.load(f)
    for d in (a, b):
        info = d.get('info', {})
        for field in ignore_fields:
            info.pop(field, None)
    return a == b


def main():
    """CLI: compare two MD results files at the golden tolerances
    (reference md_tests.py's comparison core as a standalone tool)."""

    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description='Compare two MD results files with IoU-matched '
                    'tolerances')
    parser.add_argument('results_file_a')
    parser.add_argument('results_file_b')
    parser.add_argument('--comparison_confidence_threshold',
                        type=float, default=0.1)
    parser.add_argument('--max_conf_error', type=float, default=0.005)
    parser.add_argument('--max_coord_error', type=float, default=0.001)
    parser.add_argument('--iou_match_threshold', type=float,
                        default=0.85)
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()

    options = MDTestOptions()
    options.comparison_confidence_threshold = \
        args.comparison_confidence_threshold
    options.max_conf_error = args.max_conf_error
    options.max_coord_error = args.max_coord_error
    options.iou_match_threshold = args.iou_match_threshold

    result = compare_results(args.results_file_a, args.results_file_b,
                             options=options)
    for line in result['errors'][:50]:
        print(line)
    print('{} images compared, {} errors, max conf error {:.4f}, '
          'max coord error {:.4f}'.format(
              result['n_images_compared'], len(result['errors']),
              result['max_conf_error'], result['max_coord_error']))
    sys.exit(1 if result['errors'] else 0)


if __name__ == '__main__':
    main()
