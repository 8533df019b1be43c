"""
Cross-model confidence calibration: compare two models' confidence scales
by IoU-matching their detections on the same images, then fit a monotone
mapping so thresholds tuned for model A transfer to model B.

Behavioral contract follows the reference
(megadetector/postprocessing/detector_calibration.py:30-112,117,395):
CalibrationResults with [conf_a, conf_b, iou, i_image, category_id,
matches_gt] match tuples (optionally validated against COCO ground
truth), a fitted mapping, and comparison plots (plots optional here; the
mapping itself is the load-bearing output).

The port's own copy of
megadetector_tpu/postprocessing/detector_calibration.py: the same public
names, signatures, defaults and output bytes.
"""

import argparse
import json
import sys

from enum import IntEnum

import numpy as np

from megadetector_tpu_torch.utils import ct_utils


class CalibrationOptions:
    """Options controlling compare_model_confidence_values()."""

    def __init__(self):
        self.iou_threshold = 0.6
        self.confidence_threshold = 0.025
        self.max_samples_per_category = 20000
        self.categories_to_compare = None
        #: Populate data_a and data_b in the returned CalibrationResults
        self.return_data = False
        #: Axis labels used by plot_matched_confidence_values
        self.model_name_a = 'Model A'
        self.model_name_b = 'Model B'


class CalibrationMatchColumns(IntEnum):
    """
    Columns in CalibrationResults.calibration_matches tuples
    (reference: detector_calibration.py:80-90).
    """

    COLUMN_CONF_A = 0
    COLUMN_CONF_B = 1
    COLUMN_IOU = 2
    COLUMN_I_IMAGE = 3
    COLUMN_CATEGORY_ID = 4
    COLUMN_MATCHES_GT = 5


class CalibrationResults:
    """
    Results of a model-to-model comparison (reference:
    detector_calibration.py:92-112).
    """

    def __init__(self):
        #: List of tuples:
        #: [conf_a, conf_b, iou, i_image, category_id, matches_gt].
        #: [matches_gt] is None when no ground truth was supplied.
        self.calibration_matches = []
        #: Loaded results dicts, populated when options.return_data
        self.data_a = None
        self.data_b = None

    def category_to_matched_confidence_values(self,
                                              max_samples_per_category=None):
        """
        Group calibration_matches into {category_id: (confs_a, confs_b)}
        numpy pairs, optionally downsampled per category.
        """

        pairs = {}
        for m in self.calibration_matches:
            pairs.setdefault(m[CalibrationMatchColumns.COLUMN_CATEGORY_ID],
                             ([], []))
            cat_pair = pairs[m[CalibrationMatchColumns.COLUMN_CATEGORY_ID]]
            cat_pair[0].append(m[CalibrationMatchColumns.COLUMN_CONF_A])
            cat_pair[1].append(m[CalibrationMatchColumns.COLUMN_CONF_B])
        out = {}
        for cat, (a, b) in pairs.items():
            a = np.asarray(a)
            b = np.asarray(b)
            if max_samples_per_category is not None and \
                    len(a) > max_samples_per_category:
                idx = np.random.RandomState(0).choice(
                    len(a), max_samples_per_category, replace=False)
                a, b = a[idx], b[idx]
            out[cat] = (a, b)
        return out


def _load_gt_boxes(results_gt):
    """
    COCO ground truth -> {file_name: [(category_name, normalized
    xywh bbox), ...]}. Images without width/height contribute nothing
    (we can't normalize their boxes).
    """

    if isinstance(results_gt, str):
        with open(results_gt) as f:
            results_gt = json.load(f)

    category_id_to_name = {c['id']: c['name']
                           for c in results_gt.get('categories', [])}
    image_id_to_image = {im['id']: im
                         for im in results_gt.get('images', [])}
    file_to_boxes = {}
    for im in results_gt.get('images', []):
        file_to_boxes[im['file_name']] = []
    for ann in results_gt.get('annotations', []):
        im = image_id_to_image.get(ann.get('image_id'))
        if im is None or 'bbox' not in ann or ann['bbox'] is None:
            continue
        w = im.get('width')
        h = im.get('height')
        if not w or not h:
            continue
        x, y, bw, bh = ann['bbox']
        file_to_boxes[im['file_name']].append(
            (category_id_to_name.get(ann.get('category_id')),
             [x / w, y / h, bw / w, bh / h]))
    return file_to_boxes


def compare_model_confidence_values(results_a, results_b,
                                    results_gt=None, options=None):
    """
    IoU-match detections between two results files (paths or dicts) on
    common images (reference: detector_calibration.py:117). Returns a
    CalibrationResults whose calibration_matches rows are
    [conf_a, conf_b, iou, i_image, category_id, matches_gt]; when
    [results_gt] (COCO, path or dict) is given, matches_gt says whether
    either matched box overlaps a same-category ground-truth box at the
    IoU threshold.
    """

    if options is None:
        options = CalibrationOptions()

    if isinstance(results_a, str):
        with open(results_a) as f:
            results_a = json.load(f)
    if isinstance(results_b, str):
        with open(results_b) as f:
            results_b = json.load(f)

    gt_boxes = None
    gt_category_names = None
    if results_gt is not None:
        gt_boxes = _load_gt_boxes(results_gt)

    category_id_to_name = results_a.get('detection_categories', {})

    images_a = {im['file']: im for im in results_a['images']}
    images_b = {im['file']: im for im in results_b['images']}

    results = CalibrationResults()
    if options.return_data:
        results.data_a = results_a
        results.data_b = results_b

    for i_image, fn in enumerate(sorted(set(images_a) & set(images_b))):
        dets_a = images_a[fn].get('detections') or []
        dets_b = images_b[fn].get('detections') or []
        used_b = set()
        for det_a in dets_a:
            if det_a['conf'] < options.confidence_threshold:
                continue
            cat = det_a['category']
            if options.categories_to_compare is not None and \
                    cat not in options.categories_to_compare:
                continue
            best = None
            best_iou = options.iou_threshold
            for i_b, det_b in enumerate(dets_b):
                if i_b in used_b or det_b['category'] != cat:
                    continue
                if det_b['conf'] < options.confidence_threshold:
                    continue
                try:
                    iou = ct_utils.get_iou(det_a['bbox'], det_b['bbox'])
                except AssertionError:
                    continue
                if iou >= best_iou:
                    best_iou = iou
                    best = i_b
            if best is None:
                continue
            used_b.add(best)

            matches_gt = None
            if gt_boxes is not None:
                matches_gt = False
                cat_name = category_id_to_name.get(cat, cat)
                for gt_cat_name, gt_bbox in gt_boxes.get(fn, []):
                    if gt_cat_name != cat_name:
                        continue
                    for box in (det_a['bbox'], dets_b[best]['bbox']):
                        try:
                            if ct_utils.get_iou(box, gt_bbox) >= \
                                    options.iou_threshold:
                                matches_gt = True
                        except AssertionError:
                            continue
                    if matches_gt:
                        break

            results.calibration_matches.append(
                (det_a['conf'], dets_b[best]['conf'], best_iou,
                 i_image, cat, matches_gt))

    return results


def plot_matched_confidence_values(comparison_results,
                                   output_filename,
                                   options=None, n_hist_bins=80):
    """
    2D histogram plots of paired confidence values per category, one
    panel per category (reference: detector_calibration.py:395-554).
    Accepts a CalibrationResults or a {category: (confs_a, confs_b)}
    dict. Returns the figure.
    """

    from megadetector_tpu_torch.visualization.plot_utils import _get_plt

    if options is None:
        options = CalibrationOptions()

    if isinstance(comparison_results, CalibrationResults):
        comparison_results = \
            comparison_results.category_to_matched_confidence_values(
                max_samples_per_category=options.max_samples_per_category)

    plt = _get_plt()
    categories = sorted(comparison_results)
    n_panels = max(len(categories), 1)
    fig, axes = plt.subplots(1, n_panels,
                             figsize=(6 * n_panels, 5),
                             squeeze=False)
    for i_cat, cat in enumerate(categories):
        confs_a, confs_b = comparison_results[cat]
        ax = axes[0][i_cat]
        h = ax.hist2d(confs_a, confs_b, bins=n_hist_bins,
                      range=[[0, 1], [0, 1]], cmin=1)
        ax.plot([0, 1], [0, 1], 'r--', linewidth=0.8)
        ax.set_xlabel('{} confidence'.format(options.model_name_a))
        ax.set_ylabel('{} confidence'.format(options.model_name_b))
        ax.set_title('Category {} ({} matches)'.format(
            cat, len(confs_a)))
        fig.colorbar(h[3], ax=ax)
    fig.tight_layout()
    if output_filename is not None:
        import os as _os
        out_dir = _os.path.dirname(output_filename)
        if out_dir:
            _os.makedirs(out_dir, exist_ok=True)
        fig.savefig(output_filename)
        plt.close(fig)
    return fig


def fit_confidence_mapping(confs_a, confs_b, n_bins=20):
    """
    Fit a monotone piecewise-linear mapping from model A's confidence
    scale to model B's via quantile matching. Returns
    (a_quantiles, b_quantiles); use map_confidence() to apply.
    """

    qs = np.linspace(0, 1, n_bins + 1)
    a_q = np.quantile(confs_a, qs)
    b_q = np.quantile(confs_b, qs)
    # Enforce monotonicity
    a_q = np.maximum.accumulate(a_q)
    b_q = np.maximum.accumulate(b_q)
    return a_q, b_q


def map_confidence(conf, a_quantiles, b_quantiles):
    """Apply a fitted mapping: model-A confidence -> model-B scale."""

    return float(np.interp(conf, a_quantiles, b_quantiles))


def calibrate_threshold(results_a, results_b, threshold_a, options=None):
    """
    The headline use: what model-B threshold corresponds to [threshold_a]
    on model A? Returns a float (per matched-pair quantile mapping over
    all categories).
    """

    results = compare_model_confidence_values(results_a, results_b,
                                              options=options)
    pairs = results.category_to_matched_confidence_values()
    all_a = np.concatenate([p[0] for p in pairs.values()]) \
        if pairs else np.array([])
    all_b = np.concatenate([p[1] for p in pairs.values()]) \
        if pairs else np.array([])
    if len(all_a) < 2:
        return threshold_a
    a_q, b_q = fit_confidence_mapping(all_a, all_b)
    return map_confidence(threshold_a, a_q, b_q)


def main():
    parser = argparse.ArgumentParser(
        description='Calibrate confidence thresholds across two models')
    parser.add_argument('results_a')
    parser.add_argument('results_b')
    parser.add_argument('threshold_a', type=float)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    t = calibrate_threshold(args.results_a, args.results_b,
                            args.threshold_a)
    print('Model-B threshold equivalent to {:.3f}: {:.3f}'.format(
        args.threshold_a, t))


if __name__ == '__main__':
    main()
