"""
COCO-style mAP evaluation of MD-format detection results against COCO
Camera Traps ground truth: per-class average precision via the
all-points interpolated PR curve, at one IoU threshold (PASCAL-style
mAP@0.5) or averaged over the COCO ladder (mAP@[.5:.95]).

This is the accuracy-harness entry point the real-weight gate needs:
the day real weights arrive, `md-evaluate-detections results.json
gt.json` quantifies accuracy with no extra tooling (the reference
defers to external pycocotools through its YOLO-val wrapper,
megadetector/detection/run_inference_with_yolo_val.py; this
implementation is self-contained and matches the standard COCO
protocol: score-ranked greedy matching, one GT per detection,
class-faithful).

Detections use MD normalized [x, y, w, h]; GT boxes are COCO absolute
pixels (converted through each image's width/height) or already
normalized when no sizes are present.

The port's copy of megadetector_tpu/postprocessing/evaluate_detections.py
(host code only).
"""

import argparse
import collections
import json
import sys

import numpy as np

from megadetector_tpu_torch.utils.ct_utils import get_iou

#: The COCO IoU ladder for mAP@[.5:.95]
COCO_IOU_THRESHOLDS = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85,
                       0.9, 0.95]


def _normalize_gt(gt_data):
    """Index GT by filename with normalized boxes and category NAMES.
    Returns {filename: [(category_name, [x, y, w, h]), ...]}."""

    categories = {c['id']: c['name']
                  for c in gt_data.get('categories', [])}
    image_by_id = {im['id']: im for im in gt_data.get('images', [])}
    boxes_by_file = collections.defaultdict(list)
    for ann in gt_data.get('annotations', []):
        if 'bbox' not in ann:
            continue
        im = image_by_id.get(ann['image_id'])
        if im is None:
            continue
        x, y, w, h = ann['bbox']
        if im.get('width') and im.get('height'):
            box = [x / im['width'], y / im['height'],
                   w / im['width'], h / im['height']]
        else:
            box = [x, y, w, h]
        name = categories.get(ann['category_id'], str(ann['category_id']))
        boxes_by_file[im.get('file_name', im['id'])].append((name, box))
    gt_files = set(im.get('file_name', im['id'])
                   for im in gt_data.get('images', []))
    return dict(boxes_by_file), gt_files


def _average_precision(scores, matched, n_gt):
    """All-points interpolated AP from score-ranked match flags."""

    if n_gt == 0:
        return None
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    matched = np.asarray(matched, dtype=np.float64)[order]
    tp_cum = np.cumsum(matched)
    fp_cum = np.cumsum(1.0 - matched)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # Interpolate: precision envelope, integrate over recall steps
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    recall = np.concatenate([[0.0], recall])
    precision = np.concatenate([[precision[0] if len(precision) else 0.0],
                                precision])
    return float(np.sum((recall[1:] - recall[:-1]) * precision[1:]))


def evaluate_detections(md_results, gt_coco, iou_thresholds=(0.5,),
                        min_confidence=0.0):
    """
    Evaluate MD results against COCO-CT ground truth.

    Args:
        md_results: MD results filename or loaded dict
        gt_coco: COCO-CT filename or loaded dict (absolute-pixel boxes
            with image width/height, or normalized boxes without)
        iou_thresholds: IoUs to evaluate (each contributes an AP per
            class; mAP averages over classes then thresholds). Use
            COCO_IOU_THRESHOLDS for mAP@[.5:.95].
        min_confidence: ignore detections below this score

    Returns:
        dict: {'mAP', 'per_iou': {iou: {'mAP', 'per_class':
        {name: {'ap', 'n_gt', 'n_detections'}}}}, 'n_images_evaluated'}
    """

    if isinstance(md_results, str):
        with open(md_results) as f:
            md_results = json.load(f)
    if isinstance(gt_coco, str):
        with open(gt_coco) as f:
            gt_coco = json.load(f)

    detection_categories = md_results.get('detection_categories', {})
    gt_by_file, gt_files = _normalize_gt(gt_coco)

    # Collect per-class detections across the evaluated image set
    detections_by_class = collections.defaultdict(list)
    n_gt_by_class = collections.Counter()
    n_images = 0
    for im in md_results['images']:
        fn = im['file']
        if fn not in gt_files or im.get('detections') is None:
            continue
        n_images += 1
        for name, _ in gt_by_file.get(fn, []):
            n_gt_by_class[name] += 1
        for d in im['detections']:
            if d['conf'] < min_confidence:
                continue
            name = detection_categories.get(d['category'],
                                            d['category'])
            detections_by_class[name].append(
                (fn, float(d['conf']), d['bbox']))

    per_iou = {}
    for iou_threshold in iou_thresholds:
        per_class = {}
        class_names = set(n_gt_by_class) | set(detections_by_class)
        for name in sorted(class_names):
            dets = sorted(detections_by_class.get(name, []),
                          key=lambda t: -t[1])
            gt_used = collections.defaultdict(set)
            scores = []
            matched_flags = []
            for fn, score, bbox in dets:
                gt_boxes = [
                    (i, box) for i, (gname, box)
                    in enumerate(gt_by_file.get(fn, []))
                    if gname == name and i not in gt_used[fn]]
                best = None
                for i, box in gt_boxes:
                    try:
                        iou = get_iou(bbox, box)
                    except AssertionError:
                        continue
                    if iou >= iou_threshold and \
                            (best is None or iou > best[1]):
                        best = (i, iou)
                scores.append(score)
                if best is not None:
                    gt_used[fn].add(best[0])
                    matched_flags.append(1.0)
                else:
                    matched_flags.append(0.0)
            ap = _average_precision(scores, matched_flags,
                                    n_gt_by_class.get(name, 0))
            per_class[name] = {
                'ap': None if ap is None else round(ap, 5),
                'n_gt': int(n_gt_by_class.get(name, 0)),
                'n_detections': len(dets),
            }
        aps = [m['ap'] for m in per_class.values()
               if m['ap'] is not None]
        per_iou[iou_threshold] = {
            'mAP': round(float(np.mean(aps)), 5) if aps else None,
            'per_class': per_class,
        }

    maps = [v['mAP'] for v in per_iou.values() if v['mAP'] is not None]
    return {
        'mAP': round(float(np.mean(maps)), 5) if maps else None,
        'iou_thresholds': list(iou_thresholds),
        'per_iou': per_iou,
        'n_images_evaluated': n_images,
    }


def main():
    parser = argparse.ArgumentParser(
        description='COCO-style mAP of MD results vs COCO-CT ground '
                    'truth')
    parser.add_argument('md_results_file')
    parser.add_argument('ground_truth_file')
    parser.add_argument('--coco_ladder', action='store_true',
                        help='average over IoU .5:.95 (default: '
                             'mAP@0.5 only)')
    parser.add_argument('--min_confidence', type=float, default=0.0)
    parser.add_argument('--output_file', default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    thresholds = COCO_IOU_THRESHOLDS if args.coco_ladder else (0.5,)
    metrics = evaluate_detections(args.md_results_file,
                                  args.ground_truth_file,
                                  iou_thresholds=thresholds,
                                  min_confidence=args.min_confidence)
    print(json.dumps(metrics, indent=1))
    if args.output_file:
        with open(args.output_file, 'w') as f:
            json.dump(metrics, f, indent=1)


if __name__ == '__main__':
    main()
