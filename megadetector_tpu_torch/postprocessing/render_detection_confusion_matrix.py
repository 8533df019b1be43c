"""
Detection confusion matrix against ground truth (labelme files or a COCO
database): per-category TP/FP/FN counts with IoU matching, plus an HTML
report.

Behavioral contract follows the reference
(megadetector/postprocessing/render_detection_confusion_matrix.py:90).

The port's own copy of
megadetector_tpu/postprocessing/render_detection_confusion_matrix.py: the
same public names, signatures, defaults and output bytes.
"""

import argparse
import json
import os
import sys

from collections import defaultdict

from megadetector_tpu_torch.utils import ct_utils


def _load_ground_truth_boxes(gt, image_folder=None):
    """
    Normalize ground truth to {filename: [(category_name, bbox_norm)]}.
    Accepts a COCO dict/path (absolute boxes, converted via image sizes)
    or a folder of labelme files.
    """

    if isinstance(gt, str) and os.path.isdir(gt):
        # labelme folder
        from megadetector_tpu_torch.utils.path_utils import recursive_file_list
        out = defaultdict(list)
        for fn in recursive_file_list(gt, return_relative_paths=True):
            if not fn.endswith('.json'):
                continue
            with open(os.path.join(gt, fn)) as f:
                labelme = json.load(f)
            w = labelme.get('imageWidth')
            h = labelme.get('imageHeight')
            if not w or not h:
                continue
            image_fn = os.path.splitext(fn)[0] + \
                os.path.splitext(labelme.get('imagePath', '.jpg'))[1]
            for shape in labelme.get('shapes', []):
                if shape.get('shape_type') != 'rectangle':
                    continue
                xs = [p[0] for p in shape['points']]
                ys = [p[1] for p in shape['points']]
                bbox = [min(xs) / w, min(ys) / h,
                        (max(xs) - min(xs)) / w,
                        (max(ys) - min(ys)) / h]
                out[image_fn].append((shape['label'], bbox))
        return dict(out)

    if isinstance(gt, str):
        with open(gt) as f:
            gt = json.load(f)

    cat_id_to_name = {c['id']: c['name'] for c in gt.get('categories', [])}
    image_id_to_image = {im['id']: im for im in gt['images']}
    out = defaultdict(list)
    for ann in gt.get('annotations', []):
        bbox = ann.get('bbox')
        if bbox is None:
            continue
        im = image_id_to_image.get(ann['image_id'])
        if im is None or not im.get('width') or not im.get('height'):
            continue
        w, h = im['width'], im['height']
        out[im['file_name']].append((
            cat_id_to_name.get(ann['category_id'],
                               str(ann['category_id'])),
            [bbox[0] / w, bbox[1] / h, bbox[2] / w, bbox[3] / h]))
    # Images with no annotations still count (as empty)
    for im in gt['images']:
        out.setdefault(im['file_name'], [])
    return dict(out)


def render_detection_confusion_matrix(
        results_file, ground_truth, output_file=None,
        confidence_threshold=0.2, iou_threshold=0.5,
        category_mapping=None):
    """
    Compute per-category TP/FP/FN and a predicted-vs-true category matrix.

    [category_mapping] maps MD category names to ground-truth names
    (default identity). Returns a dict with 'per_category' stats and
    'confusion' counts; writes an HTML summary when [output_file] is
    given.
    """

    with open(results_file) as f:
        md = json.load(f)
    detection_categories = md.get('detection_categories', {})
    gt_boxes = _load_ground_truth_boxes(ground_truth)

    if category_mapping is None:
        category_mapping = {}

    per_category = defaultdict(lambda: {'tp': 0, 'fp': 0, 'fn': 0})
    confusion = defaultdict(int)  # (true, predicted) -> count

    for im in md['images']:
        fn = im['file']
        if fn not in gt_boxes:
            continue
        detections = [d for d in (im.get('detections') or [])
                      if d['conf'] >= confidence_threshold]
        truths = list(gt_boxes[fn])
        matched_truth = set()

        for det in detections:
            pred_name = detection_categories.get(det['category'],
                                                 det['category'])
            pred_name = category_mapping.get(pred_name, pred_name)
            best = None
            best_iou = iou_threshold
            for i_t, (true_name, true_bbox) in enumerate(truths):
                if i_t in matched_truth:
                    continue
                try:
                    iou = ct_utils.get_iou(det['bbox'], true_bbox)
                except AssertionError:
                    continue
                if iou >= best_iou:
                    best_iou = iou
                    best = i_t
            if best is None:
                per_category[pred_name]['fp'] += 1
                confusion[('(none)', pred_name)] += 1
            else:
                matched_truth.add(best)
                true_name = truths[best][0]
                confusion[(true_name, pred_name)] += 1
                if true_name == pred_name:
                    per_category[pred_name]['tp'] += 1
                else:
                    per_category[pred_name]['fp'] += 1
                    per_category[true_name]['fn'] += 1

        for i_t, (true_name, _) in enumerate(truths):
            if i_t not in matched_truth:
                per_category[true_name]['fn'] += 1
                confusion[(true_name, '(none)')] += 1

    results = {'per_category': {k: dict(v)
                                for k, v in per_category.items()},
               'confusion': {'{}|{}'.format(t, p): n
                             for (t, p), n in confusion.items()}}

    if output_file is not None:
        with open(output_file, 'w') as f:
            f.write('<html><body><h1>Detection confusion matrix</h1>\n')
            f.write('<table border="1"><tr><th>category</th><th>TP</th>'
                    '<th>FP</th><th>FN</th><th>precision</th>'
                    '<th>recall</th></tr>\n')
            for cat, s in sorted(results['per_category'].items()):
                precision = s['tp'] / max(s['tp'] + s['fp'], 1)
                recall = s['tp'] / max(s['tp'] + s['fn'], 1)
                f.write('<tr><td>{}</td><td>{}</td><td>{}</td><td>{}'
                        '</td><td>{:.3f}</td><td>{:.3f}</td></tr>\n'
                        .format(cat, s['tp'], s['fp'], s['fn'],
                                precision, recall))
            f.write('</table>\n<h2>Confusion counts</h2><ul>\n')
            for key, n in sorted(results['confusion'].items()):
                f.write('<li>{}: {}</li>\n'.format(
                    key.replace('|', ' &rarr; '), n))
            f.write('</ul></body></html>\n')
        print('Wrote confusion matrix to {}'.format(output_file))

    return results


def main():
    parser = argparse.ArgumentParser(
        description='Confusion matrix vs ground truth')
    parser.add_argument('results_file')
    parser.add_argument('ground_truth',
                        help='COCO .json or labelme folder')
    parser.add_argument('output_file')
    parser.add_argument('--confidence_threshold', type=float, default=0.2)
    parser.add_argument('--iou_threshold', type=float, default=0.5)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    render_detection_confusion_matrix(
        args.results_file, args.ground_truth, args.output_file,
        confidence_threshold=args.confidence_threshold,
        iou_threshold=args.iou_threshold)


if __name__ == '__main__':
    main()
