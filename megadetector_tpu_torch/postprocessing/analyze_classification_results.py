"""
Classification-accuracy analysis against ground truth (reference:
megadetector/postprocessing/analyze_classification_results.py): compare
the classifications in an MD results file against per-image ground-truth
labels, producing per-category precision/recall, a confusion matrix, and
an HTML report with misprediction galleries.

The port's own copy of
megadetector_tpu/postprocessing/analyze_classification_results.py: the same
public names, signatures, defaults and output bytes.
"""

import argparse
import json
import os
import sys

from collections import defaultdict

from megadetector_tpu_torch.utils import ct_utils


class AnalysisResults(dict):
    """
    Results returned by analyze_classification_results() (reference:
    analyze_classification_results.py:219-244). A dict (the repo's
    established result shape) that also exposes the reference's
    attribute names.
    """

    @property
    def per_category_results(self):
        """{category: {'precision', 'recall', 'f1', 'n_ground_truth',
        'n_predicted'}}."""

        out = {}
        confusion = self.get('confusion_matrix', {})
        for name, stats in self.get('per_category', {}).items():
            p, r = stats['precision'], stats['recall']
            out[name] = {
                'precision': p,
                'recall': r,
                'f1': round(2 * p * r / (p + r), 4) if (p + r) > 0
                else 0.0,
                'n_ground_truth': stats['support'],
                'n_predicted': sum(
                    row.get(name, 0) for row in confusion.values()),
            }
        return out

    @property
    def active_categories(self):
        """Ordered category names, the matrix's row/column order."""

        confusion = self.get('confusion_matrix', {})
        return sorted(set(list(confusion.keys()) +
                          [p for row in confusion.values()
                           for p in row]))

    @property
    def confusion_matrix_array(self):
        """The confusion matrix as a 2D numpy array (rows = truth)."""

        import numpy as np
        names = self.active_categories
        cm = np.zeros((len(names), len(names)), dtype=int)
        confusion = self.get('confusion_matrix', {})
        for i, t in enumerate(names):
            for j, p in enumerate(names):
                cm[i, j] = confusion.get(t, {}).get(p, 0)
        return cm

    @property
    def accuracy(self):
        return self.get('accuracy')

    @property
    def macro_f1(self):
        per_cat = self.per_category_results
        if not per_cat:
            return None
        return round(sum(v['f1'] for v in per_cat.values()) /
                     len(per_cat), 4)

    @property
    def micro_f1(self):
        # Single-label multi-class: micro-P == micro-R == accuracy
        return self.accuracy

    micro_precision = micro_f1
    micro_recall = micro_f1

    @property
    def html_output_file(self):
        return self.get('html_output_file')


class ClassificationAnalysisOptions:

    def __init__(self):
        self.md_results_file = None
        # {image filename: ground-truth category name} dict or .json
        self.ground_truth = None
        self.output_dir = None
        self.classification_confidence_threshold = 0.5
        self.detection_confidence_threshold = 0.15
        # Images whose GT name is in this set count as empty
        self.empty_category_names = ('empty', 'blank')
        self.image_base_dir = None
        self.max_mispredictions_per_cell = 20


def _image_predicted_category(im, options, categories):
    """Highest-confidence above-threshold classification name for an
    image ('empty' when nothing qualifies)."""

    best = None
    for det in im.get('detections') or []:
        if det['conf'] < options.detection_confidence_threshold:
            continue
        for c in det.get('classifications') or []:
            if c[1] < options.classification_confidence_threshold:
                continue
            if best is None or c[1] > best[1]:
                best = (c[0], c[1])
    if best is None:
        return 'empty'
    return str(categories.get(best[0], best[0])).lower()


def analyze_classification_results(options):
    """
    Run the analysis; returns a dict with 'per_category' (precision /
    recall / support per name), 'confusion_matrix'
    ({true: {predicted: count}}), 'accuracy', and
    'mispredictions' ({(true, predicted): [filenames]}). Writes an
    HTML report into options.output_dir when set.
    """

    if isinstance(options.md_results_file, str):
        with open(options.md_results_file) as f:
            data = json.load(f)
    else:
        data = options.md_results_file

    gt = options.ground_truth
    if isinstance(gt, str):
        with open(gt) as f:
            gt = json.load(f)
    gt = {k: str(v).lower() for k, v in gt.items()}

    categories = data.get('classification_categories', {})

    confusion = defaultdict(lambda: defaultdict(int))
    mispredictions = defaultdict(list)
    n_correct = 0
    n_total = 0

    for im in data['images']:
        fn = im['file']
        if fn not in gt:
            continue
        true_name = gt[fn]
        if true_name in options.empty_category_names:
            true_name = 'empty'
        predicted = _image_predicted_category(im, options, categories)
        confusion[true_name][predicted] += 1
        n_total += 1
        if predicted == true_name:
            n_correct += 1
        else:
            mispredictions[(true_name, predicted)].append(fn)

    # Per-category precision/recall
    names = sorted(set(list(confusion.keys()) +
                       [p for row in confusion.values() for p in row]))
    per_category = {}
    for name in names:
        # .get, not [] — indexing the defaultdict would create empty
        # truth rows for predicted-only names and pollute the emitted
        # confusion matrix
        row = confusion.get(name, {})
        tp = row.get(name, 0)
        fn_count = sum(v for k, v in row.items() if k != name)
        fp = sum(confusion[other].get(name, 0)
                 for other in confusion if other != name)
        precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        recall = tp / (tp + fn_count) if (tp + fn_count) > 0 else 0.0
        per_category[name] = {
            'precision': round(precision, 4),
            'recall': round(recall, 4),
            'support': tp + fn_count,
        }

    results = {
        'accuracy': round(n_correct / n_total, 4) if n_total else None,
        'n_images_evaluated': n_total,
        'per_category': per_category,
        'confusion_matrix': {k: dict(v) for k, v in confusion.items()},
        'mispredictions': {
            '{}|{}'.format(t, p): fns[:options.max_mispredictions_per_cell]
            for (t, p), fns in mispredictions.items()},
    }

    results = AnalysisResults(results)
    if options.output_dir is not None:
        os.makedirs(options.output_dir, exist_ok=True)
        ct_utils.write_json(
            os.path.join(options.output_dir,
                         'classification_analysis.json'),
            dict(results), force_str=True)
        _write_html_report(results, options)
        results['html_output_file'] = os.path.join(options.output_dir,
                                                   'index.html')
    return results


def render_misprediction_pages(options, cells_to_render,
                               max_images_per_cell=2000):
    """
    Render detailed per-cell HTML pages for specific misprediction
    cells — typically with a much larger image cap than the summary
    report — for deep-dive review (reference:
    analyze_classification_results.py:1826+). [cells_to_render] is a
    list of (true_category, predicted_category) tuples. Returns
    {cell: html path}.
    """

    deep_options = ClassificationAnalysisOptions()
    deep_options.__dict__.update(options.__dict__)
    deep_options.max_mispredictions_per_cell = max_images_per_cell
    deep_options.output_dir = None
    results = analyze_classification_results(deep_options)

    assert options.output_dir is not None, \
        'render_misprediction_pages requires options.output_dir'
    os.makedirs(options.output_dir, exist_ok=True)

    cell_to_page = {}
    for true_name, predicted in cells_to_render:
        key = '{}|{}'.format(true_name, predicted)
        fns = results['mispredictions'].get(key, [])
        page = os.path.join(
            options.output_dir,
            'misprediction_{}_as_{}.html'.format(true_name, predicted))
        html = ['<html><head><title>{} predicted as {}</title></head>'
                '<body>'.format(true_name, predicted)]
        html.append('<h1>{} predicted as {} ({} images)</h1>'.format(
            true_name, predicted, len(fns)))
        for fn in fns:
            if options.image_base_dir:
                src = os.path.join(options.image_base_dir, fn)
                html.append('<div><img src="{}" style="max-width:600px">'
                            '<br/>{}</div>'.format(src, fn))
            else:
                html.append('<div>{}</div>'.format(fn))
        html.append('</body></html>')
        with open(page, 'w') as f:
            f.write('\n'.join(html))
        cell_to_page[(true_name, predicted)] = page
        print('Wrote misprediction page {}'.format(page))
    return cell_to_page


def _write_html_report(results, options):
    html = ['<html><head><title>Classification analysis</title>',
            '<style>body{font-family:sans-serif} table,td,th'
            '{border:1px solid #888;border-collapse:collapse;'
            'padding:4px}</style></head><body>']
    html.append('<h1>Classification analysis</h1>')
    html.append('<p>Accuracy: {} over {} images</p>'.format(
        results['accuracy'], results['n_images_evaluated']))

    html.append('<h2>Per-category metrics</h2><table><tr>'
                '<th>category</th><th>precision</th><th>recall</th>'
                '<th>support</th></tr>')
    for name, m in sorted(results['per_category'].items()):
        html.append('<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>'
                    '</tr>'.format(name, m['precision'], m['recall'],
                                   m['support']))
    html.append('</table>')

    names = sorted(results['confusion_matrix'].keys())
    html.append('<h2>Confusion matrix (rows = truth)</h2><table><tr>'
                '<th></th>' +
                ''.join('<th>{}</th>'.format(n) for n in names) +
                '</tr>')
    for t in names:
        row = results['confusion_matrix'][t]
        html.append('<tr><th>{}</th>'.format(t) +
                    ''.join('<td>{}</td>'.format(row.get(p, 0))
                            for p in names) + '</tr>')
    html.append('</table>')

    html.append('<h2>Mispredictions</h2>')
    for cell, fns in sorted(results['mispredictions'].items()):
        true_name, predicted = cell.split('|')
        html.append('<h3>{} predicted as {} ({})</h3>'.format(
            true_name, predicted, len(fns)))
        for fn in fns:
            if options.image_base_dir:
                src = os.path.join(options.image_base_dir, fn)
                html.append('<div><img src="{}" style="max-width:400px">'
                            '<br/>{}</div>'.format(src, fn))
            else:
                html.append('<div>{}</div>'.format(fn))
    html.append('</body></html>')

    path = os.path.join(options.output_dir, 'index.html')
    with open(path, 'w') as f:
        f.write('\n'.join(html))
    print('Wrote classification analysis to {}'.format(path))


def main():
    parser = argparse.ArgumentParser(
        description='Analyze classification results against ground '
                    'truth')
    parser.add_argument('md_results_file')
    parser.add_argument('ground_truth_file',
                        help='{filename: category name} .json')
    parser.add_argument('output_dir')
    parser.add_argument('--classification_confidence_threshold',
                        type=float, default=0.5)
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    options = ClassificationAnalysisOptions()
    options.md_results_file = args.md_results_file
    options.ground_truth = args.ground_truth_file
    options.output_dir = args.output_dir
    options.classification_confidence_threshold = \
        args.classification_confidence_threshold
    analyze_classification_results(options)


if __name__ == '__main__':
    main()
