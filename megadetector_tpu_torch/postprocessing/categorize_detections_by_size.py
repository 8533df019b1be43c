"""
Tag detections by relative box size, adding size categories to the results
file so downstream tools (previews, folder separation) can distinguish
e.g. large animals from small ones.

Behavioral contract follows the reference
(megadetector/postprocessing/categorize_detections_by_size.py:53): boxes
whose relative dimension exceeds the threshold get a new category like
'large_detection_animal'; everything else keeps its category.

The port's own copy of
megadetector_tpu/postprocessing/categorize_detections_by_size.py: the same
public names, signatures, defaults and output bytes.
"""

import argparse
import json
import sys

from megadetector_tpu_torch.utils import ct_utils


class SizeCategorizationOptions:
    """Options controlling categorize_detections_by_size()."""

    def __init__(self):
        # Thresholds on the relative size measure; each gets its own
        # category. Sorted internally (order must match
        # size_category_names).
        self.size_thresholds = [0.95]
        # 'size' (w*h), 'width', or 'height'
        self.measurement = 'size'
        # Categories eligible for recategorization (None = all)
        self.categories_to_separate = None
        # Base name per threshold (same length as size_thresholds)
        self.size_category_names = ['large_detection']
        # When True, each (threshold, source category) pair gets its own
        # new category ('large_detection_animal'), preserving the
        # animal/vehicle distinction; when False, all sources merge into
        # one category per threshold ('large_detection').
        self.separate_unique_categories = True
        # True: default category is below the smallest threshold
        # (separating *large* detections, metric >= threshold matches);
        # False: thresholds are upper bounds (metric <= threshold)
        self.default_category_is_smallest = True


def _measure(det, measurement):
    x, y, w, h = det['bbox']
    if measurement == 'size':
        return w * h
    if measurement == 'width':
        return w
    if measurement == 'height':
        return h
    raise ValueError('Unknown measurement {}'.format(measurement))


def categorize_detections_by_size(input_file, output_file=None,
                                  options=None):
    """
    Add size-based detection categories; returns the rewritten dict and
    writes [output_file] when given.
    """

    if options is None:
        options = SizeCategorizationOptions()

    with open(input_file) as f:
        data = json.load(f)

    detection_categories = data['detection_categories']
    assert len(options.size_thresholds) == \
        len(options.size_category_names), \
        'size_thresholds and size_category_names must align'

    # Sort threshold/name pairs together: descending when separating
    # large detections (first match = largest bucket), ascending when
    # thresholds are upper bounds
    pairs = sorted(zip(options.size_thresholds,
                       options.size_category_names),
                   reverse=options.default_category_is_smallest)
    thresholds = [t for t, _ in pairs]
    names = [n for _, n in pairs]

    # New category IDs are allocated lazily per (threshold, source
    # category) when separate_unique_categories, else per threshold
    next_id = max(int(k) for k in detection_categories) + 1
    new_category_ids = {}

    def _category_for(i_threshold, source_category):
        nonlocal next_id
        if options.separate_unique_categories:
            source_name = detection_categories.get(source_category,
                                                   source_category)
            name = '{}_{}'.format(names[i_threshold], source_name)
            key = (i_threshold, source_category)
        else:
            name = names[i_threshold]
            key = i_threshold
        if key not in new_category_ids:
            new_id = str(next_id)
            next_id += 1
            detection_categories[new_id] = name
            new_category_ids[key] = new_id
        return new_category_ids[key]

    n_changed = 0
    for im in data['images']:
        for det in im.get('detections') or []:
            if det is None or det.get('bbox') is None:
                continue
            if options.categories_to_separate is not None and \
                    det['category'] not in options.categories_to_separate:
                continue
            m = _measure(det, options.measurement)
            for i_t, t in enumerate(thresholds):
                if (m >= t) if options.default_category_is_smallest \
                        else (m <= t):
                    det['category'] = _category_for(i_t, det['category'])
                    n_changed += 1
                    break

    print('Recategorized {} detections'.format(n_changed))
    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def main():
    parser = argparse.ArgumentParser(
        description='Tag detections by relative box size')
    parser.add_argument('input_file')
    parser.add_argument('output_file')
    parser.add_argument('--thresholds', nargs='+', type=float,
                        default=[0.95])
    parser.add_argument('--category_names', nargs='+', default=None,
                        help='Base name per threshold '
                             '(default: large_detection)')
    parser.add_argument('--measurement', default='size',
                        choices=['size', 'width', 'height'])
    parser.add_argument('--categories_to_separate', nargs='+',
                        default=None,
                        help='Source category IDs eligible for '
                             'recategorization (default: all)')
    parser.add_argument('--merge_source_categories', action='store_true',
                        help='Merge all source categories into one new '
                             'category per threshold instead of '
                             'per-source names like '
                             'large_detection_animal')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = SizeCategorizationOptions()
    options.size_thresholds = args.thresholds
    options.size_category_names = args.category_names if \
        args.category_names is not None else \
        ['large_detection'] * len(args.thresholds)
    options.measurement = args.measurement
    options.categories_to_separate = args.categories_to_separate
    options.separate_unique_categories = not args.merge_source_categories
    categorize_detections_by_size(args.input_file, args.output_file,
                                  options)


if __name__ == '__main__':
    main()
