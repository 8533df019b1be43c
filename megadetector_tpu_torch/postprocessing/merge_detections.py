"""
Merge detections from multiple results files into a single output: for
each image, add detections from source files that have no close match in
the target (IoU-based), typically to combine models that are better at
different categories.

Behavioral contract follows the reference
(megadetector/postprocessing/merge_detections.py:82): the target file is
the base; detections from source files are added when their confidence
exceeds the source threshold and no target detection of the same category
overlaps at IoU >= merge_iou_threshold; merged detections are tagged with
'transferred_from'.

The port's own copy of megadetector_tpu/postprocessing/merge_detections.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import json
import sys

from megadetector_tpu_torch.utils import ct_utils


class MergeDetectionsOptions:
    """Options controlling merge_detections()."""

    def __init__(self):
        self.max_detection_size = 1.01
        self.min_detection_size = 0
        self.source_confidence_thresholds = [0.2]
        self.target_confidence_threshold = 0.2
        self.iou_threshold = 0.5
        self.categories_to_include = None
        self.merge_empty_only = False


def merge_detections(source_files, target_file, output_file, options=None):
    """
    Merge detections from [source_files] into [target_file], writing
    [output_file]. Returns the merged dict.
    """

    if options is None:
        options = MergeDetectionsOptions()
    if isinstance(source_files, str):
        source_files = [source_files]

    assert len(options.source_confidence_thresholds) == len(source_files), \
        'Need one source confidence threshold per source file'

    with open(target_file) as f:
        target_data = json.load(f)

    fn_to_target_im = {im['file']: im for im in target_data['images']}

    n_merged = 0

    for i_source, source_file in enumerate(source_files):
        source_threshold = options.source_confidence_thresholds[i_source]
        with open(source_file) as f:
            source_data = json.load(f)

        assert source_data.get('detection_categories') == \
            target_data.get('detection_categories'), \
            'Cannot merge files with different detection categories'

        for source_im in source_data['images']:
            fn = source_im['file']
            if fn not in fn_to_target_im:
                continue
            target_im = fn_to_target_im[fn]
            target_dets = target_im.get('detections')
            source_dets = source_im.get('detections')
            if target_dets is None or source_dets is None:
                continue

            if options.merge_empty_only and any(
                    d['conf'] >= options.target_confidence_threshold
                    for d in target_dets):
                continue

            for det in source_dets:
                if det['conf'] < source_threshold:
                    continue
                if options.categories_to_include is not None and \
                        det['category'] not in \
                        options.categories_to_include:
                    continue
                size = det['bbox'][2] * det['bbox'][3]
                if size > options.max_detection_size or \
                        size < options.min_detection_size:
                    continue
                # Skip when a same-category target detection overlaps
                duplicate = False
                for t in target_dets:
                    if t['category'] != det['category']:
                        continue
                    try:
                        iou = ct_utils.get_iou(t['bbox'], det['bbox'])
                    except AssertionError:
                        continue
                    if iou >= options.iou_threshold:
                        duplicate = True
                        break
                if not duplicate:
                    det_out = dict(det)
                    det_out['transferred_from'] = source_file
                    target_dets.append(det_out)
                    n_merged += 1

    print('Merged {} detections'.format(n_merged))

    info = target_data.get('info', {})
    info['detections_transferred_from'] = list(source_files)
    target_data['info'] = info

    if output_file is not None:
        ct_utils.write_json(output_file, target_data, force_str=True)
    return target_data


def main():
    parser = argparse.ArgumentParser(
        description='Merge detections from multiple MD results files')
    parser.add_argument('target_file')
    parser.add_argument('output_file')
    parser.add_argument('--source_files', nargs='+', required=True)
    parser.add_argument('--source_confidence_thresholds', nargs='+',
                        type=float, default=None)
    parser.add_argument('--target_confidence_threshold', type=float,
                        default=0.2)
    parser.add_argument('--iou_threshold', type=float, default=0.5)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = MergeDetectionsOptions()
    if args.source_confidence_thresholds is not None:
        options.source_confidence_thresholds = \
            args.source_confidence_thresholds
    else:
        options.source_confidence_thresholds = \
            [0.2] * len(args.source_files)
    options.target_confidence_threshold = \
        args.target_confidence_threshold
    options.iou_threshold = args.iou_threshold
    merge_detections(args.source_files, args.target_file,
                     args.output_file, options)


if __name__ == '__main__':
    main()
