"""
Flat per-image CSV report from an MD results file.

Behavioral contract follows the reference
(megadetector/postprocessing/generate_csv_report.py:59): one row per
image with per-category detection counts and max confidences above a
threshold, plus classification summaries when present.

The port's own copy of
megadetector_tpu/postprocessing/generate_csv_report.py: the same public
names, signatures, defaults and output bytes.
"""

import argparse
import csv
import json
import sys

from megadetector_tpu_torch.utils import ct_utils


def generate_csv_report(results_file, output_file=None,
                        confidence_threshold=None):
    """
    Write a CSV with one row per image. Returns the output filename.
    """

    with open(results_file) as f:
        data = json.load(f)

    if output_file is None:
        output_file = results_file.replace('.json', '') + '_report.csv'

    if confidence_threshold is None:
        md = data.get('info', {}).get('detector_metadata', {})
        confidence_threshold = md.get('typical_detection_threshold', 0.2)

    detection_categories = data.get('detection_categories', {})
    classification_categories = data.get('classification_categories', {})
    category_ids = sorted(detection_categories.keys(), key=int)

    header = ['image_path', 'status', 'n_detections', 'max_confidence']
    for cat_id in category_ids:
        name = detection_categories[cat_id]
        header.append('n_{}'.format(name))
        header.append('max_confidence_{}'.format(name))
    header.append('top_classification')
    header.append('top_classification_confidence')

    with open(output_file, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(header)

        for im in data['images']:
            detections = im.get('detections')
            if detections is None:
                writer.writerow([im['file'], 'failure'] +
                                [''] * (len(header) - 2))
                continue

            above = [d for d in detections
                     if d['conf'] >= confidence_threshold]
            row = [im['file'], 'success', len(above),
                   ct_utils.get_max_conf(im)]
            top_class = ('', '')
            for cat_id in category_ids:
                cat_dets = [d for d in above if d['category'] == cat_id]
                row.append(len(cat_dets))
                row.append(max([d['conf'] for d in cat_dets], default=''))
            for d in above:
                for c in d.get('classifications') or []:
                    if top_class[1] == '' or c[1] > top_class[1]:
                        name = classification_categories.get(c[0], c[0])
                        top_class = (name, c[1])
            row.extend([top_class[0], top_class[1]])
            writer.writerow(row)

    print('Wrote CSV report to {}'.format(output_file))
    return output_file


def main():
    parser = argparse.ArgumentParser(
        description='Generate a per-image CSV report from MD results')
    parser.add_argument('results_file')
    parser.add_argument('output_file', nargs='?', default=None)
    parser.add_argument('--confidence_threshold', type=float, default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    generate_csv_report(args.results_file, args.output_file,
                        args.confidence_threshold)


if __name__ == '__main__':
    main()
