"""
Convert MD results between .json and .csv representations.

Behavioral contract follows the reference
(megadetector/postprocessing/convert_output_format.py:33,220): the CSV has
one row per image with 'image_path', 'max_confidence', and a JSON-encoded
'detections' column.

The port's own copy of
megadetector_tpu/postprocessing/convert_output_format.py: the same public
names, signatures, defaults and output bytes.
"""

import argparse
import csv
import json
import os
import sys

from megadetector_tpu_torch.utils import ct_utils

CSV_FIELDS = ['image_path', 'max_confidence', 'detections']


def convert_json_to_csv(input_path, output_path=None,
                        min_confidence=None, omit_bounding_boxes=False):
    """Write an MD results .json as a .csv; returns the output path."""

    if output_path is None:
        output_path = os.path.splitext(input_path)[0] + '.csv'

    with open(input_path) as f:
        data = json.load(f)

    with open(output_path, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(CSV_FIELDS)
        for im in data['images']:
            detections = im.get('detections')
            if detections is None:
                writer.writerow([im['file'], '', 'failure'])
                continue
            if min_confidence is not None:
                detections = [d for d in detections
                              if d['conf'] >= min_confidence]
            max_conf = ct_utils.get_max_conf(im)
            if omit_bounding_boxes:
                det_payload = json.dumps(
                    [{k: v for k, v in d.items() if k != 'bbox'}
                     for d in detections])
            else:
                det_payload = json.dumps(detections)
            writer.writerow([im['file'], max_conf, det_payload])

    print('Wrote {}'.format(output_path))
    return output_path


def convert_csv_to_json(input_path, output_path=None,
                        detector_name='unknown'):
    """Read a .csv produced by convert_json_to_csv back into MD .json."""

    if output_path is None:
        output_path = os.path.splitext(input_path)[0] + '.json'

    images = []
    with open(input_path, newline='') as f:
        reader = csv.DictReader(f)
        for row in reader:
            im = {'file': row['image_path']}
            if row['detections'] == 'failure':
                im['detections'] = None
                im['failure'] = 'failure'
            else:
                im['detections'] = json.loads(row['detections'])
            images.append(im)

    data = {
        'images': images,
        'detection_categories': {'1': 'animal', '2': 'person',
                                 '3': 'vehicle'},
        'info': {'format_version': '1.6', 'detector': detector_name},
    }
    ct_utils.write_json(output_path, data, force_str=True)
    print('Wrote {}'.format(output_path))
    return output_path


def main():
    parser = argparse.ArgumentParser(
        description='Convert MD results between .json and .csv')
    parser.add_argument('input_path')
    parser.add_argument('output_path', nargs='?', default=None)
    parser.add_argument('--min_confidence', type=float, default=None)
    parser.add_argument('--omit_bounding_boxes', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    if args.input_path.endswith('.json'):
        convert_json_to_csv(args.input_path, args.output_path,
                            min_confidence=args.min_confidence,
                            omit_bounding_boxes=args.omit_bounding_boxes)
    elif args.input_path.endswith('.csv'):
        convert_csv_to_json(args.input_path, args.output_path)
    else:
        raise ValueError('Input must be .json or .csv')


if __name__ == '__main__':
    main()
