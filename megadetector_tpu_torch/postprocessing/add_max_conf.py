"""
Re-add the legacy 'max_detection_conf' field to each image in a results
file (removed from the format in v1.3 but still consumed by some tools).

Behavioral contract follows the reference
(megadetector/postprocessing/add_max_conf.py:27).

The port's own copy of megadetector_tpu/postprocessing/add_max_conf.py: the
same public names, signatures, defaults and output bytes.
"""

import argparse
import json
import sys

from megadetector_tpu_torch.utils import ct_utils


def add_max_conf(input_file, output_file=None):
    """Add max_detection_conf to every image; returns the rewritten dict."""

    with open(input_file) as f:
        data = json.load(f)
    for im in data['images']:
        im['max_detection_conf'] = ct_utils.get_max_conf(im)
    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def main():
    parser = argparse.ArgumentParser(
        description='Add max_detection_conf to an MD results file')
    parser.add_argument('input_file')
    parser.add_argument('output_file')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    add_max_conf(args.input_file, args.output_file)


if __name__ == '__main__':
    main()
