"""
Convert zamba-formatted .csv results to MD-formatted .json results
(reference: megadetector/data_management/zamba_to_md.py). The conversion
logic lives in importers.py; this module preserves the reference's
import path and CLI.

The port's own copy of megadetector_tpu/data_management/zamba_to_md.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import sys

from megadetector_tpu_torch.data_management.importers import (  # noqa: F401
    zamba_results_to_md_results, zamba_to_md)


def main():
    parser = argparse.ArgumentParser(
        description='Convert a zamba-formatted .csv results file to an '
                    'MD-formatted .json results file')
    parser.add_argument('input_file', type=str,
                        help='input .csv file')
    parser.add_argument('--output_file', type=str, default=None,
                        help='output .json file (defaults to input file '
                             'appended with ".json")')
    parser.add_argument('--image_folder', type=str, default=None,
                        help='folder of images, required only for image '
                             '(rather than video) results')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    zamba_results_to_md_results(args.input_file, args.output_file,
                                image_folder=args.image_folder)


if __name__ == '__main__':
    main()
