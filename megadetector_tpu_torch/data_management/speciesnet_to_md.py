"""
CLI: convert a SpeciesNet predictions.json file to MD format
(reference: megadetector/data_management/speciesnet_to_md.py; the
conversion itself lives in utils/wi_taxonomy_utils.py).

The port's own copy of megadetector_tpu/data_management/speciesnet_to_md.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import sys

from megadetector_tpu_torch.utils.wi_taxonomy_utils import \
    generate_md_results_from_predictions_json


def main():
    parser = argparse.ArgumentParser(
        description='Convert SpeciesNet predictions.json to MD format')
    parser.add_argument('predictions_json_file')
    parser.add_argument('md_results_file')
    parser.add_argument('--base_folder', default=None,
                        help='leading string to remove from each path')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    generate_md_results_from_predictions_json(
        predictions_json_file=args.predictions_json_file,
        md_results_file=args.md_results_file,
        base_folder=args.base_folder)


if __name__ == '__main__':
    main()
