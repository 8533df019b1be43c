"""
CLI: build the per-image labels table for a LILA dataset (reference:
megadetector/data_management/lila/generate_lila_per_image_labels.py;
the logic lives in lila_common).

The port's own copy of
megadetector_tpu/data_management/lila/generate_lila_per_image_labels.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import sys

from megadetector_tpu_torch.data_management.lila.lila_common import (
    generate_lila_per_image_labels, get_lila_dataset_index,
    read_metadata_file_for_dataset)


def main():
    parser = argparse.ArgumentParser(
        description='Generate the per-image label table for a LILA '
                    'dataset')
    parser.add_argument('dataset_name')
    parser.add_argument('output_file')
    parser.add_argument('--metadata_dir', default=None)
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()

    index = get_lila_dataset_index(metadata_dir=args.metadata_dir)
    assert args.dataset_name in index
    cct = read_metadata_file_for_dataset(index[args.dataset_name],
                                         args.metadata_dir)
    generate_lila_per_image_labels(cct, output_file=args.output_file)


if __name__ == '__main__':
    main()
