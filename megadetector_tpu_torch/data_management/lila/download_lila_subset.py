"""
CLI: download a species-filtered subset of a LILA dataset (reference:
megadetector/data_management/lila/download_lila_subset.py; the logic
lives in lila_common).

The port's own copy of
megadetector_tpu/data_management/lila/download_lila_subset.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import sys

from megadetector_tpu_torch.data_management.lila.lila_common import (
    download_lila_subset, get_lila_dataset_index,
    read_metadata_file_for_dataset, select_lila_images_by_species)


def find_items(row, species_of_interest, ds_name_to_urls,
               common_name_to_count=None, preferred_provider='gcp'):
    """
    Row filter over the LILA combined per-image-labels table
    (reference: download_lila_subset.py:64-83): when the row's
    common_name contains any name in [species_of_interest], append the
    row's preferred-provider URL to ds_name_to_urls[dataset_name] and
    bump common_name_to_count. Apply with df.apply(..., axis=1).
    """

    common_name = row.get('common_name')
    if common_name is None or (isinstance(common_name, float)):
        return
    for species_name in species_of_interest:
        if species_name in common_name:
            if common_name_to_count is not None:
                common_name_to_count[species_name] = \
                    common_name_to_count.get(species_name, 0) + 1
            ds_name_to_urls.setdefault(row['dataset_name'], []).append(
                row['url_' + preferred_provider])
            return


def find_images_for_species(df, species_of_interest,
                            preferred_provider='gcp'):
    """
    Returns ({dataset_name: [urls]}, {species: count}) for every row of
    [df] whose common_name matches a species of interest (the driver
    around find_items in the reference, download_lila_subset.py:82-91).
    """

    ds_name_to_urls = {}
    common_name_to_count = {}
    for _, row in df.iterrows():
        find_items(row, species_of_interest, ds_name_to_urls,
                   common_name_to_count, preferred_provider)
    return ds_name_to_urls, common_name_to_count


def main():
    parser = argparse.ArgumentParser(
        description='Download all images of given species from a LILA '
                    'dataset')
    parser.add_argument('dataset_name')
    parser.add_argument('output_folder')
    parser.add_argument('--species', nargs='+', required=True)
    parser.add_argument('--metadata_dir', default=None)
    parser.add_argument('--n_workers', type=int, default=8)
    parser.add_argument('--max_images', type=int, default=None)
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()

    index = get_lila_dataset_index(metadata_dir=args.metadata_dir)
    assert args.dataset_name in index, \
        'Unknown dataset {} (available: {})'.format(
            args.dataset_name, ', '.join(sorted(index)))
    entry = index[args.dataset_name]
    cct = read_metadata_file_for_dataset(entry, args.metadata_dir)
    image_files = select_lila_images_by_species(cct, args.species)
    if args.max_images is not None:
        image_files = image_files[:args.max_images]
    print('Downloading {} images'.format(len(image_files)))
    download_lila_subset(entry, image_files, args.output_folder,
                         n_workers=args.n_workers)


if __name__ == '__main__':
    main()
