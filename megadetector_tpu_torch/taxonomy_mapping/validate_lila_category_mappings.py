"""
Confirm that every LILA dataset category has a mapping in the taxonomy
CSV.

The reference version is an interactive notebook-style script
(megadetector/taxonomy_mapping/validate_lila_category_mappings.py:40-83);
here the core check is a plain function over the two inputs so it can run
offline and under test:

  - dataset_to_categories: {dataset_name: [{'name': ...}, ...]}
    (the get-LILA-category-list output; '_bbox' dataset variants map to
    their base dataset)
  - taxonomy rows: the mapping CSV with dataset_name/query/
    scientific_name columns

The port's own copy of
megadetector_tpu/taxonomy_mapping/validate_lila_category_mappings.py:
the same public names, signatures, defaults and output bytes.
"""

import csv
import json
import sys


def load_taxonomy_queries(taxonomy_csv_path):
    """{('dataset:query').lower(): scientific_name_or_'unmapped'}."""

    out = {}
    with open(taxonomy_csv_path, newline='') as f:
        for row in csv.DictReader(f):
            key = '{}:{}'.format(row.get('dataset_name', ''),
                                 row.get('query', '')).lower()
            name = row.get('scientific_name') or ''
            out[key] = name if name and name != 'nan' else 'unmapped'
    return out


def validate_category_mappings(dataset_to_categories, query_to_name,
                               verbose=True):
    """
    Returns (missing, unmapped): [dataset:category] keys absent from the
    taxonomy, and keys present but with no scientific name.
    """

    missing = []
    unmapped = []
    for raw_name, categories in dataset_to_categories.items():
        dataset_name = raw_name.replace('_bbox', '')
        for c in categories:
            key = '{}:{}'.format(dataset_name, c['name']).lower()
            if key not in query_to_name:
                missing.append(key)
                if verbose:
                    print('Could not find mapping for {}'.format(key))
            elif query_to_name[key] == 'unmapped':
                unmapped.append(key)
    return missing, unmapped


def main():
    import argparse
    parser = argparse.ArgumentParser(
        description='Validate LILA category -> taxonomy mappings')
    parser.add_argument('dataset_to_categories_json',
                        help='output of the LILA category listing')
    parser.add_argument('taxonomy_csv')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    with open(args.dataset_to_categories_json) as f:
        dataset_to_categories = json.load(f)
    query_to_name = load_taxonomy_queries(args.taxonomy_csv)
    missing, unmapped = validate_category_mappings(
        dataset_to_categories, query_to_name)
    print('{} missing, {} unmapped'.format(len(missing), len(unmapped)))
    sys.exit(1 if missing else 0)


if __name__ == '__main__':
    main()
