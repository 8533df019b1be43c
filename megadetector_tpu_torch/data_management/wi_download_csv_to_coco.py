"""
Convert Wildlife Insights project-export CSVs to COCO Camera Traps
(reference: megadetector/data_management/wi_download_csv_to_coco.py:93).

The port's own copy of
megadetector_tpu/data_management/wi_download_csv_to_coco.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import csv
import os
import sys

from collections import defaultdict

from megadetector_tpu_torch.utils import ct_utils

# WI export common-name cleanups applied before categorization
default_category_remappings = {
    'blank': 'empty',
    'no cv result': 'empty',
    'unknown': 'unknown',
    'homo sapiens': 'human',
    'human': 'human',
}


def _read_export_rows(csv_file_in):
    """Rows from one images*.csv file or every images*.csv in a
    folder."""

    if os.path.isdir(csv_file_in):
        files = sorted(
            os.path.join(csv_file_in, fn)
            for fn in os.listdir(csv_file_in)
            if fn.lower().startswith('images') and
            fn.lower().endswith('.csv'))
        assert files, 'No images*.csv files in {}'.format(csv_file_in)
    else:
        files = [csv_file_in]

    rows = []
    for fn in files:
        with open(fn, newline='', encoding='utf-8') as f:
            rows.extend(csv.DictReader(f))
    return rows


def _flatten_location(row, image_flattening):
    url = (row.get('location') or row.get('image_id') or '') \
        .replace('gs://', '')
    guid = os.path.basename(url) or '{}.JPG'.format(
        row.get('image_id', 'unknown'))
    deployment = row.get('deployment_id', 'unknown-deployment')
    project = row.get('project_id', 'unknown-project')
    if image_flattening == 'none':
        return url or guid
    if image_flattening == 'guid':
        return guid
    if image_flattening == 'deployment':
        return '{}/{}'.format(deployment, guid)
    assert image_flattening == 'project'
    return '{}/{}/{}'.format(project, deployment, guid)


def wi_download_csv_to_coco(csv_file_in, coco_file_out=None,
                            image_folder=None,
                            exclude_missing_images=False,
                            image_flattening='deployment',
                            category_remappings=None,
                            blank_disagreement_handling='trust_label',
                            include_blanks=True,
                            verbose=False):
    """
    WI export CSV(s) -> CCT dict. Columns used: project_id,
    deployment_id, image_id/location, common_name, is_blank,
    timestamp. Returns the COCO dict.
    """

    assert blank_disagreement_handling in (
        'trust_label', 'trust_is_blank', 'error')
    if category_remappings is None:
        category_remappings = default_category_remappings

    rows = _read_export_rows(csv_file_in)

    images = {}
    categories = {'empty': 0}
    annotations = []
    n_blank_disagreements = 0

    for row in rows:
        file_name = _flatten_location(row, image_flattening)
        if exclude_missing_images:
            assert image_folder is not None, \
                'exclude_missing_images requires image_folder'
            if not os.path.isfile(
                    os.path.join(image_folder, file_name)):
                continue

        common_name = (row.get('common_name') or '').strip().lower()
        is_blank = str(row.get('is_blank', '')).strip() in ('1', 'true',
                                                            'True')
        category_name = category_remappings.get(common_name,
                                                common_name) or 'empty'

        if is_blank and category_name != 'empty':
            n_blank_disagreements += 1
            if blank_disagreement_handling == 'error':
                raise ValueError(
                    'is_blank disagrees with label {} for {}'.format(
                        common_name, file_name))
            if blank_disagreement_handling == 'trust_is_blank':
                category_name = 'empty'

        if category_name == 'empty' and not include_blanks:
            continue

        image_id = file_name
        if image_id not in images:
            im = {'id': image_id, 'file_name': file_name,
                  'location': row.get('deployment_id', 'unknown')}
            if row.get('timestamp'):
                im['datetime'] = row['timestamp']
            images[image_id] = im

        if category_name not in categories:
            categories[category_name] = len(categories)
        annotations.append({
            'id': 'ann_{:06d}'.format(len(annotations)),
            'image_id': image_id,
            'category_id': categories[category_name],
        })

    if verbose and n_blank_disagreements:
        print('{} is_blank/label disagreements'.format(
            n_blank_disagreements))

    coco = {
        'info': {'description':
                 'Converted from WI download: {}'.format(csv_file_in)},
        'images': sorted(images.values(), key=lambda im: im['id']),
        'annotations': annotations,
        'categories': [{'id': v, 'name': k}
                       for k, v in sorted(categories.items(),
                                          key=lambda kv: kv[1])],
    }
    if coco_file_out is not None:
        ct_utils.write_json(coco_file_out, coco, force_str=True)
    return coco


def main():
    parser = argparse.ArgumentParser(
        description='Convert a WI project-export CSV to COCO Camera '
                    'Traps')
    parser.add_argument('csv_file_in')
    parser.add_argument('coco_file_out')
    parser.add_argument('--image_flattening', default='deployment',
                        choices=['none', 'guid', 'deployment',
                                 'project'])
    parser.add_argument('--exclude_blanks', action='store_true')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    wi_download_csv_to_coco(args.csv_file_in, args.coco_file_out,
                            image_flattening=args.image_flattening,
                            include_blanks=not args.exclude_blanks)


if __name__ == '__main__':
    main()
