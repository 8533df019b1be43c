"""
Remap the category IDs in an MD results file to a target mapping.

Behavioral contract follows the reference
(megadetector/postprocessing/remap_detection_categories.py:25): every
category name in the input must exist in the target mapping (unless
extra categories are explicitly allowed); detections are rewritten to the
target IDs.

The port's own copy of
megadetector_tpu/postprocessing/remap_detection_categories.py: the same
public names, signatures, defaults and output bytes.
"""

import argparse
import json
import sys

from megadetector_tpu_torch.utils import ct_utils


def remap_detection_categories(input_file, output_file,
                               target_category_map,
                               extra_category_handling='error',
                               overwrite=True):
    """
    Rewrite detection category IDs so the output uses
    [target_category_map] ({id: name}). Returns the rewritten dict.
    """

    assert extra_category_handling in \
        ('error', 'drop', 'keep'), \
        'Illegal extra_category_handling {}'.format(
            extra_category_handling)

    if output_file is not None and not overwrite:
        import os
        assert not os.path.isfile(output_file), \
            'Output file {} exists (pass overwrite=True)'.format(
                output_file)

    with open(input_file) as f:
        data = json.load(f)

    source_categories = data['detection_categories']
    name_to_target_id = {v: k for k, v in target_category_map.items()}

    source_id_to_target_id = {}
    ids_to_drop = set()
    extra_target_ids = {}
    for source_id, name in source_categories.items():
        if name in name_to_target_id:
            source_id_to_target_id[source_id] = name_to_target_id[name]
        elif extra_category_handling == 'error':
            raise ValueError(
                'Category "{}" not present in the target mapping'.format(
                    name))
        elif extra_category_handling == 'drop':
            ids_to_drop.add(source_id)
        else:  # keep: assign new IDs after the target's max
            next_id = max([int(k) for k in target_category_map] +
                          [int(k) for k in extra_target_ids or ['0']]) + 1
            new_id = str(next_id)
            extra_target_ids[new_id] = name
            source_id_to_target_id[source_id] = new_id

    output_categories = dict(target_category_map)
    output_categories.update(extra_target_ids)

    for im in data['images']:
        detections = im.get('detections')
        if detections is None:
            continue
        new_detections = []
        for det in detections:
            if det['category'] in ids_to_drop:
                continue
            det['category'] = source_id_to_target_id[det['category']]
            new_detections.append(det)
        im['detections'] = new_detections

    data['detection_categories'] = output_categories

    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def main():
    parser = argparse.ArgumentParser(
        description='Remap detection categories in an MD results file')
    parser.add_argument('input_file')
    parser.add_argument('output_file')
    parser.add_argument('target_map',
                        help='JSON string or file with {id: name}')
    parser.add_argument('--extra_category_handling', default='error',
                        choices=['error', 'drop', 'keep'])

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    if args.target_map.endswith('.json'):
        with open(args.target_map) as f:
            target_map = json.load(f)
    else:
        target_map = json.loads(args.target_map)
    remap_detection_categories(
        args.input_file, args.output_file, target_map,
        extra_category_handling=args.extra_category_handling)


if __name__ == '__main__':
    main()
