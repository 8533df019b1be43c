"""
Convert a Camtrap DP 1.0 package to a COCO camera-traps .json database
(reference: megadetector/data_management/camtrap_dp_to_coco.py:33-186).
Distinct from importers.camtrap_dp_to_md, which emits MD *results*
format: this produces a COCO training/eval database with event-level
(sequence-level) annotations, frame numbering within events, and an
'empty' category at id 0.

The port's own copy of megadetector_tpu/data_management/camtrap_dp_to_coco.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import csv
import json
import os
import sys

from collections import defaultdict

from megadetector_tpu_torch.data_management.cct_json_utils import \
    parse_datetime_string

CAMTRAP_DP_PROFILE = ('https://raw.githubusercontent.com/tdwg/'
                      'camtrap-dp/1.0/camtrap-dp-profile.json')


def _read_csv_rows(path):
    with open(path, newline='', encoding='utf-8') as f:
        return list(csv.DictReader(f))


def camtrap_dp_to_coco(camtrap_dp_folder, output_file=None):
    """
    Convert the Camtrap DP package in [camtrap_dp_folder] to COCO.
    Does not validate images, just converts; use
    integrity_check_json_db to validate the result. Optionally writes
    to [output_file]. Returns the COCO dict.
    """

    required_files = ('datapackage.json', 'deployments.csv',
                      'events.csv', 'media.csv', 'observations.csv')
    for fn in required_files:
        fn_abs = os.path.join(camtrap_dp_folder, fn)
        assert os.path.isfile(fn_abs), \
            'Could not find required file {}'.format(fn_abs)

    with open(os.path.join(camtrap_dp_folder, 'datapackage.json'),
              'r') as f:
        datapackage = json.load(f)
    assert datapackage.get('profile') == CAMTRAP_DP_PROFILE, \
        'I only know how to parse Camtrap DP 1.0 packages'

    resource_paths = {r['name']: r['path']
                      for r in datapackage.get('resources', [])}
    for name in ('deployments', 'events', 'media', 'observations'):
        assert name in resource_paths, \
            'No {} file specified'.format(name)

    events_rows = _read_csv_rows(
        os.path.join(camtrap_dp_folder, resource_paths['events']))
    media_rows = _read_csv_rows(
        os.path.join(camtrap_dp_folder, resource_paths['media']))
    observations_rows = _read_csv_rows(
        os.path.join(camtrap_dp_folder, resource_paths['observations']))

    media_id_to_media_info = {}
    for row in media_rows:
        media_id_to_media_info[row['mediaID']] = {
            'file_name': os.path.join(
                row['filePath'], row['fileName']).replace('\\', '/'),
            'location': row['deploymentID'],
            'id': row['mediaID'],
            'datetime': parse_datetime_string(row['timestamp']) or
            row['timestamp'],
            'frame_num': -1,
            'seq_num_frames': -1,
        }

    event_id_to_media_ids = defaultdict(list)
    for row in events_rows:
        media_id = row['mediaID']
        assert media_id in media_id_to_media_info
        event_id_to_media_ids[row['eventID']].append(media_id)

    event_id_to_category_names = defaultdict(set)
    for row in observations_rows:
        if row['observationLevel'] != 'event':
            raise ValueError(
                "I don't know how to parse image-level events yet")
        if row['observationType'] == 'blank':
            event_id_to_category_names[row['eventID']].add('empty')
        elif row['observationType'] == 'unknown':
            event_id_to_category_names[row['eventID']].add('unknown')
        elif row['observationType'] == 'human':
            assert row['scientificName'] == 'Homo sapiens'
            event_id_to_category_names[row['eventID']].add(
                row['scientificName'])
        else:
            assert row['observationType'] == 'animal'
            assert row['scientificName']
            event_id_to_category_names[row['eventID']].add(
                row['scientificName'])

    # Sort images within an event into frame numbers
    for event_id, media_ids in event_id_to_media_ids.items():
        media_info_this_event = sorted(
            (media_id_to_media_info[m] for m in media_ids),
            key=lambda x: str(x['datetime']))
        for i_media, media_info in enumerate(media_info_this_event):
            media_info['frame_num'] = i_media
            media_info['seq_num_frames'] = len(media_info_this_event)
            media_info['seq_id'] = event_id

    # Category IDs: 'empty' is always 0
    category_name_to_category_id = {'empty': 0}
    for event_id in event_id_to_category_names:
        for name in event_id_to_category_names[event_id]:
            if name not in category_name_to_category_id:
                category_name_to_category_id[name] = \
                    len(category_name_to_category_id)

    annotations = []
    for event_id, media_ids in event_id_to_media_ids.items():
        i_ann = 0
        for media_id in media_ids:
            im = media_id_to_media_info[media_id]
            for category_name in event_id_to_category_names[event_id]:
                annotations.append({
                    'id': '{}_{}'.format(event_id, i_ann),
                    'image_id': im['id'],
                    'category_id':
                        category_name_to_category_id[category_name],
                    'sequence_level_annotation': True,
                })
                i_ann += 1

    coco_data = {
        'images': list(media_id_to_media_info.values()),
        'annotations': annotations,
        'categories': [{'name': name, 'id': cat_id} for name, cat_id
                       in category_name_to_category_id.items()],
        'info': {'version': 1.0,
                 'description': datapackage.get('name', '')},
    }
    for im in coco_data['images']:
        im['datetime'] = str(im['datetime'])

    if output_file is not None:
        with open(output_file, 'w') as f:
            json.dump(coco_data, f, indent=1, default=str)
    return coco_data


def main():
    parser = argparse.ArgumentParser(
        description='Convert a Camtrap DP package to a COCO camera '
                    'traps .json file')
    parser.add_argument('camtrap_dp_folder', type=str)
    parser.add_argument('output_file', type=str)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    camtrap_dp_to_coco(args.camtrap_dp_folder, args.output_file)


if __name__ == '__main__':
    main()
