"""
Convert COCO Camera Traps databases to the Wildlife Insights batch
upload format (reference: megadetector/data_management/cct_to_wi.py):
four CSVs (projects, cameras, deployments, images) following the WI
batch-upload template columns.

The port's own copy of megadetector_tpu/data_management/cct_to_wi.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import csv
import json
import os
import sys

PROJECT_COLUMNS = [
    'project_id', 'project_name', 'project_short_name',
    'project_objectives', 'project_species', 'project_species_individual',
    'project_sensor_layout', 'project_sensor_layout_targeted_type',
    'project_bait_use', 'project_bait_type', 'project_stratification',
    'project_stratification_type', 'project_sensor_method',
    'project_individual_animals', 'project_blank_images',
    'project_sensor_cluster', 'project_admin', 'project_admin_email',
    'country_code', 'embargo', 'initiative_id', 'metadata_license',
    'image_license',
]

CAMERA_COLUMNS = ['project_id', 'camera_id', 'make', 'model',
                  'serial_number', 'year_purchased']

DEPLOYMENT_COLUMNS = [
    'project_id', 'deployment_id', 'placename', 'longitude', 'latitude',
    'start_date', 'end_date', 'event_name', 'event_description',
    'event_type', 'bait_type', 'bait_description', 'feature_type',
    'feature_type_methodology', 'camera_id', 'quiet_period',
    'camera_functioning', 'sensor_height', 'height_other',
    'sensor_orientation', 'orientation_other', 'recorded_by',
]

IMAGE_COLUMNS = [
    'project_id', 'deployment_id', 'image_id', 'location',
    'identified_by', 'wi_taxon_id', 'class', 'order', 'family', 'genus',
    'species', 'common_name', 'uncertainty', 'timestamp',
    'number_of_objects', 'highlighted', 'age', 'sex', 'animal_recognizable',
    'individual_id', 'individual_animal_notes', 'markings',
]


def cct_to_wi(cct_file, taxonomy_file, output_dir, project_info=None,
              deployment_for_image=None):
    """
    Write WI batch-upload CSVs for a CCT database.

    Args:
        cct_file: CCT .json path or dict
        taxonomy_file: {common name: {common_name, wi_taxon_id, class,
            order, family, genus, species}} .json path or dict
        output_dir: destination for the four CSVs
        project_info: dict of PROJECT_COLUMNS values (project_id
            required; sensible blanks otherwise)
        deployment_for_image: callable mapping a CCT image dict to a
            deployment id (default: the image's 'location', else its
            top-level folder)

    Returns:
        dict with the four CSV paths.
    """

    if isinstance(cct_file, str):
        with open(cct_file) as f:
            cct = json.load(f)
    else:
        cct = cct_file
    if isinstance(taxonomy_file, str):
        with open(taxonomy_file) as f:
            taxonomy = json.load(f)
    else:
        taxonomy = taxonomy_file

    project_info = dict(project_info or {})
    project_info.setdefault('project_id', 'project_000')
    project_info.setdefault('project_name',
                            cct.get('info', {}).get('description',
                                                    'converted CCT'))
    project_id = project_info['project_id']

    if deployment_for_image is None:
        def deployment_for_image(im):
            loc = im.get('location')
            if loc is not None:
                return str(loc)
            top = im['file_name'].replace('\\', '/').split('/')[0]
            return top or 'deployment_000'

    os.makedirs(output_dir, exist_ok=True)
    cat_id_to_name = {c['id']: c['name'] for c in cct['categories']}
    image_id_to_category_names = {}
    image_id_to_count = {}
    for ann in cct['annotations']:
        name = cat_id_to_name[ann['category_id']]
        image_id_to_category_names.setdefault(
            ann['image_id'], set()).add(name)
        image_id_to_count[ann['image_id']] = \
            image_id_to_count.get(ann['image_id'], 0) + 1

    deployments = {}
    image_rows = []
    for im in cct['images']:
        deployment_id = deployment_for_image(im)
        deployments.setdefault(deployment_id, {
            'project_id': project_id,
            'deployment_id': deployment_id,
            'placename': deployment_id,
            'camera_id': 'camera_' + deployment_id,
            'camera_functioning': 'Camera Functioning',
        })
        names = sorted(image_id_to_category_names.get(im['id'],
                                                      {'blank'}))
        for name in names:
            tax = taxonomy.get(name, {})
            image_rows.append({
                'project_id': project_id,
                'deployment_id': deployment_id,
                'image_id': im['id'],
                'location': im['file_name'],
                'identified_by': 'converted from CCT',
                'wi_taxon_id': tax.get('wi_taxon_id', ''),
                'class': tax.get('class', ''),
                'order': tax.get('order', ''),
                'family': tax.get('family', ''),
                'genus': tax.get('genus', ''),
                'species': tax.get('species', ''),
                'common_name': tax.get('common_name', name),
                'timestamp': im.get('datetime', ''),
                'number_of_objects':
                    image_id_to_count.get(im['id'], 0),
            })

    def write_csv(name, columns, rows):
        path = os.path.join(output_dir, name)
        with open(path, 'w', newline='', encoding='utf-8') as f:
            writer = csv.DictWriter(f, fieldnames=columns,
                                    extrasaction='ignore')
            writer.writeheader()
            for row in rows:
                writer.writerow({c: row.get(c, '') for c in columns})
        return path

    cameras = [{'project_id': project_id,
                'camera_id': d['camera_id']}
               for d in deployments.values()]

    paths = {
        'projects': write_csv('projects.csv', PROJECT_COLUMNS,
                              [project_info]),
        'cameras': write_csv('cameras.csv', CAMERA_COLUMNS, cameras),
        'deployments': write_csv('deployments.csv', DEPLOYMENT_COLUMNS,
                                 list(deployments.values())),
        'images': write_csv('images.csv', IMAGE_COLUMNS, image_rows),
    }
    print('Wrote WI batch-upload CSVs to {}'.format(output_dir))
    return paths


def main():
    parser = argparse.ArgumentParser(
        description='Convert a CCT database to WI batch-upload CSVs')
    parser.add_argument('cct_file')
    parser.add_argument('taxonomy_file')
    parser.add_argument('output_dir')
    parser.add_argument('--project_id', default='project_000')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    cct_to_wi(args.cct_file, args.taxonomy_file, args.output_dir,
              project_info={'project_id': args.project_id})


if __name__ == '__main__':
    main()
