"""
Integrity checks for COCO Camera Traps databases: ID uniqueness,
annotation/image/category cross-references, bbox sanity, optional image
existence / size validation.

Behavioral contract follows the reference
(megadetector/data_management/integrity_check_json_db.py:131).

The port's own copy of
megadetector_tpu/data_management/integrity_check_json_db.py: the same public
names, signatures, defaults and output bytes.
"""

import argparse
import json
import os
import sys

from collections import defaultdict

from megadetector_tpu_torch.utils import ct_utils


class IntegrityCheckOptions:
    """Options controlling integrity_check_json_db()."""

    def __init__(self):
        self.baseDir = ''
        self.bCheckImageSizes = False
        self.bCheckImageExistence = False
        self.bFindUnusedImages = False
        self.bRequireLocation = False
        self.iMaxNumImages = -1
        self.verbose = True


def integrity_check_json_db(json_file, options=None):
    """
    Validate a CCT .json database. Returns
    (sorted_categories, data, error_info) where sorted_categories is a
    list of {'name', 'count'} sorted descending by count.
    Raises on structural errors.
    """

    if options is None:
        options = IntegrityCheckOptions()

    if isinstance(json_file, str):
        with open(json_file) as f:
            data = json.load(f)
    else:
        data = json_file

    for field in ('images', 'annotations', 'categories'):
        assert field in data, 'Missing field {}'.format(field)

    images = data['images']
    annotations = data['annotations']
    categories = data['categories']

    if options.iMaxNumImages > 0:
        images = images[:options.iMaxNumImages]

    error_info = {'validation_errors': [], 'unused_images': []}

    # --- Category checks
    cat_id_to_cat = {}
    for cat in categories:
        assert 'id' in cat and 'name' in cat, 'Invalid category'
        assert cat['id'] not in cat_id_to_cat, \
            'Duplicate category id {}'.format(cat['id'])
        cat_id_to_cat[cat['id']] = cat

    # --- Image checks
    image_id_to_image = {}
    for im in images:
        assert 'id' in im and 'file_name' in im, 'Invalid image'
        assert im['id'] not in image_id_to_image, \
            'Duplicate image id {}'.format(im['id'])
        image_id_to_image[im['id']] = im
        if options.bRequireLocation:
            assert im.get('location') is not None, \
                'Image {} has no location'.format(im['id'])
        if options.bCheckImageExistence:
            full_path = os.path.join(options.baseDir, im['file_name'])
            if not os.path.isfile(full_path):
                error_info['validation_errors'].append(
                    'Image {} does not exist'.format(full_path))
        if options.bCheckImageSizes:
            full_path = os.path.join(options.baseDir, im['file_name'])
            try:
                from PIL import Image
                with Image.open(full_path) as pil_im:
                    w, h = pil_im.size
                if im.get('width') is not None and im['width'] != w:
                    error_info['validation_errors'].append(
                        'Width mismatch for {}'.format(im['id']))
                if im.get('height') is not None and im['height'] != h:
                    error_info['validation_errors'].append(
                        'Height mismatch for {}'.format(im['id']))
            except Exception:
                error_info['validation_errors'].append(
                    'Cannot read image {}'.format(full_path))

    # --- Annotation checks
    cat_id_to_count = defaultdict(int)
    image_ids_with_annotations = set()
    ann_ids = set()
    for ann in annotations:
        assert 'id' in ann and 'image_id' in ann and \
            'category_id' in ann, 'Invalid annotation'
        assert ann['id'] not in ann_ids, \
            'Duplicate annotation id {}'.format(ann['id'])
        ann_ids.add(ann['id'])
        assert ann['category_id'] in cat_id_to_cat, \
            'Annotation {} references unknown category {}'.format(
                ann['id'], ann['category_id'])
        if options.iMaxNumImages <= 0:
            assert ann['image_id'] in image_id_to_image, \
                'Annotation {} references unknown image {}'.format(
                    ann['id'], ann['image_id'])
        cat_id_to_count[ann['category_id']] += 1
        image_ids_with_annotations.add(ann['image_id'])

        bbox = ann.get('bbox')
        if bbox is not None:
            assert len(bbox) == 4, \
                'Invalid bbox in annotation {}'.format(ann['id'])
            if bbox[2] < 0 or bbox[3] < 0:
                error_info['validation_errors'].append(
                    'Negative bbox size in annotation {}'.format(
                        ann['id']))

    if options.bFindUnusedImages:
        for im in images:
            if im['id'] not in image_ids_with_annotations:
                error_info['unused_images'].append(im['file_name'])

    sorted_categories = sorted(
        [{'name': cat_id_to_cat[cat_id]['name'], 'id': cat_id,
          'count': count}
         for cat_id, count in cat_id_to_count.items()],
        key=lambda c: c['count'], reverse=True)

    if options.verbose:
        print('Database integrity check: {} images, {} annotations, '
              '{} categories, {} errors'.format(
                  len(images), len(annotations), len(categories),
                  len(error_info['validation_errors'])))
        for c in sorted_categories:
            print('  {}: {}'.format(c['name'], c['count']))

    return sorted_categories, data, error_info


def main():
    parser = argparse.ArgumentParser(
        description='Integrity-check a COCO Camera Traps database')
    parser.add_argument('json_file')
    parser.add_argument('--baseDir', default='')
    parser.add_argument('--bCheckImageSizes', action='store_true')
    parser.add_argument('--bCheckImageExistence', action='store_true')
    parser.add_argument('--bFindUnusedImages', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = IntegrityCheckOptions()
    ct_utils.args_to_object(args, options)
    integrity_check_json_db(args.json_file, options)


if __name__ == '__main__':
    main()
