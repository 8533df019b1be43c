"""
Convert a COCO(-CT) database to per-image labelme .json files.

Behavioral contract follows the reference
(megadetector/data_management/coco_to_labelme.py): one labelme file next
to each image, rectangle shapes from COCO absolute boxes.

The port's own copy of megadetector_tpu/data_management/coco_to_labelme.py:
the same public names, signatures, defaults and output bytes. No
progress bars: the card's machine is not promised tqdm.
"""

import argparse
import json
import os
import sys

from megadetector_tpu_torch.utils import ct_utils


def get_labelme_dict_for_image_from_coco_record(im, annotations,
                                                categories, info=None):
    """
    Reformat one COCO image record and its annotations into a labelme
    dict suitable for writing to a labelme .json file (reference:
    coco_to_labelme.py:29-96). [im] requires 'height' and 'width';
    every annotation must refer to im['id']. [info] lands in a
    non-standard 'custom_info' field; the COCO categories are stored in
    'coco_categories' so original IDs can be reconstructed later.
    """

    output_dict = {}
    if info is not None:
        output_dict['custom_info'] = info
    output_dict['version'] = '5.3.0a0'
    output_dict['flags'] = im.get('flags', {})
    output_dict['shapes'] = []
    output_dict['imagePath'] = os.path.basename(im['file_name'])
    output_dict['imageHeight'] = im['height']
    output_dict['imageWidth'] = im['width']
    output_dict['imageData'] = None
    output_dict['coco_categories'] = categories

    category_id_to_name = {c['id']: c['name'] for c in categories}

    for ann in annotations:
        assert ann['image_id'] == im['id'], \
            'Annotation {} does not refer to image {}'.format(
                ann.get('id'), im['id'])
        if 'bbox' not in ann or ann['bbox'] is None:
            continue
        # COCO boxes are [x_min, y_min, w, h] absolute; labelme boxes
        # are [[x0, y0], [x1, y1]] absolute
        x, y, w, h = ann['bbox']
        output_dict['shapes'].append({
            'label': category_id_to_name[ann['category_id']],
            'shape_type': 'rectangle',
            'description': '',
            'group_id': None,
            'points': [[x, y], [x + w, y + h]],
            'flags': {},
        })
    return output_dict


def coco_to_labelme(coco_file, image_folder, overwrite=False,
                    verbose=False):
    """
    Write labelme .json files next to the images named in [coco_file].
    Returns the list of files written.
    """

    if isinstance(coco_file, str):
        with open(coco_file) as f:
            coco = json.load(f)
    else:
        coco = coco_file

    image_id_to_anns = {}
    for ann in coco.get('annotations', []):
        image_id_to_anns.setdefault(ann['image_id'], []).append(ann)

    files_written = []
    for im in coco['images']:
        fn = im['file_name']
        width = im.get('width')
        height = im.get('height')
        if width is None or height is None:
            try:
                from PIL import Image
                with Image.open(os.path.join(image_folder, fn)) as pil_im:
                    width, height = pil_im.size
            except Exception:
                continue

        im_for_record = dict(im)
        im_for_record['height'] = height
        im_for_record['width'] = width
        labelme = get_labelme_dict_for_image_from_coco_record(
            im_for_record, image_id_to_anns.get(im['id'], []),
            coco.get('categories', []))
        labelme_path = os.path.join(
            image_folder, os.path.splitext(fn)[0] + '.json')
        if os.path.isfile(labelme_path) and not overwrite:
            continue
        ct_utils.write_json(labelme_path, labelme)
        files_written.append(labelme_path)

    return files_written


def main():
    parser = argparse.ArgumentParser(
        description='Convert a COCO database to labelme files')
    parser.add_argument('coco_file')
    parser.add_argument('image_folder')
    parser.add_argument('--overwrite', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    coco_to_labelme(args.coco_file, args.image_folder,
                    overwrite=args.overwrite)


if __name__ == '__main__':
    main()
