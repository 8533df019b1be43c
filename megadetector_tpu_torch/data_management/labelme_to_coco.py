"""
Convert a folder of labelme .json annotation files to a COCO Camera Traps
database.

Behavioral contract follows the reference
(megadetector/data_management/labelme_to_coco.py): one labelme .json per
image (rectangle shapes, absolute pixel points), categories collected from
shape labels, images without .json files optionally included as empty.

The port's own copy of megadetector_tpu/data_management/labelme_to_coco.py:
the same public names, signatures, defaults and output bytes. No
progress bars: the card's machine is not promised tqdm.
"""

import argparse
import json
import os
import sys

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils.path_utils import find_images


def labelme_to_coco(input_folder, output_file=None,
                    category_id_to_category_name=None,
                    empty_category_name='empty',
                    include_images_without_labels=True,
                    recursive=True,
                    use_folders_as_labels=False,
                    validate_image_sizes=False):
    """
    Convert labelme annotations under [input_folder] to a COCO dict;
    writes [output_file] when given.
    """

    image_files = find_images(input_folder, recursive=recursive,
                              return_relative_paths=True)

    category_name_to_id = {}
    if category_id_to_category_name is not None:
        for cat_id, name in category_id_to_category_name.items():
            category_name_to_id[name] = int(cat_id)

    def get_category_id(name):
        if name not in category_name_to_id:
            next_id = max(category_name_to_id.values(), default=-1) + 1
            category_name_to_id[name] = next_id
        return category_name_to_id[name]

    # The empty category is conventionally id 0
    get_category_id(empty_category_name)

    images = []
    annotations = []
    next_ann_id = 0

    for fn in image_files:

        labelme_file = os.path.join(input_folder,
                                    os.path.splitext(fn)[0] + '.json')
        im = {'id': fn, 'file_name': fn}

        if not os.path.isfile(labelme_file):
            if not include_images_without_labels:
                continue
            images.append(im)
            continue

        try:
            with open(labelme_file) as f:
                labelme = json.load(f)
        except Exception as e:
            print('Warning: error reading {}: {}'.format(labelme_file, e))
            continue

        im['width'] = labelme.get('imageWidth')
        im['height'] = labelme.get('imageHeight')
        images.append(im)

        shapes = labelme.get('shapes', [])
        if len(shapes) == 0:
            annotations.append({'id': next_ann_id, 'image_id': fn,
                                'category_id': get_category_id(
                                    empty_category_name)})
            next_ann_id += 1
            continue

        for shape in shapes:
            if shape.get('shape_type') != 'rectangle':
                continue
            label = os.path.dirname(fn) if use_folders_as_labels \
                else shape['label']
            points = shape['points']
            xs = [p[0] for p in points]
            ys = [p[1] for p in points]
            x0, x1 = min(xs), max(xs)
            y0, y1 = min(ys), max(ys)
            ann = {'id': next_ann_id, 'image_id': fn,
                   'category_id': get_category_id(label),
                   'bbox': [x0, y0, x1 - x0, y1 - y0],
                   'area': (x1 - x0) * (y1 - y0), 'iscrowd': 0}
            if 'conf' in shape:
                ann['conf'] = shape['conf']
            annotations.append(ann)
            next_ann_id += 1

    categories = [{'id': cat_id, 'name': name}
                  for name, cat_id in category_name_to_id.items()]
    categories = sorted(categories, key=lambda c: c['id'])

    coco = {'images': images, 'annotations': annotations,
            'categories': categories,
            'info': {'description': 'Converted from labelme folder '
                     '{}'.format(input_folder)}}
    if output_file is not None:
        ct_utils.write_json(output_file, coco, force_str=True)
    return coco


def find_empty_labelme_files(input_folder, recursive=True):
    """
    Partition a labelme folder's images into those whose .json has no
    shapes, those with no .json, and those with boxes
    (reference: labelme_to_coco.py:471-532). Returns a dict with keys
    'images_with_empty_json_files', 'images_with_no_json_files',
    'images_with_non_empty_json_files'.
    """

    image_filenames_relative = find_images(
        input_folder, recursive=recursive, return_relative_paths=True)

    empty_json, no_json, non_empty_json = [], [], []
    for fn_relative in image_filenames_relative:
        json_fn_abs = os.path.splitext(
            os.path.join(input_folder, fn_relative))[0] + '.json'
        if not os.path.isfile(json_fn_abs):
            no_json.append(fn_relative)
            continue
        with open(json_fn_abs) as f:
            labelme_data = json.load(f)
        if len(labelme_data['shapes']) == 0:
            empty_json.append(fn_relative)
        else:
            non_empty_json.append(fn_relative)

    return {'images_with_empty_json_files': empty_json,
            'images_with_no_json_files': no_json,
            'images_with_non_empty_json_files': non_empty_json}


def main():
    parser = argparse.ArgumentParser(
        description='Convert labelme annotations to COCO format')
    parser.add_argument('input_folder')
    parser.add_argument('output_file')
    parser.add_argument('--no_empty_images', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    labelme_to_coco(args.input_folder, args.output_file,
                    include_images_without_labels=not args.no_empty_images)


if __name__ == '__main__':
    main()
