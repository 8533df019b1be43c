"""
Convert a YOLO-format dataset (label .txt files + class list) to a COCO
Camera Traps database.

Behavioral contract follows the reference
(megadetector/data_management/yolo_to_coco.py:428, validation :297):
normalized center-format YOLO rows become absolute COCO [x, y, w, h];
images without label files are included with no annotations; a basic
dataset validation pass reports missing/extra label files.

The port's own copy of megadetector_tpu/data_management/yolo_to_coco.py:
the same public names, signatures, defaults and output bytes. No
progress bars: the card's machine is not promised tqdm.
"""

import argparse
import json
import os
import sys

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils import path_utils


def load_yolo_class_list(class_file):
    """Read classes.txt (one name per line) or a YOLO dataset.yaml."""

    if class_file.endswith(('.yaml', '.yml')):
        names = {}
        in_names = False
        with open(class_file) as f:
            for line in f:
                stripped = line.strip()
                if stripped.startswith('names:'):
                    in_names = True
                    continue
                if in_names:
                    if not line.startswith((' ', '\t')) or not stripped:
                        break
                    if ':' in stripped:
                        k, v = stripped.split(':', 1)
                        names[int(k.strip())] = v.strip()
        return [names[i] for i in sorted(names)]
    with open(class_file) as f:
        return [line.strip() for line in f if len(line.strip()) > 0]


def validate_label_file(label_file, category_id_to_name=None,
                        verbose=False):
    """
    Verify one YOLO label .txt: five tokens per line, known category
    IDs (when a mapping is given), and in-bounds normalized boxes
    (reference: yolo_to_coco.py:218-294). Returns
    {'file': ..., 'errors': [...]}.
    """

    label_result = {'file': label_file, 'errors': []}
    try:
        with open(label_file) as f:
            lines = f.readlines()
    except Exception as e:
        label_result['errors'].append('Read error: {}'.format(e))
        return label_result

    for i_line, line in enumerate(lines):
        s = line.strip()
        if len(s) == 0 or s[0] == '#':
            continue
        try:
            tokens = s.split()
            assert len(tokens) == 5, \
                'YOLO label lines should have five tokens, found ' \
                '{}'.format(len(tokens))
            if category_id_to_name is not None:
                category_id = int(tokens[0])
                assert category_id in category_id_to_name, \
                    'Unrecognized category ID {}'.format(category_id)
            yolo_bbox = [float(x) for x in tokens[1:]]
        except Exception as e:
            label_result['errors'].append(
                'Token error at line {}: {}'.format(i_line, e))
            continue

        x_center, y_center, width, height = yolo_bbox
        x_min, x_max = x_center - width / 2.0, x_center + width / 2.0
        y_min, y_max = y_center - height / 2.0, y_center + height / 2.0
        if x_min < 0 or y_min < 0 or x_max > 1 or y_max > 1:
            label_result['errors'].append(
                'Invalid bounding box: {} {} {} {}'.format(
                    x_min, y_min, x_max, y_max))

    if verbose and label_result['errors']:
        print('Errors for {}:'.format(label_file))
        for error in label_result['errors']:
            print(error)
    return label_result


def validate_yolo_dataset(image_folder, class_file=None, recursive=True):
    """
    Basic dataset validation: every image should have at most one label
    file; labels without images are flagged. Returns a dict of issues.
    """

    images = path_utils.find_images(image_folder, recursive=recursive,
                                    return_relative_paths=True)
    labels = [fn for fn in path_utils.recursive_file_list(
        image_folder, return_relative_paths=True, recursive=recursive)
        if fn.endswith('.txt')]

    image_bases = set(os.path.splitext(fn)[0] for fn in images)
    label_bases = set(os.path.splitext(fn)[0] for fn in labels)

    # Per-file content validation (token counts, category IDs, box
    # bounds; reference validates every label file at
    # yolo_to_coco.py:297-360)
    category_id_to_name = None
    if class_file is not None:
        category_id_to_name = dict(
            enumerate(load_yolo_class_list(class_file)))
    label_errors = []
    for fn in labels:
        result = validate_label_file(
            os.path.join(image_folder, fn),
            category_id_to_name=category_id_to_name)
        if result['errors']:
            result['file'] = fn
            label_errors.append(result)

    return {
        'images_without_labels': sorted(image_bases - label_bases),
        'labels_without_images': sorted(label_bases - image_bases),
        'label_errors': label_errors,
        'n_images': len(images),
        'n_labels': len(labels),
    }


def yolo_to_coco(input_folder, class_name_file, output_file=None,
                 empty_image_handling='no_annotations',
                 error_image_handling='no_annotations',
                 recursive=True):
    """
    Convert a YOLO dataset folder to a COCO dict; writes [output_file]
    when given.

    empty_image_handling: 'no_annotations' | 'empty_annotations' (adds an
    annotation with an 'empty' category and no bbox) | 'skip'
    """

    assert empty_image_handling in \
        ('no_annotations', 'empty_annotations', 'skip')

    class_list = load_yolo_class_list(class_name_file)

    categories = [{'id': i, 'name': name}
                  for i, name in enumerate(class_list)]
    empty_category_id = None
    if empty_image_handling == 'empty_annotations':
        empty_category_id = len(class_list)
        categories.append({'id': empty_category_id, 'name': 'empty'})

    images = []
    annotations = []
    next_ann_id = 0

    from PIL import Image

    image_files = path_utils.find_images(
        input_folder, recursive=recursive, return_relative_paths=True)

    for fn in image_files:

        image_path = os.path.join(input_folder, fn)
        try:
            with Image.open(image_path) as pil_im:
                img_w, img_h = pil_im.size
        except Exception:
            if error_image_handling == 'skip':
                continue
            img_w, img_h = None, None

        label_fn = os.path.join(input_folder,
                                os.path.splitext(fn)[0] + '.txt')
        rows = []
        if os.path.isfile(label_fn):
            with open(label_fn) as f:
                for line in f:
                    tokens = line.strip().split()
                    if len(tokens) >= 5:
                        rows.append((int(tokens[0]),
                                     *[float(t) for t in tokens[1:5]]))

        if len(rows) == 0 and empty_image_handling == 'skip':
            continue

        im = {'id': fn, 'file_name': fn, 'width': img_w, 'height': img_h}
        images.append(im)

        if len(rows) == 0:
            if empty_image_handling == 'empty_annotations':
                annotations.append({'id': next_ann_id, 'image_id': fn,
                                    'category_id': empty_category_id,
                                    'sequence_level_annotation': False})
                next_ann_id += 1
            continue

        for (class_idx, cx, cy, w, h) in rows:
            if img_w is not None and img_h is not None:
                bbox = [(cx - w / 2.0) * img_w, (cy - h / 2.0) * img_h,
                        w * img_w, h * img_h]
            else:
                bbox = [cx - w / 2.0, cy - h / 2.0, w, h]
            annotations.append({
                'id': next_ann_id,
                'image_id': fn,
                'category_id': class_idx,
                'bbox': bbox,
                'area': bbox[2] * bbox[3],
                'iscrowd': 0,
                'sequence_level_annotation': False,
            })
            next_ann_id += 1

    coco = {'images': images, 'annotations': annotations,
            'categories': categories,
            'info': {'description':
                     'Converted from YOLO dataset {}'.format(
                         input_folder)}}

    if output_file is not None:
        ct_utils.write_json(output_file, coco, force_str=True)
    return coco


def main():
    parser = argparse.ArgumentParser(
        description='Convert a YOLO dataset to COCO format')
    parser.add_argument('input_folder')
    parser.add_argument('class_name_file')
    parser.add_argument('output_file')
    parser.add_argument('--empty_image_handling',
                        default='no_annotations')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    yolo_to_coco(args.input_folder, args.class_name_file,
                 args.output_file,
                 empty_image_handling=args.empty_image_handling)


if __name__ == '__main__':
    main()
