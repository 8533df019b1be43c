"""
Convert YOLO-format prediction outputs (val .json / per-image .txt label
files) to the MD results format.

Behavioral contract follows the reference
(megadetector/data_management/yolo_output_to_md_output.py:116,335): YOLO
0-based class indices map to MD 1-based string categories, center-format
normalized boxes become MD [x_min, y_min, w, h], confidence order is
preserved.

The port's own copy of
megadetector_tpu/data_management/yolo_output_to_md_output.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import json
import os
import sys

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils.path_utils import find_images

DEFAULT_DETECTOR_LABEL_MAP = {'1': 'animal', '2': 'person', '3': 'vehicle'}


def read_classes_from_yolo_dataset_file(fn):
    """
    Read a {int category ID: name} dict from a YOLOv5/YOLOv8
    dataset.yml/.yaml file, a .json dict of id->name, or a .txt flat
    class list (reference: yolo_output_to_md_output.py:57-113).
    """

    import re

    category_id_to_name = {}

    if fn.endswith('.yml') or fn.endswith('.yaml'):
        with open(fn, 'r') as f:
            lines = f.readlines()
        for s in lines:
            if re.search(r'\d+:.+', s) is not None:
                tokens = s.split(':')
                assert len(tokens) == 2, \
                    'Invalid token in category file {}'.format(fn)
                category_id_to_name[int(tokens[0].strip())] = \
                    tokens[1].strip()
    elif fn.endswith('.json'):
        with open(fn, 'r') as f:
            d_in = json.load(f)
        for k in d_in:
            category_id_to_name[int(k)] = d_in[k]
    elif fn.endswith('.txt'):
        with open(fn, 'r') as f:
            lines = f.readlines()
        next_category_id = 0
        for s in lines:
            s = s.strip()
            if len(s) == 0:
                continue
            category_id_to_name[next_category_id] = s
            next_category_id += 1
    else:
        raise ValueError(
            'Unrecognized class-list file type {}'.format(fn))

    assert len(category_id_to_name) > 0, \
        'Failed to read classes from {}'.format(fn)
    return category_id_to_name


def yolo_json_output_to_md_output(yolo_json_file, image_folder,
                                  output_file, yolo_category_id_to_name=None,
                                  detector_name='converted-from-yolo',
                                  image_id_to_relative_path=None,
                                  offset_yolo_class_ids=True,
                                  truncate_to_standard_md_precision=True):
    """
    Convert a YOLO val-format predictions .json (list of dicts with
    image_id, category_id, bbox [x, y, w, h] in absolute pixels, score)
    to MD format. Requires image sizes, read from [image_folder].
    """

    with open(yolo_json_file) as f:
        predictions = json.load(f)
    assert isinstance(predictions, list)

    from PIL import Image

    # Group predictions by image
    image_id_to_predictions = {}
    for p in predictions:
        image_id_to_predictions.setdefault(p['image_id'], []).append(p)

    images_out = []
    category_ids = set()

    for image_id, preds in image_id_to_predictions.items():

        if image_id_to_relative_path is not None:
            fn = image_id_to_relative_path[image_id]
        else:
            fn = str(image_id)

        image_path = os.path.join(image_folder, fn)
        try:
            with Image.open(image_path) as pil_im:
                img_w, img_h = pil_im.size
        except Exception:
            images_out.append({'file': fn, 'detections': None,
                               'failure': 'image access failure'})
            continue

        detections = []
        for p in preds:
            x, y, w, h = p['bbox']
            bbox = [x / img_w, y / img_h, w / img_w, h / img_h]
            conf = p['score']
            category_id = int(p['category_id'])
            if offset_yolo_class_ids:
                category_id += 1
            category_ids.add(category_id)
            if truncate_to_standard_md_precision:
                bbox = ct_utils.round_float_array(bbox, 4)
                conf = ct_utils.round_float(conf, 3)
            detections.append({'category': str(category_id),
                               'conf': conf, 'bbox': bbox})
        images_out.append({'file': fn, 'detections': detections})

    if yolo_category_id_to_name is not None:
        detection_categories = {}
        for cat_id in sorted(category_ids):
            source_id = cat_id - 1 if offset_yolo_class_ids else cat_id
            detection_categories[str(cat_id)] = \
                yolo_category_id_to_name.get(
                    source_id, str(source_id))
    else:
        detection_categories = DEFAULT_DETECTOR_LABEL_MAP

    data = {'images': images_out,
            'detection_categories': detection_categories,
            'info': {'format_version': '1.6',
                     'detector': detector_name}}
    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def yolo_txt_output_to_md_output(input_results_folder, image_folder,
                                 output_file,
                                 detector_tag='converted-from-yolo-txt'):
    """
    Convert a folder of YOLO per-image prediction .txt files (rows of
    'class cx cy w h [conf]', normalized) to MD format.
    """

    image_files = find_images(image_folder, recursive=True,
                              return_relative_paths=True)
    images_out = []

    for fn in image_files:
        label_fn = os.path.join(input_results_folder,
                                os.path.splitext(fn)[0] + '.txt')
        detections = []
        if os.path.isfile(label_fn):
            with open(label_fn) as f:
                for line in f:
                    tokens = line.strip().split()
                    if len(tokens) < 5:
                        continue
                    class_idx = int(tokens[0])
                    cx, cy, w, h = [float(t) for t in tokens[1:5]]
                    conf = float(tokens[5]) if len(tokens) > 5 else 1.0
                    detections.append({
                        'category': str(class_idx + 1),
                        'conf': ct_utils.round_float(conf, 3),
                        'bbox': ct_utils.round_float_array(
                            [cx - w / 2, cy - h / 2, w, h], 4),
                    })
        images_out.append({'file': fn, 'detections': detections})

    data = {'images': images_out,
            'detection_categories': DEFAULT_DETECTOR_LABEL_MAP,
            'info': {'format_version': '1.6', 'detector': detector_tag}}
    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def main():
    parser = argparse.ArgumentParser(
        description='Convert YOLO prediction output to MD format')
    parser.add_argument('yolo_output', help='.json file or .txt folder')
    parser.add_argument('image_folder')
    parser.add_argument('output_file')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    if args.yolo_output.endswith('.json'):
        yolo_json_output_to_md_output(args.yolo_output, args.image_folder,
                                      args.output_file)
    else:
        yolo_txt_output_to_md_output(args.yolo_output, args.image_folder,
                                     args.output_file)


if __name__ == '__main__':
    main()
