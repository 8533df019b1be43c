"""
Convert a COCO Camera Traps database (ground truth) to the MD results
format, so GT can flow through every results-consuming tool (previews,
comparison, separation).

Behavioral contract follows the reference
(megadetector/data_management/cct_to_md.py): each annotation with a bbox
becomes a detection with conf 1.0; bboxes convert from absolute COCO
pixels to normalized MD coordinates; category IDs shift to string ints.

The port's own copy of megadetector_tpu/data_management/cct_to_md.py: the
same public names, signatures, defaults and output bytes.
"""

import argparse
import json
import sys

from megadetector_tpu_torch.utils import ct_utils


def cct_to_md(input_filename, output_filename=None):
    """
    Convert a CCT .json (path or dict) to an MD-format dict; writes
    [output_filename] when given.
    """

    if isinstance(input_filename, str):
        with open(input_filename) as f:
            cct = json.load(f)
    else:
        cct = input_filename

    # Category IDs: keep numeric ids as string ints (0 is legal here)
    detection_categories = {
        str(c['id']): c['name'] for c in cct.get('categories', [])}

    image_id_to_image = {im['id']: im for im in cct['images']}
    image_id_to_detections = {im['id']: [] for im in cct['images']}

    for ann in cct.get('annotations', []):
        im = image_id_to_image.get(ann['image_id'])
        if im is None:
            continue
        bbox = ann.get('bbox')
        if bbox is None:
            continue
        w_img = im.get('width')
        h_img = im.get('height')
        if not w_img or not h_img:
            continue
        x, y, w, h = bbox
        image_id_to_detections[ann['image_id']].append({
            'category': str(ann['category_id']),
            'conf': 1.0,
            'bbox': ct_utils.round_float_array(
                [x / w_img, y / h_img, w / w_img, h / h_img], 4),
        })

    images_out = []
    for im in cct['images']:
        images_out.append({
            'file': im['file_name'],
            'detections': image_id_to_detections[im['id']],
        })

    md = {'images': images_out,
          'detection_categories': detection_categories,
          'info': {'format_version': '1.6',
                   'detector': 'ground_truth_from_cct'}}

    if output_filename is not None:
        ct_utils.write_json(output_filename, md, force_str=True)
    return md


def main():
    parser = argparse.ArgumentParser(
        description='Convert a CCT database to MD results format')
    parser.add_argument('input_filename')
    parser.add_argument('output_filename')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    cct_to_md(args.input_filename, args.output_filename)


if __name__ == '__main__':
    main()
