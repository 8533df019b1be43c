"""
Convert MD results to per-image labelme .json annotation files.

Behavioral contract follows the reference
(megadetector/postprocessing/md_to_labelme.py:151): one labelme .json next
to each image, rectangle shapes in absolute pixels, label = category name,
detections below the confidence threshold dropped.

The port's own copy of megadetector_tpu/postprocessing/md_to_labelme.py:
the same public names, signatures, defaults and output bytes. No progress
bar: the port does not depend on tqdm.
"""

import argparse
import json
import os
import sys

from megadetector_tpu_torch.utils import ct_utils


def get_labelme_dict_for_image(im, image_name, category_id_to_name,
                               width, height, confidence_threshold=0.0,
                               info=None):
    """Build one labelme dict for an MD image record."""

    labelme = {
        'version': '5.3.0',
        'flags': {},
        'shapes': [],
        'imagePath': os.path.basename(image_name),
        'imageData': None,
        'imageHeight': height,
        'imageWidth': width,
    }
    if info is not None:
        labelme['detection_info'] = info

    for det in im.get('detections') or []:
        if det['conf'] < confidence_threshold:
            continue
        x, y, w, h = det['bbox']
        shape = {
            'label': category_id_to_name.get(det['category'],
                                             det['category']),
            'points': [[x * width, y * height],
                       [(x + w) * width, (y + h) * height]],
            'group_id': None,
            'shape_type': 'rectangle',
            'flags': {},
            'conf': det['conf'],
        }
        labelme['shapes'].append(shape)

    return labelme


def md_to_labelme(md_results_file, image_folder, confidence_threshold=0.0,
                  overwrite=False, extension_prefix='', verbose=False):
    """
    Write one labelme .json per image next to the images under
    [image_folder]. Returns the list of files written.
    """

    with open(md_results_file) as f:
        md = json.load(f)

    category_id_to_name = md.get('detection_categories', {})
    files_written = []

    for im in md['images']:

        if im.get('detections') is None:
            continue

        image_path = os.path.join(image_folder, im['file'])
        width = im.get('width')
        height = im.get('height')
        if width is None or height is None:
            try:
                from PIL import Image
                with Image.open(image_path) as pil_im:
                    width, height = pil_im.size
            except Exception as e:
                if verbose:
                    print('Could not read size for {}: {}'.format(
                        image_path, e))
                continue

        labelme_path = os.path.splitext(image_path)[0] + \
            extension_prefix + '.json'
        if os.path.isfile(labelme_path) and not overwrite:
            continue

        labelme = get_labelme_dict_for_image(
            im, im['file'], category_id_to_name, width, height,
            confidence_threshold=confidence_threshold,
            info=md.get('info'))
        ct_utils.write_json(labelme_path, labelme)
        files_written.append(labelme_path)

    return files_written


def main():
    parser = argparse.ArgumentParser(
        description='Convert MD results to labelme annotation files')
    parser.add_argument('md_results_file')
    parser.add_argument('image_folder')
    parser.add_argument('--confidence_threshold', type=float, default=0.0)
    parser.add_argument('--overwrite', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    md_to_labelme(args.md_results_file, args.image_folder,
                  confidence_threshold=args.confidence_threshold,
                  overwrite=args.overwrite)


if __name__ == '__main__':
    main()
