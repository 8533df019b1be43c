"""
Convert MD results to COCO detection format.

Behavioral contract follows the reference
(megadetector/postprocessing/md_to_coco.py:33): one COCO image per MD
image, absolute-pixel boxes (requires image sizes: read from the results
when present, otherwise from the image files), detections below the
confidence threshold dropped, category IDs carried over as ints.

The port's own copy of megadetector_tpu/postprocessing/md_to_coco.py: the
same public names, signatures, defaults and output bytes. No progress bar:
the port does not depend on tqdm.
"""

import argparse
import json
import os
import sys

from megadetector_tpu_torch.utils import ct_utils


def md_to_coco(md_results_file, coco_output_file=None, image_folder=None,
               confidence_threshold=0.0, validate_image_sizes=False,
               include_failed_images=False, preserve_nonstandard_metadata=True):
    """
    Convert an MD results file to a COCO-format dict; writes it when
    [coco_output_file] is given. Image sizes come from 'width'/'height'
    fields when present, else from reading files under [image_folder].
    """

    with open(md_results_file) as f:
        md = json.load(f)

    coco = {
        'images': [],
        'annotations': [],
        'categories': [
            {'id': int(cat_id), 'name': name}
            for cat_id, name in md.get('detection_categories', {}).items()
        ],
        'info': {'description': 'Converted from MD results file {}'.format(
            os.path.basename(md_results_file))},
    }

    next_ann_id = 0

    for i_image, im in enumerate(md['images']):

        failed = im.get('detections') is None
        if failed and not include_failed_images:
            continue

        width = im.get('width')
        height = im.get('height')
        need_file_size = (width is None or height is None) or \
            validate_image_sizes
        if need_file_size and image_folder is not None:
            from PIL import Image
            try:
                with Image.open(os.path.join(image_folder,
                                             im['file'])) as pil_im:
                    file_width, file_height = pil_im.size
                if validate_image_sizes and width is not None and \
                        height is not None and \
                        (width, height) != (file_width, file_height):
                    print('Warning: size mismatch for {}: results say '
                          '{}x{}, file is {}x{}; using file size'.format(
                              im['file'], width, height,
                              file_width, file_height))
                width, height = file_width, file_height
            except Exception:
                pass

        coco_im = {'id': im['file'], 'file_name': im['file'],
                   'width': width, 'height': height}
        if preserve_nonstandard_metadata:
            for k in ('datetime', 'exif_metadata', 'failure'):
                if k in im:
                    coco_im[k] = im[k]
        coco['images'].append(coco_im)

        if failed:
            continue

        for det in im['detections']:
            if det['conf'] < confidence_threshold:
                continue
            x, y, w, h = det['bbox']
            if width is not None and height is not None:
                bbox_abs = [x * width, y * height, w * width, h * height]
            else:
                bbox_abs = [x, y, w, h]
            ann = {
                'id': next_ann_id,
                'image_id': im['file'],
                'category_id': int(det['category']),
                'bbox': bbox_abs,
                'score': det['conf'],
            }
            if width is not None and height is not None:
                ann['area'] = bbox_abs[2] * bbox_abs[3]
            coco['annotations'].append(ann)
            next_ann_id += 1

    if coco_output_file is not None:
        ct_utils.write_json(coco_output_file, coco, force_str=True)
        print('Wrote COCO output to {}'.format(coco_output_file))
    return coco


def main():
    parser = argparse.ArgumentParser(
        description='Convert an MD results file to COCO format')
    parser.add_argument('md_results_file')
    parser.add_argument('coco_output_file')
    parser.add_argument('--image_folder', default=None)
    parser.add_argument('--confidence_threshold', type=float, default=0.0)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    md_to_coco(args.md_results_file, args.coco_output_file,
               image_folder=args.image_folder,
               confidence_threshold=args.confidence_threshold)


if __name__ == '__main__':
    main()
