"""
Crop-folder round trip: write detection crops to a folder (for classifier
training or offline classification), then map crop-level classification
results back onto the original image-level results.

Behavioral contract follows the reference
(megadetector/postprocessing/create_crop_folder.py:328 create_crop_folder,
:134 crop_results_to_image_results).

The port's own copy of
megadetector_tpu/postprocessing/create_crop_folder.py: the same public
names, signatures, defaults and output bytes. No progress bar: the port
does not depend on tqdm.
"""

import argparse
import json
import os
import sys

import numpy as np

from concurrent.futures import ThreadPoolExecutor

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.visualization import \
    visualization_utils as vis_utils


class CreateCropFolderOptions:
    """Options controlling create_crop_folder()."""

    def __init__(self):
        self.confidence_threshold = 0.1
        self.expansion = 0
        self.square_crops = False
        self.categories_to_crop = None  # None = all
        self.n_threads = 8
        self.overwrite = True
        self.quality = 95
        self.flatten_folders = False


def _crop_filename(image_fn, i_detection, flatten=False):
    base, ext = os.path.splitext(image_fn)
    fn = '{}_crop_{:0>3d}{}'.format(base, i_detection,
                                    ext if ext else '.jpg')
    if flatten:
        fn = fn.replace('/', '~').replace('\\', '~')
    return fn


def create_crop_folder(input_file, input_folder, output_folder,
                       output_file=None, crops_output_file=None,
                       options=None):
    """
    Write crops for all above-threshold detections to [output_folder].

    Writes (optionally):
    - output_file: the input results, with each cropped detection tagged
      with 'crop_filename'
    - crops_output_file: an MD-format file over the crop images, each with
      a single full-frame detection (for whole-crop classification)

    Returns the modified results dict.
    """

    if options is None:
        options = CreateCropFolderOptions()

    with open(input_file) as f:
        data = json.load(f)

    os.makedirs(output_folder, exist_ok=True)

    jobs = []
    for im in data['images']:
        detections = im.get('detections')
        if not detections:
            continue
        for i_det, det in enumerate(detections):
            if det['conf'] < options.confidence_threshold:
                continue
            if options.categories_to_crop is not None and \
                    det['category'] not in options.categories_to_crop:
                continue
            crop_fn = _crop_filename(im['file'], i_det,
                                     options.flatten_folders)
            det['crop_filename'] = crop_fn
            jobs.append((im['file'], det, crop_fn))

    def _process(job):
        image_fn, det, crop_fn = job
        source = os.path.join(input_folder, image_fn)
        target = os.path.join(output_folder, crop_fn)
        if not options.overwrite and os.path.isfile(target):
            return True
        try:
            image = vis_utils.load_image(source)
            crops = vis_utils.crop_image(
                [det], image, confidence_threshold=0,
                expansion=options.expansion)
            if len(crops) == 0:
                return False
            crop = crops[0]
            if options.square_crops:
                w, h = crop.size
                side = max(w, h)
                from PIL import Image as PILImage
                padded = PILImage.new('RGB', (side, side), (128, 128, 128))
                padded.paste(crop, ((side - w) // 2, (side - h) // 2))
                crop = padded
            os.makedirs(os.path.dirname(target), exist_ok=True)
            crop.save(target, quality=options.quality)
            return True
        except Exception as e:
            print('Warning: crop error for {}: {}'.format(image_fn, e))
            return False

    if options.n_threads <= 1:
        for job in jobs:
            _process(job)
    else:
        with ThreadPoolExecutor(max_workers=options.n_threads) as pool:
            list(pool.map(_process, jobs))

    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)

    if crops_output_file is not None:
        crop_images = []
        for im in data['images']:
            for det in im.get('detections') or []:
                if 'crop_filename' not in det:
                    continue
                crop_images.append({
                    'file': det['crop_filename'],
                    'detections': [{
                        'category': det['category'],
                        'conf': det['conf'],
                        'bbox': [0.0, 0.0, 1.0, 1.0],
                    }],
                })
        crops_data = {'images': crop_images,
                      'detection_categories':
                          data.get('detection_categories', {}),
                      'info': dict(data.get('info', {}))}
        ct_utils.write_json(crops_output_file, crops_data, force_str=True)

    return data


def crop_results_to_image_results(image_results_file_with_crop_ids,
                                  crop_results_file, output_file):
    """
    Map classifications computed on crop images back onto the original
    image-level detections (matched via 'crop_filename'). Returns the
    image-level dict.
    """

    with open(image_results_file_with_crop_ids) as f:
        image_data = json.load(f)
    with open(crop_results_file) as f:
        crop_data = json.load(f)

    crop_fn_to_classifications = {}
    for im in crop_data['images']:
        detections = im.get('detections') or []
        if len(detections) == 0:
            continue
        classifications = detections[0].get('classifications')
        if classifications:
            crop_fn_to_classifications[im['file']] = classifications

    n_mapped = 0
    for im in image_data['images']:
        for det in im.get('detections') or []:
            crop_fn = det.get('crop_filename')
            if crop_fn is not None and \
                    crop_fn in crop_fn_to_classifications:
                det['classifications'] = \
                    crop_fn_to_classifications[crop_fn]
                n_mapped += 1

    if 'classification_categories' in crop_data:
        image_data['classification_categories'] = \
            crop_data['classification_categories']

    print('Mapped classifications onto {} detections'.format(n_mapped))
    if output_file is not None:
        ct_utils.write_json(output_file, image_data, force_str=True)
    return image_data


def main():
    parser = argparse.ArgumentParser(
        description='Write detection crops to a folder')
    parser.add_argument('input_file')
    parser.add_argument('input_folder')
    parser.add_argument('output_folder')
    parser.add_argument('--output_file', default=None)
    parser.add_argument('--crops_output_file', default=None)
    parser.add_argument('--confidence_threshold', type=float, default=0.1)
    parser.add_argument('--expansion', type=int, default=0)
    parser.add_argument('--square_crops', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = CreateCropFolderOptions()
    ct_utils.args_to_object(args, options)
    create_crop_folder(args.input_file, args.input_folder,
                       args.output_folder, args.output_file,
                       args.crops_output_file, options)


if __name__ == '__main__':
    main()
