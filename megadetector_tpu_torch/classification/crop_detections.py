"""
The port's copy of megadetector_tpu/classification/crop_detections.py
(no device code; the port imports nothing of the JAX package).

Crop detection bounding boxes out of images for classifier training.

Reference behavior (megadetector/classification/crop_detections.py:79-456):
given an MD detections JSON, every detection above a confidence
threshold is cropped from its image and saved as

    <image path>___crop{XX:02d}_mdv{version}.jpg

under the output directory — XX is the detection's index within the
image (skipped boxes still consume an index, so crop names are stable
across threshold changes), and version is the detector version. Crops
always save as RGB JPEG. With square_crops=True the crop expands to a
square whose side is max(box_w, box_h), clipped shift-first and
zero-padded where it would exceed the image. A log of failed images is
written to <logdir>/crop_detections_log_<timestamp>.json.

This implementation reads images from a local directory (the
reference's Azure-container download path has no offline analog; an
images_dir is required) and parallelizes with a thread pool.
"""

import argparse
import json
import os
import sys

from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

import numpy as np

from megadetector_tpu_torch.utils import ct_utils


def crop_filename(image_file, crop_index, detector_version=None):
    """The contractual crop name: image.jpg___crop00_mdv5a.0.0.jpg
    (reference: crop_detections.py:18-27)."""

    if detector_version:
        return '{}___crop{:0>2d}_mdv{}.jpg'.format(
            image_file, crop_index, detector_version)
    return '{}___crop{:0>2d}.jpg'.format(image_file, crop_index)


def detector_version_from_results(data):
    """Derive the crop-name version suffix from an MD results dict's
    info.detector field (e.g. md_v5a.0.0.pt -> 5a.0.0)."""

    v = data.get('info', {}).get('detector', '')
    for prefix in ('md_v', 'megadetector_v'):
        if v.startswith(prefix):
            v = v[len(prefix):]
            break
    return v.rsplit('.pt', 1)[0].rsplit('.npz', 1)[0] if v else 'unknown'


def parse_crop_filename(crop_path):
    """Inverse of crop_filename: returns (image_file, crop_index) or
    None when the path does not follow the convention. Reads ALL index
    digits — '{:0>2d}' zero-pads but does not truncate, so images with
    100+ detections produce 3-digit indices that must round-trip."""

    import re

    marker = '___crop'
    idx = crop_path.rfind(marker)
    if idx < 0:
        return None
    tail = crop_path[idx + len(marker):]
    m = re.match(r'(\d+)', tail)
    if m is None:
        return None
    return crop_path[:idx], int(m.group(1))


def crop_image_array(img, bbox_norm, square_crop=False):
    """
    Extract one crop from an HWC uint8 array. bbox_norm is normalized
    MD [x, y, w, h]. With square_crop, expand the short side around the
    box center, shift back inside the image where possible, and zero-pad
    the remainder (reference: crop_detections.py:407-456).
    """

    img_h, img_w = img.shape[:2]
    x = int(bbox_norm[0] * img_w)
    y = int(bbox_norm[1] * img_h)
    w = int(bbox_norm[2] * img_w)
    h = int(bbox_norm[3] * img_h)

    if square_crop:
        side = max(w, h)
        x -= (side - w) // 2
        y -= (side - h) // 2
        w = h = side
        # Shift the window back inside the image bounds first
        x = max(0, min(x, img_w - w))
        y = max(0, min(y, img_h - h))

    w = max(w, 1)
    h = max(h, 1)

    x0 = max(0, x)
    y0 = max(0, y)
    x1 = min(img_w, x + w)
    y1 = min(img_h, y + h)
    if x1 <= x0 or y1 <= y0:
        return None

    crop = img[y0:y1, x0:x1]
    if square_crop and (crop.shape[0] != h or crop.shape[1] != w):
        # Zero-pad to the full square
        out = np.zeros((h, w, 3), dtype=img.dtype)
        out[(y0 - y):(y0 - y) + crop.shape[0],
            (x0 - x):(x0 - x) + crop.shape[1]] = crop
        crop = out
    return crop


def load_local_image(img_path):
    """
    Load an image from a local path (or file-like object); returns the
    PIL image, or None on failure (reference:
    crop_detections.py:296-308).
    """

    from PIL import Image
    try:
        with Image.open(img_path) as img:
            img.load()
        return img
    except OSError as e:
        print('Unable to load {}. {}: {}'.format(
            img_path, type(e).__name__, e))
    return None


def save_crop(img, bbox_norm, square_crop, save):
    """
    Crop a loaded PIL image with the normalized [x, y, w, h] box and
    save the crop to [save]; returns whether a crop was saved
    (reference: crop_detections.py:407-456).
    """

    from PIL import Image

    crop = crop_image_array(np.asarray(img.convert('RGB')), bbox_norm,
                            square_crop=square_crop)
    if crop is None:
        return False
    os.makedirs(os.path.dirname(save) or '.', exist_ok=True)
    Image.fromarray(crop).save(save)
    return True


def load_and_crop(img_path, images_dir, container_client, bbox_dicts,
                  confidence_threshold, crop_path_template,
                  save_full_image=False, square_crops=False,
                  check_crops_valid=False):
    """
    Given an image and its bounding boxes, save any crops that don't
    already exist (reference: crop_detections.py:311-404).
    [crop_path_template] contains {img_path} and {n} placeholders.
    The reference's Azure download path ([container_client]) is not
    supported in this offline-first framework — images must exist
    locally under [images_dir]. Returns (did_download, n_crops_saved);
    did_download is always False here.
    """

    assert container_client is None, \
        'Azure Blob Storage download is not supported; stage images ' \
        'locally under images_dir'

    n_crops_saved = 0
    img = None
    full_path = os.path.join(images_dir, img_path) \
        if images_dir is not None else img_path

    for i_box, bbox_dict in enumerate(bbox_dicts):
        if bbox_dict.get('conf', 1.0) < confidence_threshold:
            continue
        crop_path = crop_path_template.format(img_path=img_path,
                                              n=i_box)
        if os.path.isfile(crop_path):
            if not check_crops_valid or \
                    load_local_image(crop_path) is not None:
                continue
        if img is None:
            img = load_local_image(full_path)
            if img is None:
                return False, n_crops_saved
        if save_crop(img, bbox_dict['bbox'], square_crops, crop_path):
            n_crops_saved += 1

    return False, n_crops_saved


def crop_detections(detections_json_path,
                    cropped_images_dir,
                    images_dir,
                    detector_version=None,
                    threshold=0.8,
                    square_crops=False,
                    threads=1,
                    logdir=None,
                    category_allowlist=None,
                    verbose=False):
    """
    Crop every above-threshold detection in [detections_json_path].

    Returns (n_crops_saved, failed_images). Skipped boxes still consume
    their crop index so names stay stable across thresholds.
    category_allowlist: optional set of category IDs to crop (e.g.
    {'1'} for animals only).
    """

    from megadetector_tpu_torch.visualization import \
        visualization_utils as vis_utils

    with open(detections_json_path) as f:
        data = json.load(f)

    if detector_version is None:
        detector_version = detector_version_from_results(data)

    import threading

    failed = []
    n_saved = 0
    count_lock = threading.Lock()

    def process_one(im):
        nonlocal n_saved
        if im.get('detections') is None:
            return
        to_crop = []
        for i_det, det in enumerate(im['detections']):
            if det['conf'] < threshold:
                continue
            if category_allowlist is not None and \
                    det['category'] not in category_allowlist:
                continue
            to_crop.append((i_det, det))
        if len(to_crop) == 0:
            return
        src = os.path.join(images_dir, im['file'])
        try:
            img = np.asarray(vis_utils.load_image(src))
        except Exception:
            with count_lock:
                failed.append(im['file'])
            return
        for i_det, det in to_crop:
            crop = crop_image_array(img, det['bbox'],
                                    square_crop=square_crops)
            if crop is None:
                continue
            out_path = os.path.join(
                cropped_images_dir,
                crop_filename(im['file'], i_det, detector_version))
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            from PIL import Image
            Image.fromarray(crop).convert('RGB').save(out_path,
                                                      quality=95)
            with count_lock:
                n_saved += 1

    images = data['images']
    if threads > 1:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(process_one, images))
    else:
        for im in images:
            process_one(im)

    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        log_path = os.path.join(
            logdir, 'crop_detections_log_{}.json'.format(
                datetime.now().strftime('%Y%m%d_%H%M%S')))
        ct_utils.write_json(log_path, {
            'detections_json': detections_json_path,
            'threshold': threshold,
            'n_crops_saved': n_saved,
            'failed_images': failed,
        })
        if verbose:
            print('Wrote crop log to {}'.format(log_path))

    if verbose or failed:
        print('Saved {} crops ({} failed images)'.format(
            n_saved, len(failed)))
    return n_saved, failed


def main():
    parser = argparse.ArgumentParser(
        description='Crop above-threshold detections for classifier '
                    'training')
    parser.add_argument('detections_json')
    parser.add_argument('cropped_images_dir')
    parser.add_argument('--images_dir', required=True)
    parser.add_argument('--detector_version', default=None)
    parser.add_argument('--threshold', type=float, default=0.8)
    parser.add_argument('--square_crops', action='store_true')
    parser.add_argument('--threads', type=int, default=1)
    parser.add_argument('--logdir', default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    crop_detections(args.detections_json, args.cropped_images_dir,
                    args.images_dir,
                    detector_version=args.detector_version,
                    threshold=args.threshold,
                    square_crops=args.square_crops,
                    threads=args.threads, logdir=args.logdir,
                    verbose=True)


if __name__ == '__main__':
    main()
