"""
The port's copy of megadetector_tpu/classification/detect_and_crop.py:
detection runs on the port's batch driver (keyword-only device: None
means the card).

One-step detect + crop: run MegaDetector over an image folder and crop
the above-threshold detections for classifier training.

Reference role (megadetector/classification/detect_and_crop.py): the
orchestration that runs detection (there via the Batch API or a local
cached results file) and then crop_detections. Here it chains the TPU
batch driver with classification/crop_detections directly; an existing
detections file is reused instead of re-running detection
(the reference's detection cache).
"""

import argparse
import os
import sys

from megadetector_tpu_torch.classification.crop_detections import \
    crop_detections


def load_detection_cache(detector_output_cache_dir, datasets):
    """
    Load cached per-dataset detector outputs (one MD results .json per
    dataset under [detector_output_cache_dir]); returns
    (detection_cache, detection_categories) where detection_cache maps
    dataset -> {image file -> image entry} (empty for datasets with no
    cache file) (reference: detect_and_crop.py:273-320).
    """

    import json

    detection_cache = {}
    detection_categories = {}
    for ds in datasets:
        cache_path = os.path.join(detector_output_cache_dir,
                                  '{}.json'.format(ds))
        if os.path.exists(cache_path):
            with open(cache_path) as f:
                js = json.load(f)
            detection_cache[ds] = {im['file']: im
                                   for im in js['images']}
            categories = js.get('detection_categories', {})
            assert (not detection_categories) or \
                detection_categories == categories, \
                'Incompatible detection categories across cached files'
            detection_categories = categories
        else:
            print('No detection cache found for {}'.format(ds))
            detection_cache[ds] = {}
    return detection_cache, detection_categories


def detect_and_crop(model_file, images_dir, cropped_images_dir,
                    detections_json_path=None, threshold=0.8,
                    square_crops=False, detector_version=None,
                    batch_size=8, detector_options=None, logdir=None,
                    threads=1, *, device=None):
    """
    Returns (detections_json_path, n_crops, failed_images). When
    [detections_json_path] already exists it is reused (detection
    cache); otherwise detection runs and writes it there (default:
    <cropped_images_dir>/../detections.json).
    """

    if detections_json_path is None:
        detections_json_path = os.path.join(
            os.path.dirname(os.path.abspath(cropped_images_dir)),
            'detections.json')

    if not os.path.isfile(detections_json_path):
        from megadetector_tpu_torch.detection.run_detector_batch import (
            load_and_run_detector_batch, write_results_to_file)
        from megadetector_tpu_torch.utils.path_utils import find_images

        image_files = find_images(images_dir, recursive=True)
        results = load_and_run_detector_batch(
            model_file, image_files, batch_size=batch_size,
            detector_options=detector_options, quiet=True, device=device)
        write_results_to_file(
            results, detections_json_path,
            relative_path_base=images_dir,
            detector_file=model_file if isinstance(model_file, str)
            else None)
    else:
        print('Reusing cached detections at {}'.format(
            detections_json_path))

    n_crops, failed = crop_detections(
        detections_json_path, cropped_images_dir, images_dir,
        detector_version=detector_version, threshold=threshold,
        square_crops=square_crops, threads=threads, logdir=logdir,
        verbose=True)
    return detections_json_path, n_crops, failed


def split_images_list_by_dataset(images_to_detect):
    """
    Group <dataset-name>/<image-filename> paths by dataset (reference:
    detect_and_crop.py:358-374). Returns {dataset: [paths]}.
    """

    images_by_dataset = {}
    for img_path in images_to_detect:
        dataset = img_path[:img_path.find('/')]
        images_by_dataset.setdefault(dataset, []).append(img_path)
    return images_by_dataset


def filter_detected_images(potential_images_to_detect,
                           detector_output_cache_dir):
    """
    Check <dataset>/<filename> image paths against the per-dataset
    detector-output cache (reference: detect_and_crop.py:316-355 —
    there this also prepares Azure SAS URIs for the Batch API, an
    egress-bound path intentionally not reproduced). Returns
    (images_to_detect, detection_cache, detection_categories) where
    images_to_detect lists the paths with no cached detections.
    """

    datasets = set(img_path[:img_path.find('/')]
                   for img_path in potential_images_to_detect)
    detection_cache, detection_categories = load_detection_cache(
        detector_output_cache_dir, sorted(datasets))

    images_to_detect = []
    for img_path in potential_images_to_detect:
        dataset, img_file = img_path.split('/', 1)
        if img_file not in detection_cache.get(dataset, {}):
            images_to_detect.append(img_path)
    return images_to_detect, detection_cache, detection_categories


def download_and_crop(queried_images_json, detection_cache,
                      detection_categories, detector_version,
                      cropped_images_dir, confidence_threshold,
                      save_full_images=False, square_crops=False,
                      check_crops_valid=False, images_dir=None,
                      threads=1, images_missing_detections=None):
    """
    Crop every queried image using ground-truth bboxes when present
    (crop name ___cropXX.jpg) or cached MegaDetector boxes above
    [confidence_threshold] (crop name ___cropXX_mdvY.Y.jpg) (reference:
    detect_and_crop.py:626-740; naming contract shared with
    crop_detections). The reference downloads from Azure via MegaDB;
    here images load from [images_dir] (<dataset>/<filename> layout).
    Returns (images_failed, n_downloads, n_crops) — n_downloads is the
    number of images read from disk.
    """

    from concurrent.futures import ThreadPoolExecutor

    from megadetector_tpu_torch.classification.crop_detections import (
        crop_image_array, load_local_image)

    import numpy as np
    from PIL import Image

    skip = set(images_missing_detections or [])
    version_suffix = '_mdv{}'.format(detector_version) \
        if detector_version is not None else ''

    def process_one(item):
        # Any per-image failure must land in images_failed, never
        # abort the pool
        try:
            return _process_one_inner(item)
        except Exception as e:
            return (item[0], 0, '{}: {}'.format(type(e).__name__, e))

    def _process_one_inner(item):
        img_path, info = item
        if img_path in skip:
            return (img_path, 0, 'missing detections')
        dataset, img_file = img_path.split('/', 1)

        # (bbox_norm, crop_suffix) pairs to extract
        crops = []
        if 'bbox' in info:
            for k, bbox in enumerate(info['bbox']):
                b = bbox['bbox'] if isinstance(bbox, dict) else bbox
                crops.append((b, '___crop{:>02d}.jpg'.format(k)))
        else:
            entry = detection_cache.get(dataset, {}).get(img_file)
            if entry is None:
                return (img_path, 0, 'no cached detections')
            for k, det in enumerate(entry.get('detections') or []):
                if det['conf'] >= confidence_threshold:
                    crops.append((det['bbox'],
                                  '___crop{:>02d}{}.jpg'.format(
                                      k, version_suffix)))
        if len(crops) == 0:
            return (img_path, 0, None)

        full_path = os.path.join(images_dir, img_path) \
            if images_dir is not None else img_path
        try:
            img = load_local_image(full_path)
        except Exception as e:
            return (img_path, 0, 'load failure: {}'.format(e))
        if img is None:
            return (img_path, 0, 'load failure')

        if save_full_images:
            out_full = os.path.join(cropped_images_dir, img_path)
            os.makedirs(os.path.dirname(out_full), exist_ok=True)
            img.save(out_full)

        n = 0
        img_arr = np.asarray(img.convert('RGB'))
        for bbox_norm, suffix in crops:
            crop = crop_image_array(img_arr, bbox_norm,
                                    square_crop=square_crops)
            if crop is None or 0 in crop.shape:
                continue
            save = os.path.join(
                cropped_images_dir,
                os.path.splitext(img_path)[0] + suffix)
            os.makedirs(os.path.dirname(save), exist_ok=True)
            Image.fromarray(crop).save(save)
            if check_crops_valid:
                with Image.open(save) as check:
                    check.load()
            n += 1
        return (img_path, n, None)

    items = list(queried_images_json.items())
    if threads > 1:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            results = list(pool.map(process_one, items))
    else:
        results = [process_one(item) for item in items]

    images_failed = [r[0] for r in results if r[2] is not None]
    n_downloads = sum(1 for r in results if r[2] is None and r[1] > 0)
    n_crops = sum(r[1] for r in results)
    return images_failed, n_downloads, n_crops


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Run detection then crop above-threshold boxes')
    parser.add_argument('model_file')
    parser.add_argument('images_dir')
    parser.add_argument('cropped_images_dir')
    parser.add_argument('--detections_json', default=None)
    parser.add_argument('--threshold', type=float, default=0.8)
    parser.add_argument('--square_crops', action='store_true')
    parser.add_argument('--detector_version', default=None)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--threads', type=int, default=1)
    parser.add_argument('--logdir', default=None)
    parser.add_argument('--detector_options', nargs='*', default=None)
    parser.add_argument('--device', default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")

    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    from megadetector_tpu_torch.utils import ct_utils
    detect_and_crop(
        args.model_file, args.images_dir, args.cropped_images_dir,
        detections_json_path=args.detections_json,
        threshold=args.threshold, square_crops=args.square_crops,
        detector_version=args.detector_version,
        batch_size=args.batch_size,
        detector_options=ct_utils.parse_kvp_list(args.detector_options),
        logdir=args.logdir, threads=args.threads, device=args.device)


if __name__ == '__main__':
    main()
