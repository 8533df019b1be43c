"""
Tiled inference for small animals in large images (counterpart of
megadetector_tpu/detection/run_tiled_inference.py): split each image into
overlapping fixed-size tiles, run the detector on batches of tiles, map
the boxes back to image coordinates and remove the duplicates that the
overlap makes with a host NMS across tiles.

The patch grid guarantees the patch size and walks the last stride back
at the right and bottom edges (image width 15, patch 10, stride 10 ->
starts 0 and 5); the defaults are 1280x1280 tiles at 50 % overlap and an
IoU of 0.45 across tiles. Tiles go to the detector from memory; with
save_tiles they are also written as JPEGs under the tiling folder. An
image smaller than a tile runs whole. A failure to load or tile an image
is contained as that image's failure record; the detector contains only
failures of an image's data (models/detector.py is_device_fault).

    python -m megadetector_tpu_torch.detection.run_tiled_inference \\
        model.npz images tiles out.json [--device cpu]
"""

import argparse
import os
import shutil
import sys

import numpy as np

from megadetector_tpu_torch.detection.run_detector import (
    CONF_DIGITS,
    COORD_DIGITS,
    DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD,
    load_detector,
)
from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils import path_utils
from megadetector_tpu_torch.visualization import \
    visualization_utils as vis_utils

DEFAULT_PATCH_OVERLAP = 0.5
DEFAULT_TILE_SIZE = [1280, 1280]
NMS_IOU_THRESHOLD = 0.45
PATCH_JPEG_QUALITY = 95


#%% Patch geometry


def get_patch_boundaries(image_size, patch_size, patch_stride=None):
    """
    Patch start positions (x, y) covering an image. The patch size is
    guaranteed; the stride backs up at the right and bottom edges so the
    last patch ends exactly at the image edge.

    Args:
        image_size: (w, h) of the image
        patch_size: (w, h) of each patch
        patch_stride: (x, y) stride, or a float fraction of patch size;
            default half the patch size (50 % overlap)

    Returns:
        list of [x_start, y_start], row by row
    """

    if patch_stride is None:
        patch_stride = (round(patch_size[0] * (1.0 - DEFAULT_PATCH_OVERLAP)),
                        round(patch_size[1] * (1.0 - DEFAULT_PATCH_OVERLAP)))
    elif isinstance(patch_stride, float):
        patch_stride = (round(patch_size[0] * patch_stride),
                        round(patch_size[1] * patch_stride))

    image_width, image_height = image_size[0], image_size[1]
    assert patch_size[0] <= image_width, \
        'Patch width {} exceeds image width {}'.format(
            patch_size[0], image_width)
    assert patch_size[1] <= image_height, \
        'Patch height {} exceeds image height {}'.format(
            patch_size[1], image_height)
    # A zero stride (tile_overlap >= ~1.0) would loop forever below
    assert patch_stride[0] > 0 and patch_stride[1] > 0, \
        'Patch stride must be positive (is tile_overlap < 1.0?)'

    def axis_starts(length, patch, stride):
        starts = [0]
        end = patch - 1
        while end < length - 1:
            start = starts[-1] + stride
            end = start + patch - 1
            if end > length - 1:
                start -= (end - length) + 1
                end = start + patch - 1
            starts.append(start)
        return starts

    xs = axis_starts(image_width, patch_size[0], patch_stride[0])
    ys = axis_starts(image_height, patch_size[1], patch_stride[1])
    positions = [[x, y] for y in ys for x in xs]

    # The last patch must end exactly at the image edge
    assert positions[-1][0] + patch_size[0] == image_width
    assert positions[-1][1] + patch_size[1] == image_height
    return positions


def patch_info_to_patch_name(image_name, patch_x_min, patch_y_min):
    """
    Unique string name for an x/y patch coordinate, e.g.
    ("a.jpg", 10, 20) -> "a.jpg_0010_0020".
    """

    return '{}_{}_{}'.format(image_name, str(patch_x_min).zfill(4),
                             str(patch_y_min).zfill(4))


def extract_patch_from_image(im, patch_xy, patch_size,
                             patch_image_fn=None, patch_folder=None,
                             image_name=None, overwrite=True):
    """
    Crop one patch out of a numpy HWC image (or PIL image). Returns a dict
    with 'patch_fn' (None unless written), 'xmin'/'xmax'/'ymin'/'ymax' and
    'patch' (the numpy crop). With [patch_folder], the patch is also
    written there as a JPEG named after [image_name] and its position.
    """

    if not isinstance(im, np.ndarray):
        im = np.asarray(im)

    x, y = int(patch_xy[0]), int(patch_xy[1])
    w, h = int(patch_size[0]), int(patch_size[1])
    patch = im[y:y + h, x:x + w]

    patch_info = {'xmin': x, 'ymin': y, 'xmax': x + w - 1, 'ymax': y + h - 1,
                  'patch': patch, 'patch_fn': None}

    if patch_folder is not None:
        assert image_name is not None
        if patch_image_fn is None:
            patch_image_fn = os.path.join(
                patch_folder, patch_info_to_patch_name(
                    path_utils.flatten_path(image_name), x, y) + '.jpg')
        patch_info['patch_fn'] = patch_image_fn
        if overwrite or not os.path.isfile(patch_image_fn):
            os.makedirs(os.path.dirname(patch_image_fn), exist_ok=True)
            from PIL import Image
            Image.fromarray(patch).save(patch_image_fn,
                                        quality=PATCH_JPEG_QUALITY)

    return patch_info


#%% Cross-tile NMS (host numpy; few candidates remain after per-tile NMS)


def in_place_nms(md_results, iou_thres=NMS_IOU_THRESHOLD, verbose=False):
    """
    Class-agnostic greedy NMS over each image's detections, in place,
    removing the duplicates that overlapping tiles make. [md_results] is
    an MD results dict or a list of image dicts.
    """

    n_detections_before = 0
    n_detections_after = 0

    for im in md_results['images'] if isinstance(md_results, dict) \
            else md_results:

        detections = im.get('detections', None)
        if detections is None or len(detections) == 0:
            continue
        n_detections_before += len(detections)

        boxes = np.array([ct_utils.convert_xywh_to_xyxy(d['bbox'])
                          for d in detections], dtype=np.float64)
        scores = np.array([d['conf'] for d in detections], dtype=np.float64)
        order = np.argsort(-scores)

        keep = []
        suppressed = np.zeros(len(detections), dtype=bool)
        for idx in order:
            if suppressed[idx]:
                continue
            keep.append(idx)
            b = boxes[idx]
            ix0 = np.maximum(boxes[:, 0], b[0])
            iy0 = np.maximum(boxes[:, 1], b[1])
            ix1 = np.minimum(boxes[:, 2], b[2])
            iy1 = np.minimum(boxes[:, 3], b[3])
            inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
            area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            b_area = (b[2] - b[0]) * (b[3] - b[1])
            iou = inter / np.maximum(area + b_area - inter, 1e-12)
            suppressed |= iou > iou_thres
            suppressed[idx] = True

        keep_set = set(int(k) for k in keep)
        im['detections'] = [d for i, d in enumerate(detections)
                            if i in keep_set]
        n_detections_after += len(im['detections'])

    if verbose:
        print('NMS: {} -> {} detections'.format(n_detections_before,
                                                n_detections_after))


def remap_patch_detections(patch_info, patch_result, image_w, image_h):
    """
    One tile's MD detections (normalized to the tile) in the normalized
    coordinates of its image, through pixels: conf rounded to CONF_DIGITS
    and the box to COORD_DIGITS after the remap.
    """

    patch_w = (patch_info['xmax'] - patch_info['xmin']) + 1
    patch_h = (patch_info['ymax'] - patch_info['ymin']) + 1
    detections = []
    for det in patch_result['detections']:
        x_rel, y_rel, w_rel, h_rel = det['bbox']
        w_pixels = w_rel * patch_w
        h_pixels = h_rel * patch_h
        xmin_image = patch_info['xmin'] + x_rel * patch_w
        ymin_image = patch_info['ymin'] + y_rel * patch_h
        bbox_image = [xmin_image / image_w, ymin_image / image_h,
                      w_pixels / image_w, h_pixels / image_h]
        detections.append({
            'category': det['category'],
            'conf': ct_utils.round_float(det['conf'], precision=CONF_DIGITS),
            'bbox': ct_utils.round_float_array(bbox_image,
                                               precision=COORD_DIGITS)})
    return detections


def image_patches(im_np, patch_size, stride=None, patch_folder=None,
                  image_name=None):
    """
    The patch dicts of one HWC image: the whole image when it is smaller
    than a tile on either side, else every patch of get_patch_boundaries
    (written under [patch_folder] when given).
    """

    image_h, image_w = im_np.shape[:2]
    if image_w < patch_size[0] or image_h < patch_size[1]:
        return [{'xmin': 0, 'ymin': 0, 'xmax': image_w - 1,
                 'ymax': image_h - 1, 'patch': im_np, 'patch_fn': None}]
    return [extract_patch_from_image(im_np, xy, patch_size,
                                     patch_folder=patch_folder,
                                     image_name=image_name)
            for xy in get_patch_boundaries((image_w, image_h), patch_size,
                                           patch_stride=stride)]


#%% Main API


def run_tiled_inference(model_file, image_folder, tiling_folder, output_file,
                        tile_size_x=DEFAULT_TILE_SIZE[0],
                        tile_size_y=DEFAULT_TILE_SIZE[1],
                        tile_overlap=DEFAULT_PATCH_OVERLAP,
                        recursive=True,
                        checkpoint_path=None,
                        checkpoint_frequency=-1,
                        remove_tiles=True,
                        image_list=None,
                        batch_size=8,
                        detection_threshold=None,
                        detector_options=None,
                        save_tiles=False,
                        augment=False,
                        image_size=None,
                        verbose=False,
                        *,
                        device=None):
    """
    Run tiled inference over a folder of images, writing image-level
    MD-format results to [output_file]; returns the dict written. The
    arguments are the JAX package's function's, in its order, plus the
    keyword-only device.

    [model_file] is a checkpoint path, a known model name, or a detector
    object (anything with generate_detections_one_batch). Tiles are run
    from memory, [batch_size] at a time, without padding a tail batch;
    with [save_tiles] they are also written under [tiling_folder] (and
    removed at the end with [remove_tiles]). With [checkpoint_path], a
    checkpoint is written every [checkpoint_frequency] images; a run
    finds it there, skips the images it holds, and removes it on success.
    device: 'cuda', 'cuda:N', 'cpu' or None (CUDA; raises without a
    card).
    """

    if detection_threshold is None:
        detection_threshold = DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD

    patch_size = [int(tile_size_x), int(tile_size_y)]
    stride = None if tile_overlap is None else (1.0 - float(tile_overlap))

    if image_list is None:
        image_files_relative = path_utils.find_images(
            image_folder, recursive=recursive, return_relative_paths=True)
    else:
        image_files_relative = image_list

    if hasattr(model_file, 'generate_detections_one_batch'):
        detector = model_file
    else:
        detector = load_detector(model_file,
                                 detector_options=detector_options,
                                 device=device)

    if save_tiles and tiling_folder is not None:
        os.makedirs(tiling_folder, exist_ok=True)

    output_images = []
    images_since_checkpoint = 0

    # Resume: skip the images a checkpoint already holds
    already_processed = set()
    if checkpoint_path is not None and os.path.isfile(checkpoint_path):
        output_images = run_detector_batch.load_checkpoint(checkpoint_path)
        already_processed = {im['file'] for im in output_images}
        print('Resumed {} tiled results from {}'.format(
            len(output_images), checkpoint_path))

    n_tiles = 0
    for image_fn_relative in image_files_relative:

        if image_fn_relative in already_processed:
            continue

        image_fn_abs = os.path.join(image_folder, image_fn_relative)
        output_im = {'file': image_fn_relative}

        # Load and tile
        try:
            pil_im = vis_utils.load_image(image_fn_abs)
            image_w, image_h = pil_im.size
            patch_infos = image_patches(
                np.asarray(pil_im), patch_size, stride,
                patch_folder=tiling_folder if save_tiles else None,
                image_name=image_fn_relative)
        except Exception as e:
            if verbose:
                print('Patch generation error for {}: {}'.format(
                    image_fn_relative, e))
            output_im['detections'] = None
            output_im['failure'] = 'Patch generation error'
            output_im['failure_details'] = str(e)
            output_images.append(output_im)
            continue

        # Batches of tiles
        patches = [p['patch'] for p in patch_infos]
        patch_ids = ['{}__{}'.format(image_fn_relative, i)
                     for i in range(len(patches))]
        patch_results = []
        for i in range(0, len(patches), batch_size):
            patch_results.extend(detector.generate_detections_one_batch(
                patches[i:i + batch_size], patch_ids[i:i + batch_size],
                detection_threshold=detection_threshold,
                image_size=image_size, augment=augment))
        n_tiles += len(patches)

        # Remap to image coordinates; a failed tile fails its image
        detections = []
        for patch_info, patch_result in zip(patch_infos, patch_results):
            if patch_result.get('detections') is None:
                output_im['detections'] = None
                output_im['failure'] = patch_result.get('failure',
                                                        'inference failure')
                break
            detections.extend(remap_patch_detections(
                patch_info, patch_result, image_w, image_h))
        else:
            output_im['detections'] = detections
        output_images.append(output_im)

        images_since_checkpoint += 1
        if checkpoint_path is not None and checkpoint_frequency > 0 \
                and images_since_checkpoint >= checkpoint_frequency:
            run_detector_batch.write_checkpoint(checkpoint_path,
                                               output_images)
            images_since_checkpoint = 0

    print('Tiled inference: {} images, {} tiles run'.format(
        len(image_files_relative) - len(already_processed), n_tiles))

    # Cross-tile dedup
    md_results = {'images': output_images}
    in_place_nms(md_results, iou_thres=NMS_IOU_THRESHOLD, verbose=verbose)

    output = run_detector_batch.write_results_to_file(
        md_results['images'], output_file, relative_path_base=None,
        detector_file=model_file if isinstance(model_file, str) else None)

    # Success: the checkpoint is no longer needed, and saved tiles are
    # removed unless the caller asked to keep them
    if checkpoint_path is not None and os.path.isfile(checkpoint_path):
        os.remove(checkpoint_path)
    if remove_tiles and save_tiles and tiling_folder is not None and \
            os.path.isdir(tiling_folder):
        shutil.rmtree(tiling_folder, ignore_errors=True)

    return output


def main(argv=None):

    parser = argparse.ArgumentParser(
        description='Run tiled inference (for small animals in large '
                    'images) with MegaDetector (PyTorch port)')
    parser.add_argument('model_file')
    parser.add_argument('image_folder')
    parser.add_argument('tiling_folder',
                        help='folder for tile images (only used with '
                             '--save_tiles)')
    parser.add_argument('output_file')
    parser.add_argument('--tile_size_x', type=int,
                        default=DEFAULT_TILE_SIZE[0])
    parser.add_argument('--tile_size_y', type=int,
                        default=DEFAULT_TILE_SIZE[1])
    parser.add_argument('--tile_overlap', type=float,
                        default=DEFAULT_PATCH_OVERLAP)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--threshold', type=float, default=None)
    parser.add_argument('--save_tiles', action='store_true')
    parser.add_argument('--augment', action='store_true',
                        help='test-time augmentation on each tile')
    parser.add_argument('--image_size', type=int, default=None,
                        help='inference canvas override for each tile '
                             "(the reference's inference_size)")
    parser.add_argument('--verbose', action='store_true')
    parser.add_argument('--detector_options', nargs='*', default=None)
    parser.add_argument('--device', default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    detector_options = ct_utils.parse_kvp_list(args.detector_options)

    return run_tiled_inference(
        args.model_file, args.image_folder, args.tiling_folder,
        args.output_file,
        tile_size_x=args.tile_size_x, tile_size_y=args.tile_size_y,
        tile_overlap=args.tile_overlap, batch_size=args.batch_size,
        detection_threshold=args.threshold, save_tiles=args.save_tiles,
        augment=args.augment, image_size=args.image_size,
        verbose=args.verbose, detector_options=detector_options,
        device=args.device)


if __name__ == '__main__':
    main()
