"""
Batch inference for the port (counterpart of
megadetector_tpu/detection/run_detector_batch.py load_and_run_detector_batch,
write_results_to_file and the CLI).

Images are loaded and letterboxed serially on the host, packed into
batches per canvas shape, and run through the TorchDetector's device
program; the MD-format 1.6 writer has the reference's ordering, precision
and failure semantics. Inputs are file paths, a folder, a .json/.txt list
file, or in-memory (image_id, HWC uint8 array) pairs. JPEG decoding goes
through PIL, imported only when there are files to decode.

A long run checkpoints every N images to a JSON file ({'checkpoint':
[image dicts]}, the JAX package's format) and resumes from it (results=;
the CLI's --resume_from_checkpoint, 'auto' taking the newest
md_checkpoint*.json beside the output); images already in the results are
skipped. augment runs the detector's test-time augmentation.

Not here yet: the async loader pool, timestamps and EXIF, overwrite
handling, the native loader, multi-GPU.
"""

import argparse
import copy
import json
import os
import shutil
import sys
import time

from datetime import datetime

from megadetector_tpu_torch.detection.run_detector import (
    DEFAULT_DETECTOR_LABEL_MAP,
    FAILURE_IMAGE_OPEN,
    load_detector,
)
from megadetector_tpu_torch.models.registry import (
    DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD,
    get_detector_metadata_from_version_string,
    get_detector_version_from_filename,
)
from megadetector_tpu_torch.utils import ct_utils, path_utils

# MD results format version emitted by write_results_to_file
CURRENT_FORMAT_VERSION = '1.6'


def _load_and_preprocess(detector, item, image_size=None):
    """
    (image_id, preprocess_image() dict) for a file path or an
    (image_id, array) pair; the dict is replaced by the failure string
    when the image cannot be read or letterboxed.
    """

    if isinstance(item, (tuple, list)):
        image_id, image = item
    else:
        image_id = item
        from megadetector_tpu_torch.visualization import \
            visualization_utils
        try:
            image = visualization_utils.load_image(item)
        except Exception:
            return image_id, FAILURE_IMAGE_OPEN
    try:
        return image_id, detector.preprocess_image(
            image, image_id=image_id, image_size=image_size)
    except Exception:
        return image_id, FAILURE_IMAGE_OPEN


def _item_id(item):
    """The image id of an input: the path, or a pair's image_id."""

    return item[0] if isinstance(item, (tuple, list)) else item


def _enumerate_inputs(image_file_names):
    """A folder, a .json/.txt list file or one path -> list of inputs."""

    if not isinstance(image_file_names, str):
        return list(image_file_names)
    if os.path.isdir(image_file_names):
        return path_utils.find_images(image_file_names, recursive=True)
    if image_file_names.endswith(('.json', '.txt')):
        return path_utils.read_list_from_file(image_file_names)
    return [image_file_names]


#%% Checkpointing
#
# The file format is contractual: {'checkpoint': [image dicts]}


def write_checkpoint(checkpoint_path, results):
    """
    Write [results] to [checkpoint_path], first backing up any previous
    checkpoint to '<path>_tmp' so a mid-write crash can't lose both.
    """

    checkpoint_tmp_path = None
    if os.path.isfile(checkpoint_path):
        checkpoint_tmp_path = checkpoint_path + '_tmp'
        shutil.copyfile(checkpoint_path, checkpoint_tmp_path)

    ct_utils.write_json(checkpoint_path,
                        {'checkpoint': [r for r in results
                                        if r is not None]},
                        force_str=True)

    if checkpoint_tmp_path is not None:
        os.remove(checkpoint_tmp_path)


def load_checkpoint(checkpoint_path):
    """Read a checkpoint file; returns the list of image results."""

    with open(checkpoint_path) as f:
        saved = json.load(f)
    if 'checkpoint' not in saved:
        raise ValueError('Checkpoint file {} is invalid (no "checkpoint" '
                         'field)'.format(checkpoint_path))
    return saved['checkpoint']


#%% Main API


def load_and_run_detector_batch(model_file,
                                image_file_names,
                                checkpoint_path=None,
                                confidence_threshold=None,
                                checkpoint_frequency=-1,
                                results=None,
                                quiet=False,
                                image_size=None,
                                batch_size=8,
                                augment=False,
                                include_image_size=False,
                                detector_options=None,
                                *,
                                device=None):
    """
    Run a detector over images; returns [results] followed by the new
    MD-format image dicts in input order (the arguments the port shares
    with the JAX package's function are in its order).

    Args:
        model_file: checkpoint path, known model name, or a detector
            object (anything with preprocess_image)
        image_file_names: list of image paths or (image_id, HWC uint8
            array) pairs, or a folder, or a .json/.txt list file
        checkpoint_path: JSON checkpoint destination (enables resume)
        confidence_threshold: output confidence floor (default 0.005)
        checkpoint_frequency: write a checkpoint every N images and at the
            end (-1: off)
        results: results already made (a loaded checkpoint); their images
            are skipped, and the list is extended and returned
        quiet: no summary line
        image_size: override the model's inference canvas
        batch_size: images per device program
        augment: test-time augmentation (multi-scale + flip passes merged
            before NMS); needs host preprocessing
        include_image_size: add 'height'/'width' of the original image
        detector_options: dict of TorchDetector options (pad_batches_to
            defaults to batch_size)
        device: keyword only; as load_detector
    """

    if confidence_threshold is None:
        confidence_threshold = DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD
    if results is None:
        results = []
    all_items = _enumerate_inputs(image_file_names)
    already_processed = set(r['file'] for r in results)
    items = [item for item in all_items
             if _item_id(item) not in already_processed]
    if len(items) < len(all_items) and not quiet:
        print('Bypassing {} already-processed images'.format(
            len(all_items) - len(items)))
    if len(items) == 0:
        return results

    if hasattr(model_file, 'preprocess_image'):
        detector = model_file
    else:
        detector_options = dict(detector_options or {})
        detector_options.setdefault('pad_batches_to', batch_size)
        detector = load_detector(model_file,
                                 detector_options=detector_options,
                                 device=device)

    start = time.time()
    new_results = [None] * len(items)
    pending = {}  # canvas shape -> list of (index, image_id, info)
    images_since_checkpoint = 0

    def flush_bucket(bucket):
        nonlocal images_since_checkpoint
        if len(bucket) == 0:
            return
        batch_results = detector.generate_detections_one_batch(
            [p[2] for p in bucket], [p[1] for p in bucket],
            detection_threshold=confidence_threshold,
            image_size=image_size, augment=augment)
        for (idx, _, info), r in zip(bucket, batch_results):
            if include_image_size:
                shape = info.get('original_shape', info['scaling_shape'])
                r['height'] = int(shape[0])
                r['width'] = int(shape[1])
            new_results[idx] = r
        images_since_checkpoint += len(bucket)
        bucket.clear()

    def flush_all_pending():
        # Tail-bucket merge: when batches pad to pad_batches_to, several
        # part-full rect-canvas buckets would each run a padded batch;
        # re-letterboxed onto the square canvas they run as one
        multiple = int(getattr(detector, 'pad_batches_to', None) or 1)
        if multiple > 1:
            small = [b for b in pending.values()
                     if b and len(b) % multiple != 0]
            if len(small) > 1 and sum(len(b) for b in small) <= batch_size:
                merged = []
                for b in small:
                    for idx, image_id, info in b:
                        new_info = detector.repreprocess_on_square_canvas(
                            info, image_size=image_size)
                        if new_info is None:
                            merged = None
                            break
                        merged.append((idx, image_id, new_info))
                    if merged is None:
                        break
                if merged is not None:
                    for b in small:
                        b.clear()
                    pending.setdefault('_merged_square', []).extend(merged)
        for bucket in pending.values():
            flush_bucket(bucket)

    for idx, item in enumerate(items):
        image_id, info = _load_and_preprocess(detector, item, image_size)
        if isinstance(info, str):
            new_results[idx] = {'file': image_id, 'detections': None,
                                'failure': info}
            continue
        bucket = pending.setdefault(tuple(info['target_shape']), [])
        bucket.append((idx, image_id, info))
        if len(bucket) >= batch_size:
            flush_bucket(bucket)

        if checkpoint_frequency > 0 and checkpoint_path is not None and \
                images_since_checkpoint >= checkpoint_frequency:
            flush_all_pending()
            done = [r for r in new_results if r is not None]
            write_checkpoint(checkpoint_path, results + done)
            if not quiet:
                print('Wrote checkpoint after {} images'.format(len(done)))
            images_since_checkpoint = 0
    flush_all_pending()

    if not quiet:
        elapsed = time.time() - start
        print('Finished inference for {} images in {:.1f}s'.format(
            len(items), elapsed))
    results.extend(new_results)
    # A final checkpoint, so a crash after inference loses nothing
    if checkpoint_frequency > 0 and checkpoint_path is not None:
        write_checkpoint(checkpoint_path, results)
    return results


def write_results_to_file(results,
                          output_file,
                          relative_path_base=None,
                          detector_file=None,
                          info=None,
                          include_max_conf=False,
                          custom_metadata=None,
                          force_forward_slashes=True,
                          detection_categories=None):
    """
    Write detection results in the MD output format 1.6: relative paths,
    forward slashes, filename-sorted images, conf-sorted detections,
    max_detection_conf stripped unless requested, failures with
    detections=None. Returns the dict that was written.
    """

    if relative_path_base is not None:
        results_relative = []
        for r in results:
            r_relative = copy.copy(r)
            r_relative['file'] = os.path.relpath(
                r_relative['file'], start=relative_path_base)
            results_relative.append(r_relative)
        results = results_relative

    if force_forward_slashes:
        results_converted = []
        for r in results:
            r_converted = copy.copy(r)
            r_converted['file'] = r_converted['file'].replace('\\', '/')
            results_converted.append(r_converted)
        results = results_converted

    if info is None:
        info = {
            'detection_completion_time':
                datetime.now().strftime('%Y-%m-%d %H:%M:%S'),
            'format_version': CURRENT_FORMAT_VERSION,
        }
        if detector_file is not None:
            detector_filename = os.path.basename(detector_file)
            detector_version = get_detector_version_from_filename(
                detector_filename)
            info['detector'] = detector_filename
            info['detector_metadata'] = \
                get_detector_metadata_from_version_string(detector_version)
        else:
            info['detector'] = 'unknown'
            info['detector_metadata'] = \
                get_detector_metadata_from_version_string('unknown')
    elif detector_file is not None:
        print('Warning (write_results_to_file): info struct and detector '
              'file supplied, ignoring detector file')

    if custom_metadata is not None:
        info['custom_metadata'] = custom_metadata

    if not include_max_conf:
        for im in results:
            if 'max_detection_conf' in im:
                del im['max_detection_conf']

    results = ct_utils.sort_list_of_dicts_by_key(results, 'file')
    for im in results:
        if im.get('detections') is not None:
            im['detections'] = ct_utils.sort_list_of_dicts_by_key(
                im['detections'], 'conf', reverse=True)
    for im in results:
        if 'failure' in im:
            if im.get('detections') is not None:
                raise ValueError('Illegal failure/detection combination '
                                 'for {}'.format(im['file']))
            im['detections'] = None

    final_output = {
        'images': results,
        'detection_categories':
            detection_categories if detection_categories is not None
            else DEFAULT_DETECTOR_LABEL_MAP,
        'info': info,
    }
    out_dir = os.path.dirname(output_file)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    ct_utils.write_json(output_file, final_output, force_str=True)
    print('Output file saved at {}'.format(output_file))
    return final_output


def main(argv=None):
    """The CLI; [argv] defaults to sys.argv[1:]."""

    parser = argparse.ArgumentParser(
        description='Run MegaDetector (PyTorch port) on a folder or list of '
                    'images, writing MD-format JSON')
    parser.add_argument('detector_file',
                        help='converted .npz checkpoint or known model name')
    parser.add_argument('image_file',
                        help='folder of images, a single image, or a '
                             '.json/.txt list of image paths')
    parser.add_argument('output_file', help='output .json path')
    parser.add_argument('--recursive', action='store_true',
                        help='recurse into image_file when it is a folder')
    parser.add_argument('--output_relative_filenames', action='store_true',
                        help='write paths relative to the input folder')
    parser.add_argument('--include_max_conf', action='store_true')
    parser.add_argument('--include_image_size', action='store_true')
    parser.add_argument('--quiet', action='store_true')
    parser.add_argument('--image_size', type=int, default=None)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--augment', action='store_true',
                        help='test-time augmentation (multi-scale + '
                             'flip passes merged before NMS)')
    parser.add_argument('--threshold', type=float, default=None,
                        help='output confidence floor (default {})'.format(
                            DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD))
    parser.add_argument('--checkpoint_frequency', type=int, default=-1)
    parser.add_argument('--checkpoint_path', default=None)
    parser.add_argument('--resume_from_checkpoint', default=None,
                        help='checkpoint file to resume from, or "auto"')
    parser.add_argument('--allow_checkpoint_overwrite',
                        action='store_true',
                        help='accepted for compatibility; no effect')
    parser.add_argument('--device', default=None,
                        help='cuda, cuda:N or cpu (default: cuda, which '
                             'needs a card)')
    parser.add_argument('--class_mapping_filename', default=None,
                        help='JSON {category_id: name} to use instead of '
                             'the default label map (implies '
                             'use_model_native_classes)')
    parser.add_argument('--detector_options', nargs='*', default=None)
    parser.add_argument('--previous_results_file', default=None,
                        help='merge results for already-processed images '
                             'from this file')

    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args(argv)

    detector_options = ct_utils.parse_kvp_list(args.detector_options)
    custom_category_map = None
    if args.class_mapping_filename is not None:
        with open(args.class_mapping_filename) as f:
            custom_category_map = json.load(f)
        detector_options['use_model_native_classes'] = 'true'

    if os.path.isdir(args.image_file):
        image_file_names = path_utils.find_images(args.image_file,
                                                  args.recursive)
        source_folder = args.image_file
    else:
        image_file_names = _enumerate_inputs(args.image_file)
        source_folder = None
    print('Running detector on {} images'.format(len(image_file_names)))

    # Resume support
    results = []
    checkpoint_path = args.checkpoint_path
    if args.checkpoint_frequency > 0 and checkpoint_path is None:
        output_dir = os.path.dirname(os.path.abspath(args.output_file))
        checkpoint_path = os.path.join(
            output_dir, 'md_checkpoint_{}.json'.format(
                datetime.now().strftime('%Y%m%d%H%M%S')))
    if args.resume_from_checkpoint is not None:
        if args.resume_from_checkpoint == 'auto':
            output_dir = os.path.dirname(os.path.abspath(args.output_file))
            candidates = sorted(
                fn for fn in os.listdir(output_dir)
                if fn.startswith('md_checkpoint') and fn.endswith('.json'))
            if not candidates:
                raise ValueError('No checkpoint files found in {} for '
                                 '"auto" resume'.format(output_dir))
            resume_file = os.path.join(output_dir, candidates[-1])
        else:
            resume_file = args.resume_from_checkpoint
        results = load_checkpoint(resume_file)
        print('Restored {} results from checkpoint {}'.format(
            len(results), resume_file))
        if checkpoint_path is None:
            checkpoint_path = resume_file

    # Merge previous results
    if args.previous_results_file is not None:
        with open(args.previous_results_file) as f:
            previous = json.load(f)
        prev_images = previous.get('images', [])
        if source_folder is not None:
            for im in prev_images:
                im['file'] = os.path.join(source_folder, im['file'])
        results.extend(prev_images)
        print('Merged {} previous results'.format(len(prev_images)))

    results = load_and_run_detector_batch(
        args.detector_file, image_file_names,
        checkpoint_path=checkpoint_path,
        confidence_threshold=args.threshold,
        checkpoint_frequency=args.checkpoint_frequency, results=results,
        quiet=args.quiet, image_size=args.image_size,
        batch_size=args.batch_size, augment=args.augment,
        include_image_size=args.include_image_size,
        detector_options=detector_options, device=args.device)

    write_results_to_file(
        results, args.output_file,
        relative_path_base=source_folder
        if args.output_relative_filenames else None,
        detector_file=args.detector_file,
        include_max_conf=args.include_max_conf,
        detection_categories=custom_category_map)

    # Delete the checkpoint on success
    if checkpoint_path is not None and os.path.isfile(checkpoint_path):
        os.remove(checkpoint_path)
        print('Deleted checkpoint file {}'.format(checkpoint_path))


if __name__ == '__main__':
    main()
