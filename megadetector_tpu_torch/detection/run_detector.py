"""
Detector loading and the single-image driver for the port (counterpart of
megadetector_tpu/detection/run_detector.py): load_detector,
load_and_run_detector (runs a detector over a few images and renders their
boxes), its CLI, get_typical_confidence_threshold_from_results,
estimate_md_images_per_second, is_gpu_available and
get_accelerator_summary, and the constants and registry names the tiled
and video drivers import from here.

A known model name ('MDV5A') resolves only to a converted checkpoint that
is already on disk in the model folder; nothing is downloaded.

    python -m megadetector_tpu_torch.detection.run_detector model.npz \\
        --image_file a.jpg --output_dir out [--device cpu]
"""

import argparse
import hashlib
import json
import os
import sys
import time

from megadetector_tpu_torch.device import (  # noqa: F401  (public API)
    get_accelerator_summary,
    is_gpu_available,
)
from megadetector_tpu_torch.models.detector import (  # noqa: F401
    CONF_DIGITS,
    COORD_DIGITS,
    DEFAULT_DETECTOR_LABEL_MAP,
    FAILURE_IMAGE_OPEN,
    FAILURE_INFER,
    PROGRAMMING_ERRORS,
    TorchDetector,
    is_device_fault,
    reraise_programming_errors,
)
from megadetector_tpu_torch.models import registry
from megadetector_tpu_torch.models.registry import (  # noqa: F401
    DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD,
    DEFAULT_RENDERING_CONFIDENCE_THRESHOLD,
    get_detector_metadata_from_version_string,
    get_detector_version_from_filename,
    get_detector_version_from_model_file,
    known_models,
    model_string_to_model_version,
)
from megadetector_tpu_torch.models.convert_weights import \
    convert_megadetector_checkpoint
from megadetector_tpu_torch.utils import ct_utils, path_utils
from megadetector_tpu_torch.visualization import \
    visualization_utils as vis_utils

DEFAULT_BOX_THICKNESS = 4
DEFAULT_BOX_EXPANSION = 0
DEFAULT_LABEL_FONT_SIZE = 16
DETECTION_FILENAME_INSERT = '_detections'

#: MDv5-equivalent single-card throughput (images/s) by a case-insensitive
#: substring of the card's name (torch.cuda.get_device_name), first match
#: wins: the reference's published GPU numbers (megadetector.md:350-359).
#: No H100 number is published, so an H100 gets None.
DEVICE_KIND_TO_MDV5_IMAGES_PER_SECOND = {
    '4090': 17.6,
    '3090': 11.4,
    '3080': 9.5,
    '3050': 4.2,
    'P2000': 2.1,
}


def get_typical_confidence_threshold_from_results(results):
    """
    A sensible default display/analysis threshold for an MD results dict
    or .json filename: detector_metadata's value when present, else
    inferred from the detector version, else the MDv5 default.
    """

    if isinstance(results, str):
        with open(results) as f:
            results = json.load(f)

    info = results.get('info', {})
    metadata = info.get('detector_metadata', {})
    if 'typical_detection_threshold' in metadata:
        return metadata['typical_detection_threshold']

    default = get_detector_metadata_from_version_string(
        'v5a.0.0')['typical_detection_threshold']
    if not info.get('detector'):
        print('Warning: detector version not available in results '
              'file, using MDv5 defaults')
        return default

    print('Warning: detector metadata not available in results file, '
          'inferring from MD version')
    try:
        version = get_detector_version_from_filename(info['detector'])
        metadata = get_detector_metadata_from_version_string(version)
        return metadata.get('typical_detection_threshold', default)
    except Exception:
        return default


def estimate_md_images_per_second(model_file, device_name=None):
    """
    Rough throughput estimate for [model_file] on the current (or named)
    card, from DEVICE_KIND_TO_MDV5_IMAGES_PER_SECOND and the model's speed
    ratio against MDv5. None when the card, its number or the model
    version is unknown.
    """

    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            print('Error querying device name: no CUDA card')
            return None
        device_name = torch.cuda.get_device_name(0)

    model_version = get_detector_version_from_model_file(model_file)
    if model_version not in known_models:
        print('Could not estimate inference speed for model file '
              '{}'.format(model_file))
        return None
    speed_ratio = known_models[model_version].get(
        'normalized_typical_inference_speed')
    if speed_ratio is None:
        print('No speed ratio available for model version {}'.format(
            model_version))
        return None

    for kind, mdv5_speed in DEVICE_KIND_TO_MDV5_IMAGES_PER_SECOND.items():
        if kind.lower() in str(device_name).lower():
            return mdv5_speed * speed_ratio
    print('No speed estimate available for device {}'.format(device_name))
    return None


def resolve_model_file(model_file):
    """
    A path that exists is returned as is. A known model name resolves to
    its converted checkpoint in the model folder; if that is not on disk,
    FileNotFoundError says how to make it.
    """

    if os.path.exists(model_file):
        return model_file
    version = registry.model_string_to_model_version.get(
        str(model_file).lower())
    if version is None:
        raise FileNotFoundError('Model file {} does not exist'.format(
            model_file))
    converted = registry.find_converted_checkpoint(version)
    if converted is None:
        raise FileNotFoundError(
            'No converted checkpoint for {} ({}) in {}; convert the .pt '
            'once with python -m megadetector_tpu_torch.models.'
            'convert_weights '
            'and place it there as md_{}.npz'.format(
                model_file, version, registry.get_default_model_folder(),
                version))
    return converted


def load_detector(model_file, force_cpu=False, detector_options=None,
                  verbose=False, *, device=None):
    """
    Load a TorchDetector from a converted checkpoint (.npz + metadata, or
    a folder with weights.npz + metadata.json), a reference YOLOv5 .pt
    (converted once into the model folder) or a known model name.
    The positional arguments are the JAX package's load_detector's.

    Args:
        model_file: checkpoint path or known model name
        force_cpu: run on the CPU (device 'cpu')
        detector_options: dict of TorchDetector options
        verbose: print load details
        device: keyword only: 'cuda', 'cuda:N', 'cpu' or None (CUDA, or
            the CPU with force_cpu); CUDA without a card raises, so the
            CPU needs 'cpu' (or force_cpu). A device other than the CPU
            together with force_cpu raises ValueError.
    """

    if force_cpu:
        if device is not None and str(device) != 'cpu':
            raise ValueError('load_detector: force_cpu=True contradicts '
                             'device={!r}'.format(device))
        device = 'cpu'
    model_file = resolve_model_file(model_file)
    if model_file.endswith(('.pb', '.mdpkg')):
        raise NotImplementedError(
            '{}: the PyTorch port loads converted .npz checkpoints and '
            'reference .pt files only'.format(model_file))
    start = time.time()
    if model_file.endswith('.pt'):
        # A reference checkpoint: converted once into the model folder,
        # then loaded. The name hashes the file's first MiB and its size,
        # so a checkpoint that merely names a known version (a fine-tune
        # called my_v5a.0.1.pt) never resolves to another's conversion
        version = registry.get_detector_version_from_model_file(model_file)
        with open(model_file, 'rb') as f:
            head = f.read(1 << 20)
            f.seek(0, os.SEEK_END)
            size = f.tell()
        digest = hashlib.sha256(head + str(size).encode()).hexdigest()[:10]
        out_path = os.path.join(
            registry.get_default_model_folder(),
            'md_{}_{}.npz'.format(version or os.path.basename(model_file),
                                  digest))
        if not os.path.isfile(out_path):
            print('Converting torch checkpoint {} -> {}'.format(
                model_file, out_path))
            convert_megadetector_checkpoint(model_file, out_path,
                                            model_version=version,
                                            verbose=verbose)
        model_file = out_path
    detector = TorchDetector(model_file, detector_options=detector_options,
                             verbose=verbose, device=device)
    print('Loaded model in {:.2f} seconds'.format(time.time() - start))
    return detector


def load_and_run_detector(model_file, image_file_names, output_dir,
                          render_confidence_threshold=
                          DEFAULT_RENDERING_CONFIDENCE_THRESHOLD,
                          box_thickness=DEFAULT_BOX_THICKNESS,
                          box_expansion=DEFAULT_BOX_EXPANSION,
                          image_size=None,
                          label_font_size=DEFAULT_LABEL_FONT_SIZE,
                          augment=False,
                          detector_options=None,
                          *,
                          device=None):
    """
    Run a detector over a short list of images, one at a time, rendering
    each image's boxes to [output_dir] as <name>_detections.jpg (a prefix
    0000_, 0001_, ... for names that collide). Returns the list of
    MD-format results. [model_file] is a checkpoint path, a known model
    name, or a detector object (anything with
    generate_detections_one_image). An image that cannot be loaded, or
    whose inference fails on its data, gets a failure record; a kernel,
    CUDA or programming fault propagates (models/detector.py
    is_device_fault).

    device is keyword only: 'cuda', 'cuda:N', 'cpu' or None (CUDA; raises
    without a card).
    """

    if len(image_file_names) == 0:
        print('Warning: no files available')
        return []

    if hasattr(model_file, 'generate_detections_one_image'):
        detector = model_file
    else:
        detector = load_detector(model_file,
                                 detector_options=detector_options,
                                 device=device)
    os.makedirs(output_dir, exist_ok=True)

    detection_results = []
    time_load = []
    time_infer = []

    # Unique output filenames even with collisions across folders
    output_filename_collision_counts = {}

    def input_file_to_detection_file(fn, crop_index=-1):
        fn = os.path.basename(fn).lower()
        name, ext = os.path.splitext(fn)
        if crop_index >= 0:
            name += '_crop{:0>2d}'.format(crop_index)
        fn = '{}{}{}'.format(name, DETECTION_FILENAME_INSERT, '.jpg')
        if fn in output_filename_collision_counts:
            n_collisions = output_filename_collision_counts[fn]
            # Counted under the original name, so the third duplicate
            # gets a fresh prefix instead of overwriting the second
            output_filename_collision_counts[fn] = n_collisions + 1
            fn = '{:0>4d}'.format(n_collisions) + '_' + fn
        else:
            output_filename_collision_counts[fn] = 0
        return os.path.join(output_dir, fn)

    for im_file in image_file_names:

        try:
            start_time = time.time()
            image = vis_utils.load_image(im_file)
            time_load.append(time.time() - start_time)
        except Exception as e:
            print('Image {} cannot be loaded. Exception: {}'.format(
                im_file, e))
            detection_results.append({'file': im_file, 'detections': None,
                                      'failure': FAILURE_IMAGE_OPEN})
            continue

        try:
            start_time = time.time()
            result = detector.generate_detections_one_image(
                image, im_file,
                detection_threshold=DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD,
                image_size=image_size, augment=augment)
            detection_results.append(result)
            time_infer.append(time.time() - start_time)
        except Exception as e:
            if is_device_fault(e) or (isinstance(e, PROGRAMMING_ERRORS) and
                                      reraise_programming_errors()):
                raise
            print('An error occurred while running the detector on image '
                  '{}: {}'.format(im_file, e))
            detection_results.append({'file': im_file, 'detections': None,
                                      'failure': FAILURE_INFER})
            continue

        if result.get('detections') is None:
            # The detector contained a failure on this image's data
            continue
        try:
            vis_utils.render_detection_bounding_boxes(
                result['detections'], image,
                label_map=DEFAULT_DETECTOR_LABEL_MAP,
                confidence_threshold=render_confidence_threshold,
                thickness=box_thickness, expansion=box_expansion,
                label_font_size=label_font_size)
            image.save(input_file_to_detection_file(im_file))
        except Exception as e:
            print('Rendering error for image {}: {}'.format(im_file, e))

    if len(time_load) > 0:
        print('Average image loading time: {:.3f}s'.format(
            sum(time_load) / len(time_load)))
    if len(time_infer) > 0:
        print('Average inference time: {:.3f}s'.format(
            sum(time_infer) / len(time_infer)))

    return detection_results


def main(argv=None):

    parser = argparse.ArgumentParser(
        description='Run MegaDetector (PyTorch port) on one or more '
                    'images, rendering boxes')
    parser.add_argument(
        'detector_file',
        help='model file or known model name (e.g. "MDV5A")')
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument('--image_file', help='single image to process')
    group.add_argument('--image_dir', help='folder of images to process')
    parser.add_argument('--recursive', action='store_true',
                        help='recurse into --image_dir')
    parser.add_argument('--output_dir', help='folder for rendered images')
    parser.add_argument('--image_size', type=int, default=None,
                        help='inference canvas size (long side)')
    parser.add_argument('--threshold', type=float,
                        default=DEFAULT_RENDERING_CONFIDENCE_THRESHOLD,
                        help='rendering confidence threshold')
    parser.add_argument('--box_thickness', type=int,
                        default=DEFAULT_BOX_THICKNESS)
    parser.add_argument('--box_expansion', type=int,
                        default=DEFAULT_BOX_EXPANSION)
    parser.add_argument('--label_font_size', type=float,
                        default=DEFAULT_LABEL_FONT_SIZE)
    parser.add_argument('--augment', action='store_true')
    parser.add_argument('--detector_options', nargs='*', default=None,
                        help='detector options as space-separated '
                             'key=value pairs')
    parser.add_argument('--device', default=None,
                        help="'cuda' (default), 'cuda:N' or 'cpu'")

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    detector_options = ct_utils.parse_kvp_list(args.detector_options)

    if args.image_file:
        image_file_names = [args.image_file]
    else:
        image_file_names = path_utils.find_images(args.image_dir,
                                                  args.recursive)

    if args.output_dir is None:
        if args.image_file:
            args.output_dir = os.path.dirname(args.image_file) or '.'
        else:
            args.output_dir = args.image_dir

    return load_and_run_detector(
        model_file=args.detector_file,
        image_file_names=image_file_names,
        output_dir=args.output_dir,
        render_confidence_threshold=args.threshold,
        box_thickness=args.box_thickness,
        box_expansion=args.box_expansion,
        image_size=args.image_size,
        label_font_size=args.label_font_size,
        augment=args.augment,
        detector_options=detector_options,
        device=args.device)


if __name__ == '__main__':
    main()
