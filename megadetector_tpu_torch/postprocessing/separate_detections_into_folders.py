"""
Copy images into category folders (animals/people/vehicles/empty and
combinations) based on detection results and per-class thresholds.

Behavioral contract follows the reference
(megadetector/postprocessing/separate_detections_into_folders.py:509):
images are copied (never moved), relative paths are preserved under each
category folder, multi-category images land in combination folders like
'animal_person', and optional box rendering replaces the plain copy.

The port's own copy of
megadetector_tpu/postprocessing/separate_detections_into_folders.py: the
same public names, signatures, defaults and output bytes. No progress bar:
the port does not depend on tqdm.
"""

import argparse
import itertools
import json
import os
import sys

from concurrent.futures import ThreadPoolExecutor

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils.path_utils import path_is_abs

DEFAULT_CATEGORY_FOLDER_NAMES = {
    'animal': 'animals',
    'person': 'people',
    'vehicle': 'vehicles',
}


class SeparateDetectionsIntoFoldersOptions:
    """Options controlling separate_detections_into_folders()."""

    def __init__(self, threshold=None):
        self.results_file = None
        self.base_input_folder = None
        self.base_output_folder = None

        # Default threshold applied to all categories; can be overridden
        # per category via category_name_to_threshold
        self.threshold = threshold
        self.category_name_to_threshold = {}

        # Copy images that failed processing into a 'failures' folder
        self.skip_failures = False
        self.allow_existing_directory = True
        self.overwrite = True
        self.n_threads = 8

        # Move instead of copy (reference:
        # separate_detections_into_folders.py:163)
        self.move_images = False
        # Skip images with no above-threshold detections instead of
        # copying them to 'empty' (reference :149)
        self.skip_empty_images = False
        # Error (rather than warn) on source images missing from the
        # input folder (reference :141)
        self.allow_missing_files = True

        # Render bounding boxes instead of a plain copy
        self.render_boxes = False
        self.line_thickness = 4
        self.box_expansion = 0

        # {classification name: threshold}: separate classified animals
        # into per-class subfolders of 'animals'
        self.classification_thresholds = None


def _target_folder_for_image(im, category_id_to_name, options):
    """
    Category folder name for one image: 'empty', a single category folder,
    or an underscore-joined combination folder.
    """

    if 'failure' in im and im['failure'] is not None:
        return 'failures'

    detections = im.get('detections') or []
    categories_above_threshold = set()
    for d in detections:
        name = category_id_to_name.get(d['category'], d['category'])
        threshold = options.category_name_to_threshold.get(
            name, options.threshold)
        if threshold is None:
            threshold = 0.2
        if d['conf'] >= threshold:
            categories_above_threshold.add(name)

    if len(categories_above_threshold) == 0:
        return 'empty'
    if len(categories_above_threshold) == 1:
        name = categories_above_threshold.pop()
        return DEFAULT_CATEGORY_FOLDER_NAMES.get(name, name)
    return '_'.join(sorted(categories_above_threshold))


def _classification_subfolder(im, options, data):
    """Optional per-class subfolder inside 'animals'."""

    if not options.classification_thresholds:
        return None
    classification_categories = data.get('classification_categories', {})
    best = None
    for d in im.get('detections') or []:
        for c in d.get('classifications') or []:
            name = classification_categories.get(c[0], c[0])
            threshold = options.classification_thresholds.get(name)
            if threshold is not None and c[1] >= threshold:
                if best is None or c[1] > best[1]:
                    best = (name, c[1])
    return best[0] if best else None


def separate_detections_into_folders(options):
    """
    Copy images into per-category folders based on detection results
    (see module docstring). Returns {image file: target path}.
    """

    with open(options.results_file) as f:
        data = json.load(f)

    category_id_to_name = data.get('detection_categories', {})

    assert options.base_output_folder is not None
    os.makedirs(options.base_output_folder,
                exist_ok=options.allow_existing_directory)

    if options.threshold is None:
        # Default to the detector's typical threshold when available
        info = data.get('info', {})
        md = info.get('detector_metadata', {})
        options.threshold = md.get('typical_detection_threshold', 0.2)

    file_to_target = {}
    jobs = []

    for im in data['images']:

        fn = im['file']
        assert not path_is_abs(fn), \
            'This tool requires relative paths in the results file'

        if 'failure' in im and im['failure'] is not None and \
                options.skip_failures:
            continue

        folder = _target_folder_for_image(im, category_id_to_name, options)

        if folder == 'empty' and options.skip_empty_images:
            continue

        if folder == 'animals':
            sub = _classification_subfolder(im, options, data)
            if sub is not None:
                folder = os.path.join(folder, sub)

        target = os.path.join(options.base_output_folder, folder, fn)
        file_to_target[fn] = target
        jobs.append((im, fn, target))

    def _process(job):
        im, fn, target = job
        source = os.path.join(options.base_input_folder, fn)
        if not os.path.isfile(source):
            if not options.allow_missing_files:
                raise FileNotFoundError(
                    'Source file {} not found'.format(source))
            print('Warning: source file {} not found'.format(source))
            return
        if not options.overwrite and os.path.isfile(target):
            return
        os.makedirs(os.path.dirname(target), exist_ok=True)
        import shutil
        if options.render_boxes and im.get('detections'):
            from megadetector_tpu_torch.visualization import \
                visualization_utils as vis_utils
            image = vis_utils.load_image(source)
            vis_utils.render_detection_bounding_boxes(
                im['detections'], image,
                label_map=category_id_to_name,
                confidence_threshold=options.threshold,
                thickness=options.line_thickness,
                expansion=options.box_expansion)
            image.save(target)
            if options.move_images:
                os.remove(source)
        elif options.move_images:
            shutil.move(source, target)
        else:
            shutil.copy2(source, target)

    if options.n_threads <= 1:
        for job in jobs:
            _process(job)
    else:
        with ThreadPoolExecutor(max_workers=options.n_threads) as pool:
            list(pool.map(_process, jobs))

    return file_to_target


def main():
    parser = argparse.ArgumentParser(
        description='Separate images into folders by detection category')
    parser.add_argument('results_file')
    parser.add_argument('base_input_folder')
    parser.add_argument('base_output_folder')
    parser.add_argument('--threshold', type=float, default=None)
    parser.add_argument('--animal_threshold', type=float, default=None)
    parser.add_argument('--human_threshold', type=float, default=None)
    parser.add_argument('--vehicle_threshold', type=float, default=None)
    parser.add_argument('--nthreads', type=int, default=8)
    parser.add_argument('--render_boxes', action='store_true')
    parser.add_argument('--skip_failures', action='store_true')
    parser.add_argument('--move_images', action='store_true',
                        help='move instead of copy')
    parser.add_argument('--skip_empty_images', action='store_true')
    parser.add_argument('--classification_thresholds', default=None,
                        help='e.g. "deer=0.75,cow=0.75"')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()

    # Threshold sanity, as the reference CLI
    # (separate_detections_into_folders.py:765-782): each threshold in
    # [0, 1], and a default alongside ALL per-category overrides is
    # almost certainly a mistake
    for v, name in ((args.threshold, 'default'),
                    (args.animal_threshold, 'animal'),
                    (args.human_threshold, 'human'),
                    (args.vehicle_threshold, 'vehicle')):
        if v is not None:
            assert 0.0 <= v <= 1.0, \
                'Illegal {} threshold {}'.format(name, v)
    if args.threshold is not None and \
            args.animal_threshold is not None and \
            args.human_threshold is not None and \
            args.vehicle_threshold is not None:
        raise ValueError(
            'Default threshold specified, but all category thresholds '
            'also specified... not exactly wrong, but it\'s likely that '
            'you meant something else.')

    options = SeparateDetectionsIntoFoldersOptions()
    options.results_file = args.results_file
    options.base_input_folder = args.base_input_folder
    options.base_output_folder = args.base_output_folder
    options.threshold = args.threshold
    options.n_threads = args.nthreads
    options.render_boxes = args.render_boxes
    options.skip_failures = args.skip_failures
    options.move_images = args.move_images
    options.skip_empty_images = args.skip_empty_images
    if args.animal_threshold is not None:
        options.category_name_to_threshold['animal'] = args.animal_threshold
    if args.human_threshold is not None:
        options.category_name_to_threshold['person'] = args.human_threshold
    if args.vehicle_threshold is not None:
        options.category_name_to_threshold['vehicle'] = \
            args.vehicle_threshold
    if args.classification_thresholds is not None:
        d = {}
        for kvp in args.classification_thresholds.split(','):
            k, v = kvp.split('=')
            d[k.strip()] = float(v)
        options.classification_thresholds = d

    separate_detections_into_folders(options)


if __name__ == '__main__':
    main()
