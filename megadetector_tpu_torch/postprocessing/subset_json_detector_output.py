"""
Subset / split MD results files.

Behavioral contract follows the reference
(megadetector/postprocessing/subset_json_detector_output.py):
- query/replacement on filenames (query '^...' anchors at the start,
  :618-675); blank query + replacement prepends
- confidence-threshold subsetting (:348-417)
- category subsetting above per-category thresholds (:471-576)
- size-based subsetting (:283-345)
- failed-image removal (:579-615)
- split-folders mode: one output .json per unique folder, optionally
  folder-relative filenames, 'blah/foo/bar' -> 'blah_foo_bar.json'

The port's own copy of
megadetector_tpu/postprocessing/subset_json_detector_output.py: the same
public names, signatures, defaults and output bytes.
"""

import argparse
import copy
import json
import os
import sys

from megadetector_tpu_torch.utils import ct_utils


class SubsetJsonDetectorOutputOptions:
    """Options controlling subset_json_detector_output()."""

    def __init__(self):
        # Filename query (substring; '^query' anchors at start) and
        # replacement
        self.query = None
        self.replacement = None

        # Remove detections below this threshold (and images whose
        # max conf falls below remove_images_below_confidence)
        self.confidence_threshold = None
        self.remove_images_below_confidence = None

        # Keep only images with at least one detection of these categories
        # above category_thresholds[cat]
        self.categories_to_keep = None
        self.category_thresholds = None

        # Keep only images whose max-box relative size is within
        # [min_box_size, max_box_size]
        self.min_box_size = None
        self.max_box_size = None

        # Remove failed images
        self.remove_failed_images = False

        # Keep only files in this list / results file / folder
        # (reference: subset_json_detector_output.py:420)
        self.keep_files_in_list = None

        # Drop classification categories with fewer than this many
        # occurrences (IDs are not remapped; reference:
        # subset_json_detector_output.py:194)
        self.remove_classification_categories_below_count = None

        # Split-folders mode
        self.split_folders = False
        self.split_folder_mode = 'bottom'  # 'bottom', 'top', 'n_from_top'
        self.split_folder_param = 0
        self.make_folder_relative = False
        self.copy_jsons_to_folders = False

        self.overwrite_json_files = False
        self.debug_max_images = -1


def _max_box_size(im):
    """Largest relative box area in an image dict (0 if no detections)."""

    detections = im.get('detections') or []
    max_size = 0.0
    for d in detections:
        w, h = d['bbox'][2], d['bbox'][3]
        max_size = max(max_size, w * h)
    return max_size


def subset_json_detector_output_by_confidence(data, options):
    """
    Drop detections below confidence_threshold, and/or drop images whose
    max conf falls below remove_images_below_confidence (in place).
    Either option works independently of the other.
    """

    if options.confidence_threshold is None and \
            options.remove_images_below_confidence is None:
        return data

    images_out = []
    for im in data['images']:
        detections = im.get('detections')
        if detections is not None and \
                options.confidence_threshold is not None:
            im['detections'] = [d for d in detections
                                if d['conf'] >= options.confidence_threshold]
        if options.remove_images_below_confidence is not None:
            if ct_utils.get_max_conf(im) < \
                    options.remove_images_below_confidence and \
                    im.get('detections') is not None:
                continue
        images_out.append(im)
    data['images'] = images_out
    return data


def subset_json_detector_output_by_categories(data, options):
    """Keep images with at least one qualifying detection (in place)."""

    if options.categories_to_keep is None:
        return data
    thresholds = options.category_thresholds or {}

    def qualifies(im):
        for d in im.get('detections') or []:
            if d['category'] in options.categories_to_keep:
                t = thresholds.get(d['category'], 0.0)
                if d['conf'] >= t:
                    return True
        return False

    data['images'] = [im for im in data['images'] if qualifies(im)]
    return data


def subset_json_detector_output_by_size(data, options):
    """Filter images by their largest relative box size (in place)."""

    if options.min_box_size is None and options.max_box_size is None:
        return data

    def qualifies(im):
        s = _max_box_size(im)
        if options.min_box_size is not None and s < options.min_box_size:
            return False
        if options.max_box_size is not None and s > options.max_box_size:
            return False
        return True

    data['images'] = [im for im in data['images'] if qualifies(im)]
    return data


def subset_json_detector_output_by_list(data, options):
    """
    Keep only files named in options.keep_files_in_list — a list, an
    MD results file, or a folder (relative paths assumed); in place
    (reference: subset_json_detector_output.py:420-466).
    """

    if options.keep_files_in_list is None:
        return data

    source = options.keep_files_in_list
    if isinstance(source, list):
        files_to_keep = source
    elif os.path.isfile(source):
        with open(source) as f:
            files_to_keep = [im['file'] for im in
                             json.load(f)['images']]
    elif os.path.isdir(source):
        from megadetector_tpu_torch.utils.path_utils import \
            recursive_file_list
        files_to_keep = recursive_file_list(source,
                                            return_relative_paths=True)
    else:
        raise ValueError(
            '{} is neither a list, a results file, nor a '
            'folder'.format(source))

    files_to_keep_set = {fn.replace('\\', '/') for fn in files_to_keep}
    images_in = data['images']
    data['images'] = [im for im in images_in
                      if im['file'].replace('\\', '/') in
                      files_to_keep_set]
    print('Subsetting by list kept {} of {} files (expected {})'.format(
        len(data['images']), len(images_in), len(files_to_keep_set)))
    return data


def remove_classification_categories_below_count(data, options):
    """
    Drop classification categories (and their per-detection entries)
    with fewer than the threshold number of occurrences; IDs are not
    remapped (reference: subset_json_detector_output.py:194-280). In
    place.
    """

    threshold = options.remove_classification_categories_below_count
    if threshold is None or 'classification_categories' not in data:
        return data

    counts = {cat_id: 0 for cat_id in data['classification_categories']}
    for im in data['images']:
        for det in im.get('detections') or []:
            for classification in det.get('classifications', []):
                counts[classification[0]] += 1

    ids_to_keep = {cat_id for cat_id, n in counts.items()
                   if n >= threshold}
    n_removed = len(counts) - len(ids_to_keep)
    print('Removing {} of {} classification categories'.format(
        n_removed, len(counts)))
    if n_removed == 0:
        return data

    data['classification_categories'] = {
        k: v for k, v in data['classification_categories'].items()
        if k in ids_to_keep}
    if 'classification_category_descriptions' in data:
        data['classification_category_descriptions'] = {
            k: v for k, v in
            data['classification_category_descriptions'].items()
            if k in ids_to_keep}

    for im in data['images']:
        for det in im.get('detections') or []:
            if 'classifications' in det:
                det['classifications'] = [
                    c for c in det['classifications']
                    if c[0] in ids_to_keep]
    return data


def subset_json_detector_output_by_query(data, options):
    """Filter filenames by query and apply replacement (in place)."""

    images_in = data['images']
    images_out = []

    query = options.query
    starts_with = False
    if query is not None and query.startswith('^'):
        query = query[1:]
        starts_with = True

    for im in images_in:
        fn = im['file']
        if query is not None:
            if starts_with:
                if not fn.startswith(query):
                    continue
            elif query not in fn:
                continue
        if options.replacement is not None:
            if query is not None:
                fn = fn.replace(query, options.replacement)
            else:
                fn = options.replacement + fn
        im['file'] = fn
        images_out.append(im)

    data['images'] = images_out
    return data


def remove_failed_images(data, options):
    """Drop images carrying a failure field (in place)."""

    if not options.remove_failed_images:
        return data
    data['images'] = [im for im in data['images']
                      if 'failure' not in im or im['failure'] is None]
    return data


def _write_detection_results(data, output_filename, options):
    if not options.overwrite_json_files and \
            os.path.isfile(output_filename):
        raise ValueError(
            'File {} exists (use overwrite_json_files)'.format(
                output_filename))
    ct_utils.write_json(output_filename, data, force_str=True)


def _image_to_folder(fn, options):
    folder = os.path.dirname(fn)
    if options.split_folder_mode == 'bottom':
        return folder
    parts = folder.replace('\\', '/').split('/')
    if options.split_folder_mode == 'top':
        return parts[0] if parts and parts[0] else ''
    if options.split_folder_mode == 'n_from_top':
        n = int(options.split_folder_param) + 1
        return '/'.join(parts[:n])
    raise ValueError('Unknown split_folder_mode {}'.format(
        options.split_folder_mode))


def subset_json_detector_output(input_filename, output_filename, options,
                                data=None):
    """
    Apply the requested subsetting operations (query, confidence, category,
    size, failure removal), then either write one output file or split into
    per-folder files (reference: subset_json_detector_output.py:678).

    Returns the final data dict (single-file mode) or a dict of
    {folder: data} (split mode).
    """

    if options is None:
        options = SubsetJsonDetectorOutputOptions()

    if data is None:
        with open(input_filename) as f:
            data = json.load(f)
    else:
        data = copy.deepcopy(data)

    if options.debug_max_images > 0:
        data['images'] = data['images'][:options.debug_max_images]

    data = subset_json_detector_output_by_query(data, options)
    data = subset_json_detector_output_by_list(data, options)
    data = remove_failed_images(data, options)
    data = subset_json_detector_output_by_confidence(data, options)
    data = subset_json_detector_output_by_categories(data, options)
    data = subset_json_detector_output_by_size(data, options)
    data = remove_classification_categories_below_count(data, options)

    if not options.split_folders:
        if output_filename is not None:
            _write_detection_results(data, output_filename, options)
        return data

    # --- Split-folders mode: output_filename is a directory
    folders_to_images = {}
    for im in data['images']:
        folder = _image_to_folder(im['file'], options)
        folders_to_images.setdefault(folder, []).append(im)

    print('Splitting into {} folders'.format(len(folders_to_images)))

    all_outputs = {}
    for folder, images in folders_to_images.items():
        folder_data = {k: v for k, v in data.items() if k != 'images'}
        if options.make_folder_relative:
            images_rel = []
            for im in images:
                im = copy.copy(im)
                im['file'] = os.path.relpath(
                    im['file'], folder).replace('\\', '/')
                images_rel.append(im)
            folder_data['images'] = images_rel
        else:
            folder_data['images'] = images

        if options.copy_jsons_to_folders:
            json_fn = os.path.join(output_filename, folder,
                                   os.path.basename(folder) + '.json')
        else:
            flat = folder.replace('/', '_').replace('\\', '_')
            json_fn = os.path.join(output_filename,
                                   (flat if flat else 'root') + '.json')
        os.makedirs(os.path.dirname(json_fn), exist_ok=True)
        _write_detection_results(folder_data, json_fn, options)
        all_outputs[folder] = folder_data

    return all_outputs


def main():
    parser = argparse.ArgumentParser(
        description='Subset / split an MD results file')
    parser.add_argument('input_file')
    parser.add_argument('output_file',
                        help='output .json (or folder with '
                             '--split_folders)')
    parser.add_argument('--query', default=None)
    parser.add_argument('--replacement', default=None)
    parser.add_argument('--confidence_threshold', type=float, default=None)
    parser.add_argument('--remove_failed_images', action='store_true')
    parser.add_argument('--split_folders', action='store_true')
    parser.add_argument('--split_folder_mode', default='bottom')
    parser.add_argument('--split_folder_param', type=int, default=0)
    parser.add_argument('--make_folder_relative', action='store_true')
    parser.add_argument('--copy_jsons_to_folders', action='store_true')
    parser.add_argument('--overwrite_json_files', action='store_true')
    parser.add_argument('--debug_max_images', type=int, default=-1)
    parser.add_argument('--keep_files_in_list', default=None,
                        help='keep only files named in this results '
                             'file or folder')
    parser.add_argument('--remove_classification_categories_below_count',
                        type=int, default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    options = SubsetJsonDetectorOutputOptions()
    ct_utils.args_to_object(args, options)
    subset_json_detector_output(args.input_file, args.output_file, options)


if __name__ == '__main__':
    main()
