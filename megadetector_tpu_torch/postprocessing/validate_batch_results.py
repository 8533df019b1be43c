"""
MD results file validator for the port (counterpart of
megadetector_tpu/postprocessing/validate_batch_results.py): checks a
detection results file against the MD output format contract: required
info/format_version, string integer category IDs, bbox sanity, failure
semantics (detections null <-> failure string), video field consistency,
and optionally that every image exists.

    python -m megadetector_tpu_torch.postprocessing.validate_batch_results \\
        results.json [--check_image_existence]
"""

import argparse
import json
import os
import sys

from megadetector_tpu_torch.utils import ct_utils


class ValidateBatchResultsOptions:
    """Options controlling validate_batch_results()."""

    def __init__(self):
        # Verify that every image file exists (relative to
        # relative_path_base or the json's folder)
        self.check_image_existence = False
        # Base folder for relative paths
        self.relative_path_base = None
        # Raise on the first validation error instead of recording it
        self.raise_errors = False
        # Include the loaded data in the return value
        self.return_data = False
        self.verbose = False


def _error(message, validation_results, options):
    if options.raise_errors:
        raise ValueError(message)
    validation_results['validation_errors'].append(message)


def validate_batch_results(json_filename, options=None):
    """
    Validate an MD-format results file. Returns a dict with keys
    'validation_results' (containing 'validation_errors' and
    'validation_warnings') plus the loaded data when return_data is set.
    """

    if options is None:
        options = ValidateBatchResultsOptions()

    validation_results = {'filename': json_filename,
                          'validation_errors': [],
                          'validation_warnings': []}

    with open(json_filename, 'r') as f:
        data = json.load(f)

    # --- Top-level structure

    for key in ('images', 'detection_categories', 'info'):
        if key not in data:
            _error('Missing required field "{}"'.format(key),
                   validation_results, options)

    info = data.get('info', {})
    if 'format_version' not in info:
        _error('Missing info.format_version', validation_results, options)

    # --- Categories

    detection_categories = data.get('detection_categories', {})
    for k, v in detection_categories.items():
        if not isinstance(k, str) or not k.isdigit():
            _error('Illegal detection category ID {}'.format(k),
                   validation_results, options)
        if not isinstance(v, str):
            _error('Illegal detection category name {}'.format(v),
                   validation_results, options)

    classification_categories = data.get('classification_categories', {})
    for k, v in classification_categories.items():
        if not isinstance(k, str):
            _error('Illegal classification category ID {}'.format(k),
                   validation_results, options)

    # --- Images

    images = data.get('images', [])
    filenames = set()

    for i_image, im in enumerate(images):

        if 'file' not in im:
            _error('Image {} has no file field'.format(i_image),
                   validation_results, options)
            continue
        fn = im['file']

        if fn in filenames:
            _error('Duplicate image {}'.format(fn),
                   validation_results, options)
        filenames.add(fn)

        if 'failure' in im and im['failure'] is not None:
            if im.get('detections') is not None:
                _error('Image {} has both failure and detections'.format(
                    fn), validation_results, options)
            continue

        detections = im.get('detections', None)
        if detections is None:
            _error('Image {} has null detections but no failure'.format(fn),
                   validation_results, options)
            continue

        is_video = 'frame_rate' in im or 'frames_processed' in im

        if is_video:
            if not isinstance(im.get('frame_rate', 0), (int, float)):
                _error('Video {} has non-numeric frame rate'.format(fn),
                       validation_results, options)
            frames_processed = im.get('frames_processed', [])
            if not isinstance(frames_processed, list):
                _error('Video {} has invalid frames_processed'.format(fn),
                       validation_results, options)
                frames_processed = []
            frames_set = set(frames_processed)

        for det in detections:
            if 'category' not in det or 'conf' not in det or \
                    'bbox' not in det:
                _error('Image {} has an invalid detection'.format(fn),
                       validation_results, options)
                continue
            if det['category'] not in detection_categories:
                _error('Image {} detection has unknown category {}'.format(
                    fn, det['category']), validation_results, options)
            conf = det['conf']
            # Negative confidences are legal: repeat-detection elimination
            # marks suppressed repeats by flipping conf to -conf
            if not isinstance(conf, (int, float)) or conf < -1 or conf > 1:
                _error('Image {} detection has illegal confidence '
                       '{}'.format(fn, conf), validation_results, options)
            bbox = det['bbox']
            if not isinstance(bbox, list) or len(bbox) != 4 or \
                    not all(isinstance(v, (int, float)) for v in bbox):
                _error('Image {} detection has illegal bbox {}'.format(
                    fn, bbox), validation_results, options)
            else:
                x, y, w, h = bbox
                if x < -0.001 or y < -0.001 or w < 0 or h < 0 or \
                        x + w > 1.01 or y + h > 1.01:
                    validation_results['validation_warnings'].append(
                        'Image {} bbox outside unit square: {}'.format(
                            fn, bbox))
            if is_video and 'frame_number' in det:
                if det['frame_number'] not in frames_set:
                    _error('Video {} detection references unprocessed '
                           'frame {}'.format(fn, det['frame_number']),
                           validation_results, options)

            classifications = det.get('classifications', None)
            if classifications is not None:
                for c in classifications:
                    if not isinstance(c, list) or len(c) < 2:
                        _error('Image {} has illegal classification '
                               '{}'.format(fn, c),
                               validation_results, options)
                        continue
                    if classification_categories and \
                            c[0] not in classification_categories:
                        _error('Image {} classification has unknown '
                               'category {}'.format(fn, c[0]),
                               validation_results, options)

        # ...for each detection

        if options.check_image_existence:
            base = options.relative_path_base
            if base is None:
                base = os.path.dirname(os.path.abspath(json_filename))
            full_path = fn if ct_utils.is_iterable(fn) and \
                os.path.isabs(fn) else os.path.join(base, fn)
            if not os.path.exists(full_path):
                _error('Image {} does not exist'.format(full_path),
                       validation_results, options)

    # ...for each image

    to_return = {'validation_results': validation_results}
    if options.return_data:
        to_return.update(data)

    if options.verbose:
        print('Validated {}: {} errors, {} warnings'.format(
            json_filename,
            len(validation_results['validation_errors']),
            len(validation_results['validation_warnings'])))

    return to_return


def main(argv=None):

    parser = argparse.ArgumentParser(
        description='Validate an MD-format results file')
    parser.add_argument('json_filename')
    parser.add_argument('--check_image_existence', action='store_true')
    parser.add_argument('--relative_path_base', default=None)
    parser.add_argument('--raise_errors', action='store_true')
    parser.add_argument('--verbose', action='store_true')

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    options = ValidateBatchResultsOptions()
    ct_utils.args_to_object(args, options)
    results = validate_batch_results(args.json_filename, options)
    errors = results['validation_results']['validation_errors']
    if len(errors) == 0:
        print('Validation successful')
    else:
        print('Validation failed with {} errors:'.format(len(errors)))
        for e in errors:
            print('  ' + e)
        sys.exit(1)


if __name__ == '__main__':
    main()
