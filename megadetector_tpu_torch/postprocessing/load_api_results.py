"""
Load / save MD results files as pandas DataFrames.

Behavioral contract follows the reference loader
(megadetector/postprocessing/load_api_results.py:33-230): one DataFrame row
per image with 'file', 'detections', optional 'failure'; other top-level
fields returned in other_fields; max_detection_conf recomputed when
requested.

The port's own copy of megadetector_tpu/postprocessing/load_api_results.py:
the same public names, signatures, defaults and output bytes. pandas is
imported inside the functions that build or read data frames.
"""

import json
import os

from megadetector_tpu_torch.utils import ct_utils


def load_api_results(api_output_filename, normalize_paths=True,
                     filename_replacements=None, force_forward_slashes=True):
    """
    Load an MD results .json into a pandas DataFrame + other fields.

    Returns:
        (DataFrame, other_fields dict)
    """

    import pandas as pd

    print('Loading results from {}'.format(api_output_filename))

    with open(api_output_filename) as f:
        detection_results = json.load(f)

    # Validate basic structure
    for s in ('images', 'detection_categories', 'info'):
        assert s in detection_results, \
            'Missing field {} in detection results'.format(s)

    other_fields = {k: v for k, v in detection_results.items()
                    if k != 'images'}

    images = detection_results['images']

    if normalize_paths or force_forward_slashes:
        for im in images:
            if force_forward_slashes:
                im['file'] = im['file'].replace('\\', '/')
            if normalize_paths:
                im['file'] = os.path.normpath(im['file']).replace(
                    '\\', '/')

    if filename_replacements is not None:
        for string_to_replace, replacement in \
                filename_replacements.items():
            for im in images:
                im['file'] = im['file'].replace(string_to_replace,
                                                replacement)

    detection_results = pd.DataFrame(images)

    # Convenience column
    if 'max_detection_conf' not in detection_results.columns:
        detection_results['max_detection_conf'] = [
            ct_utils.get_max_conf(im) for im in images]

    print('Finished loading MegaDetector results for {} images from {}'
          .format(len(detection_results), api_output_filename))

    return detection_results, other_fields


def write_api_results(detection_results_table, other_fields, out_path,
                      prune_max_conf=True):
    """
    Inverse of load_api_results(): write a DataFrame back to an MD-format
    .json file.
    """

    print('Writing detection results to {}'.format(out_path))

    fields = dict(other_fields)

    images = detection_results_table.to_json(
        orient='records', double_precision=4)
    images = json.loads(images)

    if prune_max_conf:
        for im in images:
            im.pop('max_detection_conf', None)

    # Remove null optional fields pandas may have introduced
    for im in images:
        for k in [k for k, v in im.items()
                  if v is None and k not in ('detections',)]:
            del im[k]

    fields['images'] = images
    ct_utils.write_json(out_path, fields, force_str=True)
    print('...done')
    return fields


def load_md_or_speciesnet_file(filename, verbose=False):
    """
    Load an MD-format .json file as a raw dict (SpeciesNet prediction files
    are converted by the caller before reaching here).
    """

    with open(filename) as f:
        d = json.load(f)
    assert 'images' in d, 'File {} is not an MD results file'.format(
        filename)
    return d

def load_api_results_csv(filename, normalize_paths=True,
                         filename_replacements=None, nrows=None):
    """
    [DEPRECATED] Load legacy .csv-format MegaDetector results
    (columns image_path, max_confidence, detections) into a pandas
    table, deserializing the 'detections' JSON column
    (reference: load_api_results.py:148-199).
    """

    import pandas as pd

    detection_results = pd.read_csv(filename, nrows=nrows)
    for s in ('image_path', 'max_confidence', 'detections'):
        assert s in detection_results.columns, \
            '{} missing column {}'.format(filename, s)

    if normalize_paths:
        detection_results['image_path'] = \
            detection_results['image_path'].apply(os.path.normpath)
    if filename_replacements:
        for string_to_replace, replacement in \
                filename_replacements.items():
            detection_results['image_path'] = \
                detection_results['image_path'].str.replace(
                    string_to_replace, replacement, regex=False)
    detection_results['detections'] = \
        detection_results['detections'].apply(json.loads)
    return detection_results


def write_api_results_csv(detection_results, filename):
    """
    [DEPRECATED] Write a legacy-CSV results table; re-serializes the
    'detections' column to JSON
    (reference: load_api_results.py:202-223).
    """

    out_dir = os.path.dirname(filename)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    df = detection_results.copy()
    df['detections'] = df['detections'].apply(json.dumps)
    df.to_csv(filename, index=False)
