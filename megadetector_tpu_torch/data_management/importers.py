"""
Importers: convert third-party camera-trap tool outputs into the MD
results format so the whole postprocessing ecosystem applies to them.

Behavioral contract follows the reference's importer family
(megadetector/data_management/: zamba_to_md.py, animl_to_md.py,
camtrap_dp_to_md.py, mewc_to_md.py): each maps a tool's CSV/JSON output
onto MD images/detections with string-int categories.

The port's own copy of megadetector_tpu/data_management/importers.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import csv
import json
import os
import sys

from megadetector_tpu_torch.utils import ct_utils

DEFAULT_CATEGORIES = {'1': 'animal', '2': 'person', '3': 'vehicle'}


def _base_output(detector_name):
    return {'images': [],
            'detection_categories': dict(DEFAULT_CATEGORIES),
            'info': {'format_version': '1.6',
                     'detector': detector_name}}


def zamba_to_md(input_csv, output_file=None):
    """
    Convert zamba video-classification output (CSV: filepath + one
    probability column per species) to MD format: one video record per
    row, the species probabilities as full-frame classifications on a
    synthetic animal detection.
    """

    with open(input_csv, newline='') as f:
        rows = list(csv.DictReader(f))
    assert len(rows) > 0, 'Empty zamba CSV'

    species = [c for c in rows[0].keys() if c not in ('filepath', 'path')]
    classification_categories = {str(i): name
                                 for i, name in enumerate(species)}

    data = _base_output('zamba')
    data['classification_categories'] = classification_categories

    for row in rows:
        fn = row.get('filepath') or row.get('path')
        probs = sorted(
            ((str(i), float(row[name] or 0))
             for i, name in enumerate(species)),
            key=lambda kv: -kv[1])
        top_prob = probs[0][1]
        blank_ids = [str(i) for i, name in enumerate(species)
                     if name.lower() == 'blank']
        is_blank = blank_ids and probs[0][0] in blank_ids
        im = {'file': fn}
        if is_blank:
            im['detections'] = []
        else:
            im['detections'] = [{
                'category': '1',
                'conf': round(top_prob, 3),
                'bbox': [0.0, 0.0, 1.0, 1.0],
                'classifications': [[c, round(p, 4)]
                                    for c, p in probs[:3]],
            }]
        data['images'].append(im)

    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def animl_to_md(input_csv, output_file=None):
    """
    Convert animl detection CSV (columns FilePath/category/conf plus
    bbox1..bbox4 as x/y/w/h normalized) to MD format.
    """

    with open(input_csv, newline='') as f:
        rows = list(csv.DictReader(f))

    data = _base_output('animl')
    fn_to_detections = {}

    for row in rows:
        fn = row.get('FilePath') or row.get('file') or row.get('Frame')
        fn_to_detections.setdefault(fn, [])
        category = row.get('category') or row.get('class')
        conf = row.get('conf') or row.get('confidence')
        if category is None or conf is None or float(conf) <= 0:
            continue
        bbox = [float(row.get('bbox1', 0)), float(row.get('bbox2', 0)),
                float(row.get('bbox3', 0)), float(row.get('bbox4', 0))]
        fn_to_detections[fn].append({
            'category': str(int(float(category))),
            'conf': round(float(conf), 3),
            'bbox': ct_utils.round_float_array(bbox, 4),
        })

    for fn, detections in fn_to_detections.items():
        data['images'].append({'file': fn, 'detections': detections})

    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def camtrap_dp_to_md(package_folder, output_file=None):
    """
    Convert a Camtrap DP data package (datapackage.json + media.csv +
    observations.csv) to MD format: one image per media record,
    observations as full-frame or bbox detections.
    """

    media_file = os.path.join(package_folder, 'media.csv')
    obs_file = os.path.join(package_folder, 'observations.csv')
    assert os.path.isfile(media_file) and os.path.isfile(obs_file), \
        'Not a Camtrap DP package: {}'.format(package_folder)

    with open(media_file, newline='') as f:
        media = {row['mediaID']: row for row in csv.DictReader(f)}
    with open(obs_file, newline='') as f:
        observations = list(csv.DictReader(f))

    data = _base_output('camtrap-dp')
    classification_names = {}
    media_to_detections = {mid: [] for mid in media}

    for obs in observations:
        mid = obs.get('mediaID')
        if mid not in media_to_detections:
            continue
        obs_type = (obs.get('observationType') or '').lower()
        if obs_type in ('blank', 'empty', 'unknown', ''):
            continue
        if obs_type == 'human':
            category = '2'
        elif obs_type == 'vehicle':
            category = '3'
        else:
            category = '1'
        det = {'category': category,
               'conf': float(obs.get('classificationProbability')
                             or 1.0),
               'bbox': [
                   float(obs.get('bboxX') or 0),
                   float(obs.get('bboxY') or 0),
                   float(obs.get('bboxWidth') or 1),
                   float(obs.get('bboxHeight') or 1)]}
        name = obs.get('scientificName')
        if name:
            if name not in classification_names:
                classification_names[name] = str(
                    len(classification_names))
            det['classifications'] = [[classification_names[name],
                                       det['conf']]]
        media_to_detections[mid].append(det)

    for mid, m in media.items():
        fn = m.get('filePath') or m.get('fileName') or mid
        data['images'].append({'file': fn,
                               'detections': media_to_detections[mid]})

    if classification_names:
        data['classification_categories'] = {
            v: k for k, v in classification_names.items()}

    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data




def mewc_to_md(mewc_csv, output_file=None,
               category_name_column='class_id'):
    """
    Convert MEWC (Mega Efficient Wildlife Classifier) output CSV to MD
    format: rows carry filename, class, and probability; detections are
    full-frame animal boxes with the class attached as a classification.
    """

    with open(mewc_csv, newline='') as f:
        rows = list(csv.DictReader(f))

    data = _base_output('mewc')
    classification_names = {}
    fn_to_detections = {}

    for row in rows:
        fn = row.get('filename') or row.get('file') or row.get('image')
        if fn is None:
            continue
        fn_to_detections.setdefault(fn, [])
        label = row.get(category_name_column) or row.get('class')
        prob = float(row.get('prob') or row.get('probability') or
                     row.get('conf') or 1.0)
        if label is None or str(label).lower() in ('blank', 'empty'):
            continue
        label = str(label)
        if label not in classification_names:
            classification_names[label] = str(len(classification_names))
        fn_to_detections[fn].append({
            'category': '1',
            'conf': round(prob, 3),
            'bbox': [0.0, 0.0, 1.0, 1.0],
            'classifications': [[classification_names[label],
                                 round(prob, 4)]],
        })

    for fn, detections in fn_to_detections.items():
        data['images'].append({'file': fn, 'detections': detections})
    if classification_names:
        data['classification_categories'] = {
            v: k for k, v in classification_names.items()}

    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def animl_results_to_md_results(input_file, output_file=None):
    """
    Convert an Animl .csv results file (with both detection and
    classification columns) to an MD-formatted .json file (reference:
    animl_to_md.py:36-140). Expects columns 'file', 'category',
    'detection_conf', 'bbox1'..'bbox4', 'class', and
    'classification_conf'; each row becomes a detection carrying one
    classification. Returns the output filename (defaults to
    [input_file].json).
    """

    if output_file is None:
        output_file = input_file + '.json'

    with open(input_file, newline='') as f:
        rows = list(csv.DictReader(f))
    assert len(rows) > 0, 'Empty animl CSV'

    expected_columns = ('file', 'category', 'detection_conf',
                        'bbox1', 'bbox2', 'bbox3', 'bbox4',
                        'class', 'classification_conf')
    for s in expected_columns:
        assert s in rows[0], 'Expected column {} not found'.format(s)

    classification_category_name_to_id = {}
    filename_to_results = {}

    for i_row, row in enumerate(rows):
        fn = row['file']
        if fn in filename_to_results:
            im = filename_to_results[fn]
        else:
            im = {'file': fn, 'detections': []}
            filename_to_results[fn] = im

        assert row['category'] and \
            float(row['category']).is_integer(), \
            'Invalid category identifier in row {} (file: {})'.format(
                i_row, fn)
        detection_category_id = str(int(float(row['category'])))
        assert detection_category_id in DEFAULT_CATEGORIES, \
            'Unrecognized detection category ID {}'.format(
                detection_category_id)

        classification_category_name = row['class']
        if classification_category_name not in \
                classification_category_name_to_id:
            classification_category_name_to_id[
                classification_category_name] = \
                str(len(classification_category_name_to_id))
        classification_category_id = \
            classification_category_name_to_id[
                classification_category_name]

        im['detections'].append({
            'category': detection_category_id,
            'conf': float(row['detection_conf']),
            'bbox': [float(row['bbox1']), float(row['bbox2']),
                     float(row['bbox3']), float(row['bbox4'])],
            'classifications': [[classification_category_id,
                                 float(row['classification_conf'])]],
        })

    results = {
        'info': {'format_version': '1.3', 'detector': 'Animl',
                 'classifier': 'Animl'},
        'detection_categories': dict(DEFAULT_CATEGORIES),
        'classification_categories':
            {v: k for k, v in
             classification_category_name_to_id.items()},
        'images': list(filename_to_results.values()),
    }
    ct_utils.write_json(output_file, results, force_str=True)
    return output_file


def zamba_results_to_md_results(input_file, output_file=None,
                                image_folder=None):
    """
    Convert a zamba .csv results file to an MD-formatted .json file
    (reference: zamba_to_md.py:66-100). [image_folder] supports zamba's
    image (rather than video) outputs, whose rows name file *stems*
    assumed unique within that folder. Returns the output filename
    (defaults to [input_file].json).
    """

    if output_file is None:
        output_file = input_file + '.json'

    data = zamba_to_md(input_file)

    if image_folder is not None:
        stem_to_relpath = {}
        for dirpath, _, files in os.walk(image_folder):
            for fn in files:
                stem = os.path.splitext(fn)[0]
                rel = os.path.relpath(os.path.join(dirpath, fn),
                                      image_folder)
                assert stem not in stem_to_relpath, \
                    'File name stem {} is not unique in {}'.format(
                        stem, image_folder)
                stem_to_relpath[stem] = rel.replace('\\', '/')
        for im in data['images']:
            stem = os.path.splitext(os.path.basename(im['file']))[0]
            if stem in stem_to_relpath:
                im['file'] = stem_to_relpath[stem]

    ct_utils.write_json(output_file, data, force_str=True)
    return output_file


def main():
    parser = argparse.ArgumentParser(
        description='Convert third-party outputs to MD format')
    parser.add_argument('format', choices=['zamba', 'animl', 'camtrap_dp', 'mewc'])
    parser.add_argument('input_path')
    parser.add_argument('output_file')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    converter = {'zamba': zamba_to_md, 'animl': animl_to_md,
                 'camtrap_dp': camtrap_dp_to_md,
                 'mewc': mewc_to_md}[args.format]
    converter(args.input_path, args.output_file)


if __name__ == '__main__':
    main()
