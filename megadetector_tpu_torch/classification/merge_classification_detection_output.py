"""
Merge classification results into an MD detections file.

Reference contract
(megadetector/classification/merge_classification_detection_output.py:
1-509): the input CSV is either an evaluate_model outputs CSV (with one
confidence column per label name) or a dataset CSV (with only a 'label'
column). Crop paths follow the ___cropXX[_mdvY.Y].jpg convention and
map back to (image file, detection index). Each crop's detection gains
a 'classifications' list:

- with per-label confidences: [[category_id, conf], ...] sorted
  descending by confidence (truncated to top_k);
- with only a ground-truth label: [[str(1000000 + label_id), 1.0]] —
  the 1e6 offset distinguishes label categories from predictions;
- with both, predictions plus the label entry (label last by default,
  first with label_first=True).

The output file carries 'classification_categories' built from the
label index (plus the offset label categories when present).

The port's own copy of
megadetector_tpu/classification/merge_classification_detection_output.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import json
import os
import sys

from datetime import datetime

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils.ct_utils import round_float
from megadetector_tpu_torch.classification.crop_detections import \
    parse_crop_filename

LABEL_CATEGORY_OFFSET = 1000000


def read_classification_csv(csv_path):
    """
    Read an outputs/dataset CSV; returns (rows, label_columns) where
    each row is {'path', 'label' (may be ''), 'probs': {name: conf}}.
    """

    rows = []
    with open(csv_path) as f:
        header = f.readline().rstrip('\n').split(',')
        assert header[0] == 'path', 'CSV must start with a path column'
        meta_cols = [c for c in header
                     if c in ('path', 'dataset', 'location',
                              'dataset_class', 'confidence', 'label',
                              'weight')]
        label_cols = [c for c in header if c not in meta_cols]
        for line in f:
            parts = line.rstrip('\n').split(',')
            if len(parts) < len(header):
                continue
            rec = dict(zip(header, parts))
            probs = {c: float(rec[c]) for c in label_cols}
            rows.append({'path': rec['path'],
                         'label': rec.get('label', ''),
                         'probs': probs})
    return rows, label_cols


def row_to_classification_list(row, label_names, contains_preds,
                               label_pos, threshold,
                               relative_conf=False):
    """
    Serialize one classification-results row (a mapping from label name
    to probability, plus an optional 'label') into the MD
    classifications list: [(str(label_id), prob), ...] sorted
    highest-probability first, confidences rounded to 4 digits and
    thresholded (reference:
    merge_classification_detection_output.py:94-143). When the row has
    a ground-truth label and [label_pos] is 'first'/'last', a
    (str(label_id + 1000000), 1.0) entry marks it.
    """

    contains_label = 'label' in row
    assert contains_label or contains_preds
    if relative_conf:
        assert contains_label and contains_preds

    result = []
    if contains_preds:
        result = [(str(i), row[label])
                  for i, label in enumerate(label_names)]
        if relative_conf:
            label_conf = row[row['label']]
            result = [(k, max(v - label_conf, 0)) for k, v in result]
        result = [(k, round_float(conf, 4))
                  for k, conf in result if conf >= threshold]
        result = sorted(result, key=lambda x: x[1], reverse=True)

    if contains_label and label_pos is not None:
        label_id = label_names.index(row['label'])
        item = (str(label_id + LABEL_CATEGORY_OFFSET), 1.)
        if label_pos == 'first':
            result = [item] + result
        else:
            result.append(item)
    return result


def process_queried_images(df, queried_images_json_path,
                           detector_output_cache_base_dir,
                           detector_version, datasets=None,
                           samples_per_label=None, seed=123):
    """
    Build a detections JSON (with 'images' as a dict keyed by
    image path) covering exactly the crop paths in [df] — detections
    pulled from the per-dataset detector cache for _mdv crops, or
    synthesized at confidence 1.0 from the queried images' ground-truth
    boxes (reference:
    merge_classification_detection_output.py:146-264). [df] is indexed
    by crop path (<dataset>/<img_file>___cropXX[_mdvY.Y].jpg).
    """

    assert os.path.exists(queried_images_json_path)
    detection_cache_dir = os.path.join(
        detector_output_cache_base_dir, 'v{}'.format(detector_version))
    assert os.path.isdir(detection_cache_dir)

    df = df.copy()
    df['dataset'] = df.index.map(lambda x: x[:x.find('/')])
    unique_datasets = df['dataset'].unique()
    if datasets is not None:
        for ds in datasets:
            assert ds in unique_datasets
        df = df[df['dataset'].isin(datasets)]
    else:
        datasets = unique_datasets

    if samples_per_label is not None:
        df = df.groupby('label').sample(samples_per_label,
                                        random_state=seed)

    with open(queried_images_json_path, 'r') as f:
        queried_images_js = json.load(f)

    merged_js = {'images': {}, 'info': {}}
    images = merged_js['images']

    for ds in datasets:
        ds_df = df[df['dataset'] == ds]
        with open(os.path.join(detection_cache_dir,
                               '{}.json'.format(ds)), 'r') as f:
            detection_js = json.load(f)
        img_file_to_index = {im['file']: idx for idx, im
                             in enumerate(detection_js['images'])}

        class_info = merged_js['info']
        if 'detector' not in class_info:
            class_info['detector'] = detection_js['info'].get('detector')
        assert class_info['detector'] == \
            detection_js['info'].get('detector')

        if 'detection_categories' not in merged_js:
            merged_js['detection_categories'] = \
                detection_js['detection_categories']
        assert merged_js['detection_categories'] == \
            detection_js['detection_categories']
        cat_to_catid = {v: k for k, v in
                        detection_js['detection_categories'].items()}

        for crop_path in ds_df.index:
            img_path, suffix = crop_path.split('___crop')
            img_file = img_path[img_path.find('/') + 1:]
            if '_mdv' in suffix and img_path not in images:
                img_idx = img_file_to_index[img_file]
                images[img_path] = detection_js['images'][img_idx]
                images[img_path]['file'] = img_path
            elif img_path not in images:
                images[img_path] = {
                    'file': img_path,
                    'detections': [
                        {'category':
                         cat_to_catid[bbox_dict['category']],
                         'conf': 1.0,
                         'bbox': bbox_dict['bbox']}
                        for bbox_dict in
                        queried_images_js[img_path]['bbox']],
                }
    return merged_js


def combine_classification_with_detection(
        detection_js, df, idx_to_label, label_names, classifier_name,
        classifier_timestamp, threshold, label_pos=None,
        relative_conf=False, typical_confidence_threshold=None):
    """
    Attach classification results from [df] (indexed by crop path, one
    probability column per label name, optional 'label') to
    [detection_js] (whose 'images' field is a dict keyed by image
    path, as produced by process_queried_images); converts 'images'
    back to a list and returns the updated dict (reference:
    merge_classification_detection_output.py:267-336).
    """

    classification_metadata = {
        'classifier': classifier_name,
        'classification_completion_time': classifier_timestamp,
    }
    if typical_confidence_threshold is not None:
        classification_metadata['classifier_metadata'] = {
            'typical_classification_threshold':
                typical_confidence_threshold}
    detection_js['info'].update(classification_metadata)
    detection_js['classification_categories'] = idx_to_label

    contains_preds = set(label_names) <= set(df.columns)
    if not contains_preds:
        print('CSV does not contain predictions. Outputting labels '
              'only.')

    images = detection_js['images']
    for crop_path in df.index:
        img_path, suffix = crop_path.split('___crop')
        crop_index = int(suffix[:2])
        detection_dict = images[img_path]['detections'][crop_index]
        detection_dict['classifications'] = row_to_classification_list(
            row=df.loc[crop_path], label_names=label_names,
            contains_preds=contains_preds, label_pos=label_pos,
            threshold=threshold, relative_conf=relative_conf)

    detection_js['images'] = list(images.values())
    return detection_js


def merge_classification_detection_output(
        classification_csv_path,
        detections_json_path,
        output_json_path,
        label_index_path=None,
        classifier_name='classifier',
        threshold=0.0,
        top_k=5,
        label_first=False):
    """
    Attach classifications from [classification_csv_path] to
    [detections_json_path]; writes the merged MD file to
    [output_json_path]. Returns the merged dict.
    """

    rows, label_cols = read_classification_csv(classification_csv_path)

    label_names = None
    if label_index_path is not None:
        with open(label_index_path) as f:
            label_index = json.load(f)
        label_names = [label_index[str(i)]
                       for i in range(len(label_index))]
    elif label_cols:
        label_names = label_cols

    name_to_id = {n: i for i, n in enumerate(label_names or [])}

    with open(detections_json_path) as f:
        data = json.load(f)
    det_by_file = {im['file']: im for im in data['images']}

    label_categories_used = {}
    n_merged = 0

    for row in rows:
        parsed = parse_crop_filename(row['path'])
        if parsed is None:
            continue
        image_file, crop_index = parsed
        im = det_by_file.get(image_file)
        if im is None or im.get('detections') is None or \
                crop_index >= len(im['detections']):
            continue
        det = im['detections'][crop_index]

        classifications = []
        if row['probs']:
            scored = sorted(row['probs'].items(),
                            key=lambda kv: -kv[1])[:top_k]
            for name, conf in scored:
                if conf < threshold or name not in name_to_id:
                    continue
                classifications.append(
                    [str(name_to_id[name]), round_float(conf, 4)])
        if row['label'] and row['label'] in name_to_id:
            label_id = str(LABEL_CATEGORY_OFFSET +
                           name_to_id[row['label']])
            label_categories_used[label_id] = row['label']
            entry = [label_id, 1.0]
            if row['probs']:
                if label_first:
                    classifications.insert(0, entry)
                else:
                    classifications.append(entry)
            else:
                classifications = [entry]
        if classifications:
            det['classifications'] = classifications
            n_merged += 1

    classification_categories = {
        str(i): n for i, n in enumerate(label_names or [])}
    classification_categories.update(label_categories_used)
    data['classification_categories'] = classification_categories
    info = data.setdefault('info', {})
    info['classifier'] = classifier_name
    info['classification_completion_time'] = \
        datetime.now().strftime('%Y-%m-%d %H:%M:%S')

    os.makedirs(os.path.dirname(os.path.abspath(output_json_path)),
                exist_ok=True)
    ct_utils.write_json(output_json_path, data)
    print('Merged classifications into {} detections -> {}'.format(
        n_merged, output_json_path))
    return data


def main():
    parser = argparse.ArgumentParser(
        description='Merge classification CSV results into an MD '
                    'detections file')
    parser.add_argument('classification_csv')
    parser.add_argument('detections_json')
    parser.add_argument('output_json')
    parser.add_argument('--label_index', default=None)
    parser.add_argument('--classifier_name', default='classifier')
    parser.add_argument('--threshold', type=float, default=0.0)
    parser.add_argument('--top_k', type=int, default=5)
    parser.add_argument('--label_first', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    merge_classification_detection_output(
        args.classification_csv, args.detections_json, args.output_json,
        label_index_path=args.label_index,
        classifier_name=args.classifier_name,
        threshold=args.threshold, top_k=args.top_k,
        label_first=args.label_first)


if __name__ == '__main__':
    main()
