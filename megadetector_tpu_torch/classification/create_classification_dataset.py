"""
Build a classification dataset CSV + label index + location-aware
train/val/test splits from a "queried images" JSON and a crop folder.
The port's copy of megadetector_tpu/classification/
create_classification_dataset.py (no device code; the same names,
defaults and output bytes; pandas imported inside the functions that use
it).

Reference contract
(megadetector/classification/create_classification_dataset.py:1-626):

- input: queried_images.json mapping '<dataset>/<file>' to
  {'dataset', 'location', 'class', 'label': [..], optional 'bbox'}
  (ground-truth boxes crop with confidence 1.0; MegaDetector boxes
  carry their detection confidence)
- outputs, in <output_dir>:
  1) classification_ds.csv with columns
     path,dataset,location,dataset_class,confidence,label
  2) label_index.json: {"0": label_name, ...} sorted label names
  3) splits.json: {'train'|'val'|'test': [[dataset, location], ...]}

Splitting is by (dataset, location) so no camera location leaks across
splits (the assumption that (dataset, location) is globally unique is
inherited from the reference). The reference solves a small
optimization; this implementation uses a seeded greedy assignment that
balances each label's crop counts toward the requested fractions —
same contract, simpler machinery.
"""

import argparse
import collections
import json
import os
import random
import sys

from megadetector_tpu_torch.classification.crop_detections import (  # noqa
    crop_filename, parse_crop_filename)
from megadetector_tpu_torch.utils import ct_utils


def build_crop_rows(queried_images, cropped_images_dir,
                    detections=None, detector_version=None,
                    confidence_threshold=0.0,
                    require_crop_files=True):
    """
    One CSV row per crop. Ground-truth 'bbox' entries yield confidence
    1.0; otherwise detections from [detections] (an MD results dict
    keyed by file) yield their detection confidence.

    Returns a list of row dicts.
    """

    det_by_file = {}
    if detections is not None:
        det_by_file = {im['file']: im for im in detections['images']}

    rows = []
    for img_path, info in queried_images.items():
        dataset = info.get('dataset',
                           img_path.split('/', 1)[0]
                           if '/' in img_path else '')
        location = str(info.get('location', 'unknown'))
        dataset_class = info.get('class', '')
        label = ','.join(info.get('label', []))

        crops = []
        if 'bbox' in info:
            for i_box, _ in enumerate(info['bbox']):
                crops.append((i_box, 1.0, None))
        else:
            im = det_by_file.get(img_path)
            if im is None or im.get('detections') is None:
                continue
            for i_det, det in enumerate(im['detections']):
                if det['conf'] >= confidence_threshold:
                    crops.append((i_det, det['conf'], detector_version))

        for i_crop, conf, version in crops:
            rel = crop_filename(img_path, i_crop, version)
            if require_crop_files and not os.path.isfile(
                    os.path.join(cropped_images_dir, rel)):
                continue
            rows.append({
                'path': rel,
                'dataset': dataset,
                'location': location,
                'dataset_class': dataset_class,
                'confidence': conf,
                'label': label,
            })
    return rows


def split_locations(rows, split_fractions=(0.7, 0.15, 0.15), seed=0):
    """
    Assign (dataset, location) pairs to train/val/test greedily: visit
    locations in seeded-shuffled order (largest-first within the
    shuffle tiers) and give each to the split currently furthest below
    its target crop count. Returns {'train': [[dataset, location]...],
    'val': ..., 'test': ...}.
    """

    assert abs(sum(split_fractions) - 1.0) < 1e-6
    loc_counts = collections.Counter(
        (r['dataset'], r['location']) for r in rows)
    locations = list(loc_counts.keys())
    random.Random(seed).shuffle(locations)
    locations.sort(key=lambda lc: -loc_counts[lc])

    names = ['train', 'val', 'test']
    total = sum(loc_counts.values())
    targets = {name: f * total
               for name, f in zip(names, split_fractions)}
    assigned = {name: 0 for name in names}
    splits = {name: [] for name in names}

    for lc in locations:
        # Furthest below target (relative deficit)
        name = max(names, key=lambda n: (targets[n] - assigned[n]) /
                   max(targets[n], 1e-9))
        splits[name].append([lc[0], lc[1]])
        assigned[name] += loc_counts[lc]
    return splits


def create_classification_csv(queried_images_json_path,
                              detector_output_cache_base_dir,
                              detector_version,
                              cropped_images_dir,
                              confidence_threshold,
                              min_locs=None, append_df=None,
                              exclude_locs=None):
    """
    Build the classification dataset as a pandas DataFrame with columns
    path,dataset,location,dataset_class,confidence,label, reading
    per-dataset cached MD results from
    <detector_output_cache_base_dir>/v<detector_version>/<dataset>.json
    (reference: create_classification_dataset.py:189-340). Returns
    (df, log) where log lists images missing detections, images
    without confident detections, and missing crops.
    """

    import pandas as pd

    from megadetector_tpu_torch.classification.detect_and_crop import \
        load_detection_cache

    assert 0 <= confidence_threshold <= 1
    columns = ['path', 'dataset', 'location', 'dataset_class',
               'confidence', 'label']
    if append_df is not None:
        assert list(append_df.columns) == columns

    with open(queried_images_json_path, 'r') as f:
        js = json.load(f)

    detector_output_cache_dir = os.path.join(
        detector_output_cache_base_dir, 'v{}'.format(detector_version))
    datasets = set(img_path.split('/', 1)[0] for img_path in js)
    detection_cache, cat_id_to_name = load_detection_cache(
        detector_output_cache_dir, datasets)

    missing_detections = []
    images_no_confident_detections = []
    images_missing_crop = []
    all_rows = []

    for img_path, img_info in js.items():
        ds, img_file = img_path.split('/', maxsplit=1)

        if 'bbox' in img_info:
            bbox_dicts = img_info['bbox']
            is_ground_truth = True
        else:
            if img_file in detection_cache.get(ds, {}):
                bbox_dicts = list(
                    detection_cache[ds][img_file].get('detections')
                    or [])
                # Convert category IDs to names for the animal filter
                bbox_dicts = [
                    dict(d, category=cat_id_to_name.get(d['category'],
                                                        d['category']))
                    for d in bbox_dicts]
            else:
                missing_detections.append(img_path)
                continue
            is_ground_truth = False

        rows = []
        for i, bbox_dict in enumerate(bbox_dicts):
            conf = 1.0 if is_ground_truth else bbox_dict['conf']
            if conf < confidence_threshold:
                continue
            if not is_ground_truth and \
                    bbox_dict.get('category') != 'animal':
                continue
            crop_path = crop_filename(
                img_path, i,
                None if is_ground_truth else detector_version)
            if not os.path.exists(os.path.join(cropped_images_dir,
                                               crop_path)):
                images_missing_crop.append((img_path, i))
                continue
            rows.append([crop_path, ds,
                         img_info.get('location', 'unknown_location'),
                         img_info.get('class', ''),
                         conf, ','.join(img_info.get('label', []))])
        if len(rows) == 0:
            images_no_confident_detections.append(img_path)
            continue
        all_rows += rows

    df = pd.DataFrame(data=all_rows, columns=columns)

    if min_locs is not None and len(df) > 0:
        nlocs_per_label = df.groupby('label').apply(
            lambda xdf: len(xdf[['dataset',
                                 'location']].drop_duplicates()))
        valid_labels = nlocs_per_label.index[nlocs_per_label >=
                                             min_locs]
        df = df[df['label'].isin(valid_labels)]
    if exclude_locs is not None and len(df) > 0:
        mask = ~pd.Series(list(zip(df['dataset'], df['location'])),
                          index=df.index).isin(set(exclude_locs))
        df = df[mask]
    if append_df is not None:
        df = pd.concat([df, append_df], ignore_index=True)

    log = {
        'images missing detections': missing_detections,
        'images without confident detections':
            images_no_confident_detections,
        'missing crops': images_missing_crop,
    }
    return df, log


def sort_locs_by_size(loc_to_size, prioritize=None):
    """
    Sort (dataset, location) keys smallest-size-first, optionally
    putting locations from the [prioritize] datasets first
    (reference: create_classification_dataset.py:512-539). Modifies
    [loc_to_size] in place when prioritizing.
    """

    result = []
    if prioritize is not None:
        prioritized = {loc: loc_to_size.pop(loc)
                       for loc in list(loc_to_size.keys())
                       if loc[0] in prioritize}
        result = sort_locs_by_size(prioritized)
    result += sorted(loc_to_size, key=loc_to_size.__getitem__)
    return result


def create_splits_random(df, val_frac, test_frac=0., test_split=None,
                         n_iterations=10000, seed=None):
    """
    Randomized-search location splits: sample candidate
    train/val(/test) partitions of the (dataset, location) set and keep
    the one whose per-label crop and location fractions land closest to
    the targets (reference: create_classification_dataset.py:343-423).
    [df] has columns dataset/location/label, one row per image.
    Returns {'train'|'val'|'test': [(dataset, location), ...]}.
    [n_iterations] and [seed] are knobs over the reference's fixed
    10,000 unseeded draws.
    """

    import numpy as np

    rng = np.random.RandomState(seed)
    if test_split is not None:
        assert test_frac == 0
    train_frac = 1. - val_frac - test_frac
    targets = {'train': train_frac, 'val': val_frac, 'test': test_frac}

    df = df.copy()
    df['dataset_location'] = df['dataset'] + '/' + df['location']
    loc_label_counts = (df.groupby(['label', 'dataset_location'])
                        .size().unstack('label', fill_value=0))
    num_locs = len(loc_label_counts)

    label_count = loc_label_counts.sum()
    loc_count = (loc_label_counts > 0).sum()

    best_score = float('inf')
    best_splits = None
    for _ in range(n_iterations):
        num_train = int(num_locs *
                        (train_frac + rng.uniform(-.03, .03)))
        if test_frac > 0:
            num_val = int(num_locs *
                          (val_frac + rng.uniform(-.03, .03)))
        else:
            num_val = num_locs - num_train
        permuted_locs = \
            loc_label_counts.index[rng.permutation(num_locs)]
        split_to_locs = {
            'train': permuted_locs[:num_train],
            'val': permuted_locs[num_train:num_train + num_val]}
        if test_frac > 0:
            split_to_locs['test'] = \
                permuted_locs[num_train + num_val:]

        score = 0.
        for split, locs in split_to_locs.items():
            split_df = loc_label_counts.loc[locs]
            target = targets[split]
            # SSE for images per label (2x weight), plus locations
            # per label
            crop_frac = split_df.sum() / label_count
            score += 2 * ((crop_frac - target) ** 2).sum()
            loc_frac = (split_df > 0).sum() / loc_count
            score += ((loc_frac - target) ** 2).sum()
        if score < best_score:
            best_score = score
            best_splits = split_to_locs

    assert best_splits is not None
    split_to_locs = {
        s: sorted(tuple(x.split('/', maxsplit=1)) for x in locs)
        for s, locs in best_splits.items()}
    if test_split is not None:
        split_to_locs['test'] = test_split
    return split_to_locs


def create_splits_smallest_label_first(df, val_frac, test_frac=0.,
                                       label_spec_json_path=None,
                                       test_split=None):
    """
    Greedy location splits, rarest label first: walk labels from
    smallest to largest and assign each label's locations
    (smallest-first, optionally prioritizing datasets from the label
    spec) to test until it reaches its target fraction, then val, then
    train (reference: create_classification_dataset.py:425-509; the
    reference iterates labels where it means locations in its final
    filter — an upstream bug — so this implementation filters the
    location list as intended). Returns
    {'train'|'val'|'test': [(dataset, location), ...]}.
    """

    prioritize = {}
    if label_spec_json_path is not None:
        with open(label_spec_json_path, 'r') as f:
            label_spec_js = json.load(f)
        for label, label_spec in label_spec_js.items():
            if 'prioritize' in label_spec:
                datasets = []
                for level in label_spec['prioritize']:
                    datasets += level
                prioritize[label] = datasets

    df = df.copy()
    df['dataset_location'] = list(zip(df['dataset'], df['location']))
    loc_to_label_sizes = df.groupby(['dataset_location',
                                     'label']).size()

    seen_locs = set()
    split_to_locs = dict(train=[], val=[], test=[])
    label_sizes_by_split = {label: dict(train=0, val=0, test=0)
                            for label in df['label'].unique()}
    if test_split is not None:
        assert test_frac == 0
        split_to_locs['test'] = list(test_split)
        seen_locs.update(test_split)

    def add_loc_to_split(loc, split):
        split_to_locs[split].append(loc)
        for label, label_size in loc_to_label_sizes[loc].items():
            label_sizes_by_split[label][split] += label_size

    ordered_labels = df.groupby('label').size().sort_values()
    for label, label_size in ordered_labels.items():
        split_sizes = label_sizes_by_split[label]
        test_thresh = test_frac * label_size
        val_thresh = val_frac * label_size

        mask = df['label'] == label
        ordered_locs = sort_locs_by_size(
            loc_to_size=df[mask].groupby(
                'dataset_location').size().to_dict(),
            prioritize=prioritize.get(label, None))
        ordered_locs = [loc for loc in ordered_locs
                        if loc not in seen_locs]

        for loc in ordered_locs:
            seen_locs.add(loc)
            if split_sizes['test'] < test_thresh:
                split = 'test'
            elif split_sizes['val'] < val_thresh:
                split = 'val'
            else:
                split = 'train'
            add_loc_to_split(loc, split)

    return {s: sorted(locs) for s, locs in split_to_locs.items()}


def create_classification_dataset(queried_images_json,
                                  cropped_images_dir,
                                  output_dir,
                                  detections_json=None,
                                  detector_version=None,
                                  confidence_threshold=0.0,
                                  split_fractions=(0.7, 0.15, 0.15),
                                  seed=0,
                                  require_crop_files=True):
    """
    Write classification_ds.csv, label_index.json, and splits.json to
    [output_dir]. Returns (rows, label_index, splits).
    """

    with open(queried_images_json) as f:
        queried_images = json.load(f)
    detections = None
    if detections_json is not None:
        with open(detections_json) as f:
            detections = json.load(f)
        if detector_version is None:
            # Derive the crop-name suffix the same way crop_detections
            # does, so default-pipeline crop names line up
            from megadetector_tpu_torch.classification.crop_detections \
                import detector_version_from_results
            detector_version = detector_version_from_results(detections)

    rows = build_crop_rows(queried_images, cropped_images_dir,
                           detections=detections,
                           detector_version=detector_version,
                           confidence_threshold=confidence_threshold,
                           require_crop_files=require_crop_files)

    if len(rows) == 0 and require_crop_files and \
            len(queried_images) > 0:
        print('Warning: no crop rows survived the crop-file existence '
              'check; if crops exist, the detector_version used to '
              'name them (current: {}) may not match'.format(
                  detector_version))

    labels = sorted({lbl for r in rows for lbl in r['label'].split(',')
                     if lbl})
    label_index = {str(i): name for i, name in enumerate(labels)}

    splits = split_locations(rows, split_fractions=split_fractions,
                             seed=seed)

    os.makedirs(output_dir, exist_ok=True)
    csv_path = os.path.join(output_dir, 'classification_ds.csv')
    with open(csv_path, 'w') as f:
        f.write('path,dataset,location,dataset_class,confidence,label\n')
        for r in rows:
            f.write('{path},{dataset},{location},{dataset_class},'
                    '{confidence},{label}\n'.format(**r))
    ct_utils.write_json(os.path.join(output_dir, 'label_index.json'),
                        label_index)
    ct_utils.write_json(os.path.join(output_dir, 'splits.json'), splits)

    print('Wrote {} crop rows, {} labels, splits to {}'.format(
        len(rows), len(labels), output_dir))
    return rows, label_index, splits


def load_dataset_csv(csv_path):
    """Read classification_ds.csv back into a list of row dicts."""

    rows = []
    with open(csv_path) as f:
        header = f.readline().strip().split(',')
        for line in f:
            parts = line.rstrip('\n').split(',', len(header) - 1)
            rows.append(dict(zip(header, parts)))
    return rows


def rows_for_split(rows, splits, split_name):
    """Rows whose (dataset, location) belongs to [split_name]."""

    members = {tuple(lc) for lc in splits[split_name]}
    return [r for r in rows
            if (r['dataset'], str(r['location'])) in members]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Create a classification dataset CSV + splits')
    parser.add_argument('output_dir')
    parser.add_argument('--queried_images_json', required=True)
    parser.add_argument('--cropped_images_dir', required=True)
    parser.add_argument('--detections_json', default=None)
    parser.add_argument('--detector_version', default=None)
    parser.add_argument('--confidence_threshold', type=float, default=0.0)
    parser.add_argument('--val_frac', type=float, default=0.15)
    parser.add_argument('--test_frac', type=float, default=0.15)
    parser.add_argument('--seed', type=int, default=0)

    if len(sys.argv[1:] if argv is None else argv) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args(argv)
    fractions = (1.0 - args.val_frac - args.test_frac, args.val_frac,
                 args.test_frac)
    create_classification_dataset(
        args.queried_images_json, args.cropped_images_dir,
        args.output_dir, detections_json=args.detections_json,
        detector_version=args.detector_version,
        confidence_threshold=args.confidence_threshold,
        split_fractions=fractions, seed=args.seed)


if __name__ == '__main__':
    main()
