"""
Validate a classification label-spec JSON and build queried_images.json
from a local image-label source.

Reference behavior (megadetector/classification/json_validator.py:1-696),
with the MegaDB/Azure query replaced by a local "image source" JSON —
a mapping from '<dataset>/<file>' to
{'dataset', 'class', 'location'} — since this environment has no
database backend. Everything else follows the reference contract:

Label spec format (per classification label):
    {
      "cervid": {
        "taxa": [{"level": "family", "name": "cervidae",
                  "datasets": ["ds1"]}],          // optional
        "dataset_labels": {"ds1": ["deer", "elk"]},  // optional
        "max_count": 5000,                           // optional
        "prioritize": [["ds1"]]                      // optional
      }, ...
    }

Validation conditions (reference json_validator.py:10-25):
1) every classification label matches at least one dataset label;
2) taxa named in a spec must exist in the provided taxonomy
   (taxonomy_mapping/taxonomy_graph.py builds it from CSV);
3) 'prioritize' requires 'max_count';
4) with allow_multilabel=False, no (dataset, dataset_label) pair may
   fall under two classification labels.

Outputs (with output_dir): included_dataset_labels.txt,
image_counts_by_label_presample.json, queried_images.json,
image_counts_by_label_sampled.json, json_validator_log_<ts>.json.

The port's own copy of megadetector_tpu/classification/json_validator.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import collections
import json
import os
import random
import sys

from datetime import datetime

from megadetector_tpu_torch.utils import ct_utils

IMAGE_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.gif')


def parse_spec(label, spec_dict, taxonomy=None):
    """
    Resolve one label spec to a set of (dataset, dataset_label) pairs.
    Raises ValueError on an unknown taxon or an empty match.
    """

    results = set()

    for taxon in spec_dict.get('taxa', []):
        name = taxon['name']
        # find() returns a (possibly empty) list of matching nodes;
        # names can be ambiguous across ranks, so expand all matches
        nodes = taxonomy.find(name) if taxonomy is not None else []
        if not nodes:
            raise ValueError(
                'label {}: taxon {} not in the taxonomy'.format(
                    label, name))
        datasets = taxon.get('datasets', [])
        # Taxon-derived dataset labels: the taxon name and every
        # descendant's name, in each listed dataset
        names = set()
        for node in nodes:
            names.add(node.name)
            names.update(d.name for d in taxonomy.descendants(node))
        for ds in datasets:
            for n in names:
                results.add((ds, n))

    for ds, ds_labels in spec_dict.get('dataset_labels', {}).items():
        for ds_label in ds_labels:
            results.add((ds, ds_label))

    if 'prioritize' in spec_dict and 'max_count' not in spec_dict:
        raise ValueError(
            'label {}: prioritize is invalid without max_count'.format(
                label))
    if len(results) == 0:
        raise ValueError(
            'label {} matches no dataset labels'.format(label))
    return results


def validate_json(input_js, taxonomy=None, allow_multilabel=False):
    """
    Validate the whole spec; returns {label: set of (dataset,
    dataset_label)}. Raises ValueError on violations.
    """

    label_to_inclusions = {}
    for label, spec_dict in input_js.items():
        label_to_inclusions[label] = parse_spec(label, spec_dict,
                                                taxonomy)

    if not allow_multilabel:
        seen = {}
        for label, pairs in label_to_inclusions.items():
            for pair in pairs:
                if pair in seen and seen[pair] != label:
                    raise ValueError(
                        'dataset label {} included by both {} and '
                        '{}'.format(pair, seen[pair], label))
                seen[pair] = label
    return label_to_inclusions


def get_output_json(label_to_inclusions, mislabeled_images_dir=None,
                    image_source=None):
    """
    Build the queried-images JSON for a validated label spec
    (reference: json_validator.py:281-360 — there a MegaDB query; here
    the local [image_source] mapping '<dataset>/<file>' ->
    {'dataset', 'class', 'location', ...}). When
    [mislabeled_images_dir] holds per-dataset CSVs of known mislabeled
    images (megadb_mislabeled/<dataset>.csv with a 'file' column,
    see save_mislabeled.update_mislabeled_images), those images are
    excluded.
    """

    assert image_source is not None, \
        'get_output_json requires a local image_source mapping'
    output_js = build_queried_images(label_to_inclusions, image_source)

    if mislabeled_images_dir is not None and \
            os.path.isdir(mislabeled_images_dir):
        import csv as _csv
        mislabeled = set()
        for fn in os.listdir(mislabeled_images_dir):
            if not fn.endswith('.csv'):
                continue
            ds = os.path.splitext(fn)[0]
            with open(os.path.join(mislabeled_images_dir, fn),
                      newline='') as f:
                for row in _csv.DictReader(f):
                    mislabeled.add('{}/{}'.format(ds, row['file']))
        n_before = len(output_js)
        output_js = {k: v for k, v in output_js.items()
                     if k not in mislabeled}
        if n_before != len(output_js):
            print('Excluded {} known-mislabeled images'.format(
                n_before - len(output_js)))

    return dict(sorted(output_js.items()))


def build_queried_images(label_to_inclusions, image_source):
    """
    The local-source replacement for the reference's MegaDB query:
    [image_source] maps '<dataset>/<file>' to {'dataset', 'class',
    'location'}; every image whose (dataset, class) pair falls under a
    classification label is emitted with that label attached.
    """

    # A pair may fall under several labels when allow_multilabel was
    # used; every matching label attaches to the image
    pair_to_labels = {}
    for label, pairs in label_to_inclusions.items():
        for pair in pairs:
            pair_to_labels.setdefault(pair, []).append(label)

    output_js = {}
    for img_path, info in image_source.items():
        dataset = info.get('dataset',
                           img_path.split('/', 1)[0]
                           if '/' in img_path else '')
        cls = info.get('class', '')
        labels = pair_to_labels.get((dataset, cls))
        if not labels:
            continue
        entry = dict(info)
        entry['dataset'] = dataset
        entry.setdefault('location', 'unknown')
        entry['label'] = sorted(labels)
        output_js[img_path] = entry
    return output_js


def remove_non_images(output_js, log):
    """Drop paths without an image extension (reference :450-467)."""

    bad = [p for p in output_js
           if not p.lower().endswith(IMAGE_EXTENSIONS)]
    for p in bad:
        del output_js[p]
    if bad:
        log['nonimage_files'] = sorted(bad)


def remove_nonexistent_images(output_js, log, images_dir):
    """Drop images missing on disk (the reference checks Azure blob
    existence; locally we check the filesystem)."""

    bad = [p for p in output_js
           if not os.path.isfile(os.path.join(images_dir, p))]
    for p in bad:
        del output_js[p]
    if bad:
        log['nonexistent_images'] = sorted(bad)


def remove_images_insufficient_locs(output_js, log, min_locs):
    """Drop labels with fewer than [min_locs] distinct locations
    (reference :525-557)."""

    # Count locations under EVERY label an image carries (multilabel
    # images contribute to each of their labels)
    label_locs = collections.defaultdict(set)
    for info in output_js.values():
        for lbl in info['label']:
            label_locs[lbl].add(
                (info['dataset'], str(info['location'])))
    bad_labels = {lbl for lbl, locs in label_locs.items()
                  if len(locs) < min_locs}
    if not bad_labels:
        return
    # Strip bad labels from multilabel images; drop images left with
    # no labels
    bad = []
    for p, info in output_js.items():
        kept = [lbl for lbl in info['label'] if lbl not in bad_labels]
        if kept:
            info['label'] = kept
        else:
            bad.append(p)
    for p in bad:
        del output_js[p]
    log['labels_with_insufficient_locations'] = sorted(bad_labels)


def filter_images(output_js, label):
    """Image paths carrying [label]."""

    return {p for p, info in output_js.items()
            if label in info['label']}


def sample_with_priority(input_js, output_js, seed=123):
    """
    Enforce per-label max_count, keeping prioritized datasets first
    (reference :584-650): 'prioritize' is a list of dataset tiers,
    sampled tier by tier, then everything else.
    """

    rng = random.Random(seed)
    keep = {}

    # Capped labels first, so multilabel images selected by uncapped
    # labels don't pre-consume (or silently exceed) a cap; paths a
    # previous capped label already kept count against this label's
    # budget
    def _order(item):
        return (item[1].get('max_count') is None, item[0])

    for label, spec_dict in sorted(input_js.items(), key=_order):
        paths = sorted(filter_images(output_js, label))
        max_count = spec_dict.get('max_count')
        if max_count is None or len(paths) <= max_count:
            for p in paths:
                keep[p] = output_js[p]
            continue
        already = [p for p in paths if p in keep]
        budget = max_count - len(already)
        if budget <= 0:
            continue
        tiers = [set(t) for t in spec_dict.get('prioritize', [])]
        tiers.append(None)  # everything else
        chosen = []
        remaining = [p for p in paths if p not in keep]
        for tier in tiers:
            if len(chosen) >= budget:
                break
            if tier is None:
                pool = remaining
            else:
                pool = [p for p in remaining
                        if output_js[p]['dataset'] in tier]
            remaining = [p for p in remaining if p not in set(pool)]
            if len(chosen) + len(pool) <= budget:
                chosen.extend(pool)
            else:
                chosen.extend(rng.sample(pool, budget - len(chosen)))
        for p in chosen:
            keep[p] = output_js[p]

    # Multilabel overlap can still force a cap to be exceeded (an
    # uncapped label demanded the images); make that visible
    label_counts = collections.Counter(
        lbl for info in keep.values() for lbl in info['label'])
    for label, spec_dict in input_js.items():
        max_count = spec_dict.get('max_count')
        if max_count is not None and label_counts[label] > max_count:
            print('Warning: label {} kept {} images (max_count {}) '
                  'because multilabel images were required by other '
                  'labels'.format(label, label_counts[label], max_count))
    return keep


def run_validator(label_spec_json_path, image_source_json_path=None,
                  taxonomy_csv_path=None, output_dir=None,
                  allow_multilabel=False, min_locs=None,
                  images_dir=None, seed=123):
    """
    Full flow: validate -> query local source -> filter -> sample ->
    write outputs. Returns the queried-images dict (or the
    label_to_inclusions map when no image source is given).
    """

    with open(label_spec_json_path) as f:
        input_js = json.load(f)

    taxonomy = None
    if taxonomy_csv_path is not None:
        from megadetector_tpu_torch.taxonomy_mapping.taxonomy_graph import \
            build_taxonomy_from_csv
        taxonomy = build_taxonomy_from_csv(taxonomy_csv_path)

    label_to_inclusions = validate_json(
        input_js, taxonomy, allow_multilabel=allow_multilabel)

    if image_source_json_path is None:
        return label_to_inclusions

    with open(image_source_json_path) as f:
        image_source = json.load(f)
    output_js = build_queried_images(label_to_inclusions, image_source)

    log = {}
    remove_non_images(output_js, log)
    if images_dir is not None:
        remove_nonexistent_images(output_js, log, images_dir)
    if min_locs is not None:
        remove_images_insufficient_locs(output_js, log, min_locs)

    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir,
                               'included_dataset_labels.txt'), 'w') as f:
            for label in sorted(label_to_inclusions):
                f.write('{}:\n'.format(label))
                for pair in sorted(label_to_inclusions[label]):
                    f.write('  {}/{}\n'.format(*pair))

        presample = {label: len(filter_images(output_js, label))
                     for label in sorted(input_js.keys())}
        ct_utils.write_json(
            os.path.join(output_dir,
                         'image_counts_by_label_presample.json'),
            presample)

        output_js = sample_with_priority(input_js, output_js, seed=seed)

        ct_utils.write_json(
            os.path.join(output_dir, 'queried_images.json'), output_js)
        sampled = {label: len(filter_images(output_js, label))
                   for label in sorted(input_js.keys())}
        ct_utils.write_json(
            os.path.join(output_dir,
                         'image_counts_by_label_sampled.json'),
            sampled)
        log_path = os.path.join(
            output_dir, 'json_validator_log_{}.json'.format(
                datetime.now().strftime('%Y%m%d_%H%M%S')))
        ct_utils.write_json(log_path, log)
    else:
        output_js = sample_with_priority(input_js, output_js, seed=seed)

    return output_js


def main():
    parser = argparse.ArgumentParser(
        description='Validate a classification label spec and build '
                    'queried_images.json from a local image source')
    parser.add_argument('label_spec_json')
    parser.add_argument('--image_source_json', default=None,
                        help='JSON mapping <dataset>/<file> to '
                             '{dataset, class, location}')
    parser.add_argument('--taxonomy_csv', default=None)
    parser.add_argument('--output_dir', default=None)
    parser.add_argument('--allow_multilabel', action='store_true')
    parser.add_argument('--min_locs', type=int, default=None)
    parser.add_argument('--images_dir', default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    run_validator(args.label_spec_json, args.image_source_json,
                  args.taxonomy_csv, args.output_dir,
                  allow_multilabel=args.allow_multilabel,
                  min_locs=args.min_locs, images_dir=args.images_dir)


if __name__ == '__main__':
    main()
