"""
LILA dataset reporting and set-building tools (reference scripts:
megadetector/data_management/lila/{get_lila_annotation_counts,
get_lila_image_counts, create_lila_test_set, create_lila_blank_set,
create_links_to_md_results_files}.py, re-packaged as functions over
lila_common rather than hand-edited scripts).

The port's own copy of megadetector_tpu/data_management/lila/lila_reports.py:
the same public names, signatures, defaults and output bytes.
"""

import os

from collections import defaultdict

from megadetector_tpu_torch.data_management.lila.lila_common import (
    get_lila_dataset_index, lila_image_url,
    read_metadata_file_for_dataset)
from megadetector_tpu_torch.utils import ct_utils


def _load_cct(dataset_entry, metadata_dir):
    """read_metadata_file_for_dataset returns a local path; load it."""

    import json as _json

    path = read_metadata_file_for_dataset(dataset_entry, metadata_dir)
    with open(path) as f:
        return _json.load(f)


def get_lila_annotation_counts(dataset_index=None, metadata_dir=None,
                               output_file=None, datasets=None):
    """
    {dataset name: {category name: annotation count}} across LILA
    datasets (reference: get_lila_annotation_counts.py). [datasets]
    restricts to a name list; the index and per-dataset metadata load
    through lila_common (so a local index works offline).
    """

    if dataset_index is None:
        dataset_index = get_lila_dataset_index(
            metadata_dir=metadata_dir)

    dataset_to_counts = {}
    for name, entry in dataset_index.items():
        if datasets is not None and name not in datasets:
            continue
        try:
            cct = _load_cct(entry, metadata_dir)
        except Exception as e:
            print('Skipping {}: {}'.format(name, e))
            continue
        cat_id_to_name = {c['id']: c['name']
                          for c in cct['categories']}
        counts = defaultdict(int)
        for ann in cct['annotations']:
            counts[cat_id_to_name[ann['category_id']]] += 1
        dataset_to_counts[name] = dict(counts)

    if output_file is not None:
        ct_utils.write_json(output_file, dataset_to_counts,
                            force_str=True)
    return dataset_to_counts


def get_lila_image_counts(dataset_index=None, metadata_dir=None,
                          output_file=None, datasets=None):
    """
    {dataset name: {category name: image count}} — images, not
    annotations (reference: get_lila_image_counts.py).
    """

    if dataset_index is None:
        dataset_index = get_lila_dataset_index(
            metadata_dir=metadata_dir)

    dataset_to_counts = {}
    for name, entry in dataset_index.items():
        if datasets is not None and name not in datasets:
            continue
        try:
            cct = _load_cct(entry, metadata_dir)
        except Exception as e:
            print('Skipping {}: {}'.format(name, e))
            continue
        cat_id_to_name = {c['id']: c['name']
                          for c in cct['categories']}
        category_to_images = defaultdict(set)
        for ann in cct['annotations']:
            category_to_images[cat_id_to_name[ann['category_id']]] \
                .add(ann['image_id'])
        dataset_to_counts[name] = {
            k: len(v) for k, v in category_to_images.items()}

    if output_file is not None:
        ct_utils.write_json(output_file, dataset_to_counts,
                            force_str=True)
    return dataset_to_counts


def create_lila_test_set(dataset_entry, metadata_dir=None,
                         n_empty_per_dataset=8,
                         n_non_empty_per_dataset=8, seed=0):
    """
    Sample a small balanced test set (empty + non-empty images) from
    one LILA dataset (reference: create_lila_test_set.py). Returns a
    list of {'file_name', 'url', 'is_empty'}.
    """

    import random

    cct = _load_cct(dataset_entry, metadata_dir)
    empty_names = ('empty', 'blank')
    cat_id_to_name = {c['id']: c['name'] for c in cct['categories']}
    image_id_to_nonempty = defaultdict(bool)
    annotated = set()
    for ann in cct['annotations']:
        annotated.add(ann['image_id'])
        if cat_id_to_name[ann['category_id']] not in empty_names:
            image_id_to_nonempty[ann['image_id']] = True

    empty = []
    non_empty = []
    for im in cct['images']:
        if image_id_to_nonempty.get(im['id'], False):
            non_empty.append(im)
        elif im['id'] in annotated:
            empty.append(im)

    rng = random.Random(seed)
    picks = []
    for pool, n, is_empty in ((empty, n_empty_per_dataset, True),
                              (non_empty, n_non_empty_per_dataset,
                               False)):
        for im in rng.sample(pool, min(n, len(pool))):
            picks.append({
                'file_name': im['file_name'],
                'url': lila_image_url(dataset_entry, im['file_name']),
                'is_empty': is_empty,
            })
    return picks


def create_lila_blank_set(dataset_index, metadata_dir=None,
                          n_blanks_per_dataset=100, output_file=None,
                          seed=0):
    """
    Collect confirmed-blank image URLs across LILA datasets for
    blank-classifier training (reference: create_lila_blank_set.py).
    Returns a list of {'dataset', 'file_name', 'url'}.
    """

    import random

    rng = random.Random(seed)
    blanks = []
    for name, entry in dataset_index.items():
        try:
            cct = _load_cct(entry, metadata_dir)
        except Exception as e:
            print('Skipping {}: {}'.format(name, e))
            continue
        empty_ids = {c['id'] for c in cct['categories']
                     if c['name'] in ('empty', 'blank')}
        blank_image_ids = {ann['image_id']
                           for ann in cct['annotations']
                           if ann['category_id'] in empty_ids}
        # An image is a confirmed blank only if NO annotation marks it
        # non-empty
        nonblank_image_ids = {ann['image_id']
                              for ann in cct['annotations']
                              if ann['category_id'] not in empty_ids}
        blank_image_ids -= nonblank_image_ids
        images = [im for im in cct['images']
                  if im['id'] in blank_image_ids]
        for im in rng.sample(images,
                             min(n_blanks_per_dataset, len(images))):
            blanks.append({
                'dataset': name,
                'file_name': im['file_name'],
                'url': lila_image_url(entry, im['file_name']),
            })

    if output_file is not None:
        ct_utils.write_json(output_file, blanks, force_str=True)
    return blanks


def create_links_to_md_results_files(dataset_index, output_file=None):
    """
    {dataset name: MD results URL} for every LILA dataset that
    publishes MegaDetector results (reference:
    create_links_to_md_results_files.py).
    """

    links = {}
    for name, entry in dataset_index.items():
        url = entry.get('md_results_url') or entry.get('mdv5_results') \
            or entry.get('md_results')
        if url:
            links[name] = url
    if output_file is not None:
        ct_utils.write_json(output_file, links, force_str=True)
    return links


def validate_lila_metadata_urls(dataset_index, check_images=False,
                                n_images_per_dataset=1, timeout=20):
    """
    Probe every dataset's metadata (and optionally an image URL) for
    reachability (reference: test_lila_metadata_urls.py). Returns
    {dataset name: {'metadata_ok': bool, 'image_ok': bool-or-None}}.
    """

    import urllib.request

    def head_ok(url):
        try:
            req = urllib.request.Request(url, method='HEAD')
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status < 400
        except Exception:
            return False

    results = {}
    for name, entry in dataset_index.items():
        metadata_url = entry.get('metadata_url') or entry.get('json_url')
        status = {'metadata_ok':
                  head_ok(metadata_url) if metadata_url else False,
                  'image_ok': None}
        if check_images and entry.get('image_base_url'):
            status['image_ok'] = head_ok(entry['image_base_url'])
        results[name] = status
    return results
