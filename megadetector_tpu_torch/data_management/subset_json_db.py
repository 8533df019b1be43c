"""
Subset a COCO Camera Traps database by filename query or explicit list.

Behavioral contract follows the reference
(megadetector/data_management/subset_json_db.py): images matching the
query (or list) are kept along with their annotations; categories are
kept as-is.

The port's own copy of megadetector_tpu/data_management/subset_json_db.py:
the same public names, signatures, defaults and output bytes.
"""

import argparse
import json
import sys

from megadetector_tpu_torch.utils import ct_utils


class DbSamplingOptions:
    """Parameters for sample_json_db
    (reference: subset_json_db.py:31-47)."""

    def __init__(self):
        #: Max image count per category name; 'default' applies to
        #: unlisted categories, 'no_annotations' to images without
        #: annotations, -1 means no maximum. Multi-category images can
        #: exceed a cap when another category keeps them.
        self.category_name_to_max_count = {'default': -1}
        self.random_seed = 0


def sample_json_db(input_json, sampling_options, output_json=None,
                   verbose=False):
    """
    Subsample a COCO Camera Traps database with per-category caps
    (reference: subset_json_db.py:50-158). Returns the (modified in
    place when a dict is passed) CCT dict.
    """

    import random
    from collections import defaultdict

    if isinstance(input_json, str):
        with open(input_json) as f:
            input_data = json.load(f)
    else:
        assert isinstance(input_json, dict), \
            'input_json is neither a filename nor a dict'
        input_data = input_json

    category_id_to_name = {c['id']: c['name']
                           for c in input_data['categories']}
    category_name_to_image_ids = defaultdict(set)
    annotated_image_ids = set()
    for ann in input_data['annotations']:
        name = category_id_to_name[ann['category_id']]
        category_name_to_image_ids[name].add(ann['image_id'])
        annotated_image_ids.add(ann['image_id'])
    for im in input_data['images']:
        if im['id'] not in annotated_image_ids:
            category_name_to_image_ids['no_annotations'].add(im['id'])

    rng = random.Random(sampling_options.random_seed)
    caps = sampling_options.category_name_to_max_count
    image_ids_to_keep = set()
    for category_name, image_ids in category_name_to_image_ids.items():
        max_count = caps.get(category_name, caps.get('default', -1))
        if max_count < 0 or len(image_ids) <= max_count:
            image_ids_to_keep.update(image_ids)
        else:
            if verbose:
                print('Keeping {} of {} images for category {}'.format(
                    max_count, len(image_ids), category_name))
            image_ids_to_keep.update(
                rng.sample(sorted(image_ids, key=str), max_count))

    n_images_in = len(input_data['images'])
    n_annotations_in = len(input_data['annotations'])
    input_data['images'] = [im for im in input_data['images']
                            if im['id'] in image_ids_to_keep]
    input_data['annotations'] = [
        ann for ann in input_data['annotations']
        if ann['image_id'] in image_ids_to_keep]

    if output_json is not None:
        ct_utils.write_json(output_json, input_data)
    if verbose:
        print('Keeping {} of {} images, {} of {} annotations'.format(
            len(input_data['images']), n_images_in,
            len(input_data['annotations']), n_annotations_in))
    return input_data


def subset_json_db(input_json, query, output_json=None, ignore_case=False):
    """
    Subset a CCT database.

    Args:
        input_json: CCT .json filename or loaded dict
        query: substring to match in file_name, a list of substrings (any
            match keeps the image), or a list file of exact relative paths
        output_json: optional output path
        ignore_case: case-insensitive matching

    Returns:
        the subset dict
    """

    if isinstance(input_json, str):
        with open(input_json) as f:
            data = json.load(f)
    else:
        data = input_json

    if isinstance(query, str) and query.endswith('.json'):
        with open(query) as f:
            filenames = set(json.load(f))
        def matches(fn): # noqa
            return fn in filenames
    else:
        queries = [query] if isinstance(query, str) else list(query)
        if ignore_case:
            queries = [q.lower() for q in queries]

        def matches(fn):
            s = fn.lower() if ignore_case else fn
            return any(q in s for q in queries)

    images = [im for im in data['images'] if matches(im['file_name'])]
    image_ids = set(im['id'] for im in images)
    annotations = [ann for ann in data.get('annotations', [])
                   if ann['image_id'] in image_ids]

    subset = {k: v for k, v in data.items()
              if k not in ('images', 'annotations')}
    subset['images'] = images
    subset['annotations'] = annotations

    if output_json is not None:
        ct_utils.write_json(output_json, subset, force_str=True)
    return subset


def main():
    parser = argparse.ArgumentParser(
        description='Subset a COCO Camera Traps database')
    parser.add_argument('input_json')
    parser.add_argument('output_json')
    parser.add_argument('query')
    parser.add_argument('--ignore_case', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    subset_json_db(args.input_json, args.query, args.output_json,
                   ignore_case=args.ignore_case)


if __name__ == '__main__':
    main()
