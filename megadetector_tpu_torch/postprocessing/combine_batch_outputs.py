"""
Merge multiple MD results files (e.g. per-chunk shards) into
one, erroring on duplicate images unless told otherwise.

Behavioral contract follows the reference
(megadetector/postprocessing/combine_batch_outputs.py:36): detection
categories must agree across inputs, info comes from the newest file,
images are concatenated.

This is also the merge step of BatchJob.plan_chunks's chunked runs
(workflows/manage_local_batch.py): each chunk writes its own results file
and this combines them.

The port's own copy of
megadetector_tpu/postprocessing/combine_batch_outputs.py: the same public
names, signatures, defaults and output bytes.
"""

import argparse
import json
import sys

from megadetector_tpu_torch.utils import ct_utils


def combine_batch_output_files(input_files, output_file=None,
                               require_uniqueness=True, verbose=False):
    """
    Merge a list of MD results files. Returns the merged dict; writes it
    to [output_file] when given.
    """

    input_dicts = []
    for fn in input_files:
        if verbose:
            print('Processing input file {}'.format(fn))
        with open(fn) as f:
            input_dicts.append(json.load(f))

    merged = combine_batch_outputs(input_dicts,
                                   require_uniqueness=require_uniqueness,
                                   verbose=verbose)

    if output_file is not None:
        ct_utils.write_json(output_file, merged, force_str=True)
        if verbose:
            print('Wrote merged results to {}'.format(output_file))
    return merged


def combine_batch_output_dictionaries(input_dicts,
                                      require_uniqueness=True):
    """
    Merge a list of already-loaded MD results dicts into a single dict
    (reference name: combine_batch_outputs.py:79).
    """

    return combine_batch_outputs(input_dicts,
                                 require_uniqueness=require_uniqueness)


def combine_api_shard_files(input_files, output_file=None):
    """
    Merge .json-formatted API shard files — each a JSON *list* of
    per-image dicts from the mostly-deprecated batch API — into a
    single list, optionally writing it to [output_file] (reference:
    combine_batch_outputs.py:186-201). If you don't know what an API
    shard file is, you don't want this function.
    """

    merged = []
    for fn in input_files:
        with open(fn) as f:
            shard = json.load(f)
        assert isinstance(shard, list), \
            '{} is not an API shard file (expected a JSON list)'.format(fn)
        merged.extend(shard)

    if output_file is not None:
        ct_utils.write_json(output_file, merged, force_str=True)
    return merged


def combine_batch_outputs(input_dicts, require_uniqueness=True,
                          verbose=False):
    """Merge already-loaded results dicts (see combine_batch_output_files)."""

    detection_categories = {}
    info = None
    images = []
    filenames = set()

    for d in input_dicts:
        assert 'images' in d and 'info' in d, 'Invalid results dict'

        for k, v in d.get('detection_categories', {}).items():
            if k in detection_categories:
                assert detection_categories[k] == v, \
                    'Conflicting definitions for category {}'.format(k)
            else:
                detection_categories[k] = v

        # Keep the info block from the newest-looking file
        if info is None:
            info = d['info']
        else:
            t_new = d['info'].get('detection_completion_time', '')
            t_old = info.get('detection_completion_time', '')
            if str(t_new) > str(t_old):
                info = d['info']

        for im in d['images']:
            fn = im['file']
            if fn in filenames:
                if require_uniqueness:
                    raise ValueError(
                        'Duplicate image {} across input files'.format(fn))
                continue
            filenames.add(fn)
            images.append(im)

    merged = {
        'images': images,
        'detection_categories': detection_categories,
        'info': info if info is not None else {},
    }

    # Merge classification categories if present
    classification_categories = {}
    for d in input_dicts:
        for k, v in d.get('classification_categories', {}).items():
            if k in classification_categories:
                assert classification_categories[k] == v
            else:
                classification_categories[k] = v
    if classification_categories:
        merged['classification_categories'] = classification_categories

    return merged


def main():
    parser = argparse.ArgumentParser(
        description='Merge multiple MD results files into one')
    parser.add_argument('input_paths', nargs='+')
    parser.add_argument('output_path')
    parser.add_argument('--allow_duplicates', action='store_true')

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    combine_batch_output_files(
        args.input_paths, args.output_path,
        require_uniqueness=(not args.allow_duplicates), verbose=True)


if __name__ == '__main__':
    main()
