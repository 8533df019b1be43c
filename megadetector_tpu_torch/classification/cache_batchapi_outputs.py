"""
Cache detector outputs into the per-dataset detection cache consumed by
the classification toolchain (detect_and_crop.load_detection_cache,
create_classification_dataset).

Reference contract (megadetector/classification/
cache_batchapi_outputs.py:75-160): a detections JSON lands in
<cache_base>/v<detector_version>/<dataset>.json, merged with any
existing cache entry for that dataset. The reference also accepts an
Azure Batch Detection API *response* (downloading the detections from
the task's output URL) — that service is retired and this environment
has no egress, so only already-local detections files (or pre-fetched
response payloads via [fetch_fn]) are supported.

The port's own copy of
megadetector_tpu/classification/cache_batchapi_outputs.py: the same public
names, signatures, defaults and output bytes.
"""

import argparse
import json
import os
import sys

from megadetector_tpu_torch.postprocessing.combine_batch_outputs import \
    combine_batch_output_dictionaries
from megadetector_tpu_torch.utils import ct_utils


def cache_detections(detections, dataset, detector_output_cache_dir):
    """
    Merge [detections] (an MD results dict) into the cache file for
    [dataset] under [detector_output_cache_dir] (reference:
    cache_batchapi_outputs.py:130-160). Returns a status message.
    """

    os.makedirs(detector_output_cache_dir, exist_ok=True)
    dataset_cache_path = os.path.join(detector_output_cache_dir,
                                      '{}.json'.format(dataset))
    if os.path.exists(dataset_cache_path):
        with open(dataset_cache_path, 'r') as f:
            dataset_cache = json.load(f)
        merged = combine_batch_output_dictionaries(
            [dataset_cache, detections], require_uniqueness=False)
        msg = 'Merging detection output with {}'.format(
            dataset_cache_path)
    else:
        merged = detections
        msg = ('No cached detection outputs found. Saving detection '
               'output to {}'.format(dataset_cache_path))

    ct_utils.write_json(dataset_cache_path, merged)
    return msg


def cache_json(json_path, is_detections, dataset,
               detector_output_cache_base_dir, detector_version=None,
               fetch_fn=None):
    """
    Cache one JSON file (reference:
    cache_batchapi_outputs.py:75-127). With is_detections, [json_path]
    is an MD results file; otherwise it is a Batch API response whose
    detections URL is resolved through [fetch_fn] (url -> dict) —
    required, since the hosted service is unreachable here. The
    detector version is parsed from info.detector and must match
    [detector_version] when both are present.
    """

    with open(json_path, 'r') as f:
        js = json.load(f)

    if is_detections:
        detections = js
    else:
        response = js
        status = response['Status']['request_status']
        assert status == 'completed', \
            'Task not completed: {}'.format(status)
        task_id = response['TaskId']
        detections_url = \
            response['Status']['message']['output_file_urls']['detections']
        assert detections_url.split('/')[-2] == task_id
        if fetch_fn is None:
            raise RuntimeError(
                'Batch API responses require fetch_fn in this '
                'zero-egress environment')
        detections = fetch_fn(detections_url)

    api_det_version = \
        detections['info']['detector'].rsplit('v', maxsplit=1)[1]
    if detector_version is not None:
        assert api_det_version == detector_version, \
            'Version mismatch: {} vs {}'.format(api_det_version,
                                                detector_version)
    detector_output_cache_dir = os.path.join(
        detector_output_cache_base_dir, 'v{}'.format(api_det_version))
    msg = cache_detections(
        detections=detections, dataset=dataset,
        detector_output_cache_dir=detector_output_cache_dir)
    print(msg)
    return msg


def main():
    parser = argparse.ArgumentParser(
        description='Cache detector outputs into the per-dataset '
                    'classification detection cache')
    parser.add_argument('json_file')
    parser.add_argument('-f', '--format',
                        choices=['response', 'detections'],
                        required=True)
    parser.add_argument('-d', '--dataset', required=True)
    parser.add_argument('-c', '--detector-output-cache-dir',
                        required=True)
    parser.add_argument('-v', '--detector-version', default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    cache_json(args.json_file,
               is_detections=(args.format == 'detections'),
               dataset=args.dataset,
               detector_output_cache_base_dir=args.detector_output_cache_dir,
               detector_version=args.detector_version)


if __name__ == '__main__':
    main()
