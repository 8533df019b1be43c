"""
Client for the MegaDetector serving daemon (serving/server.py); the port
of megadetector_tpu/serving/client.py.

Stdlib-only (urllib) for the requests, so they run on machines without
the framework's compute dependencies installed (detect_folder finds files
with the port's path_utils and writes them with its run_detector_batch
.write_results_to_file). The CLI mirrors the batch pipeline's output
contract: given a folder or image list it posts images to the
server in chunks and writes a standard MD-format results file, so
everything downstream of run_detector_batch (postprocessing, previews,
RDE) works unchanged on remotely-computed results.
"""

import argparse
import base64
import json
import os
import sys

from urllib.request import Request, urlopen
from urllib.error import HTTPError


def _post_json(server_url, path, payload, timeout_s=600.0):
    body = json.dumps(payload).encode('utf-8')
    request = Request(server_url.rstrip('/') + path, data=body,
                      headers={'Content-Type': 'application/json'})
    try:
        with urlopen(request, timeout=timeout_s) as response:
            return json.loads(response.read().decode('utf-8'))
    except HTTPError as e:
        detail = e.read().decode('utf-8', errors='replace')
        raise RuntimeError('server returned {}: {}'.format(
            e.code, detail)) from e


def _get_json(server_url, path, timeout_s=60.0):
    with urlopen(server_url.rstrip('/') + path,
                 timeout=timeout_s) as response:
        return json.loads(response.read().decode('utf-8'))


def server_health(server_url):
    """GET /healthz as a dict."""

    return _get_json(server_url, '/healthz')


def server_metrics(server_url):
    """GET /metrics as a dict."""

    return _get_json(server_url, '/metrics')


def detect_image_bytes(server_url, raw_bytes, image_id='image',
                       detection_threshold=None, timeout_s=600.0):
    """
    Run detection on one in-memory image; returns the MD image record.
    """

    envelope = detect_images(
        server_url, [(image_id, raw_bytes)],
        detection_threshold=detection_threshold, timeout_s=timeout_s)
    return envelope['images'][0]


def detect_file(server_url, image_path, image_id=None,
                detection_threshold=None, timeout_s=600.0):
    """
    Run detection on one image file; returns the MD image record.
    """

    with open(image_path, 'rb') as f:
        raw = f.read()
    return detect_image_bytes(
        server_url, raw, image_id=image_id or image_path,
        detection_threshold=detection_threshold, timeout_s=timeout_s)


def detect_images(server_url, id_bytes_pairs, detection_threshold=None,
                  timeout_s=600.0):
    """
    Run detection on a list of (image_id, raw_bytes); returns the
    response envelope ({'images': [...], 'detection_categories': ...}).
    """

    payload = {'images': [
        {'id': image_id,
         'data': base64.b64encode(raw).decode('ascii')}
        for image_id, raw in id_bytes_pairs]}
    if detection_threshold is not None:
        payload['detection_threshold'] = detection_threshold
    return _post_json(server_url, '/v1/detect_batch', payload,
                      timeout_s=timeout_s)


def detect_folder(server_url, image_folder=None, image_files=None,
                  output_file=None, detection_threshold=None,
                  chunk_size=8, relative_paths=True, quiet=False):
    """
    Run a folder (or explicit file list) through the server and return
    MD-format results; writes a standard results file when
    [output_file] is given (same envelope run_detector_batch writes).
    """

    assert (image_folder is None) != (image_files is None), \
        'specify exactly one of image_folder / image_files'
    if image_files is None:
        from megadetector_tpu_torch.utils.path_utils import find_images
        image_files = find_images(image_folder, recursive=True,
                                  return_relative_paths=False)
    image_files = sorted(image_files)

    model_info = _get_json(server_url, '/v1/model')
    records = []
    categories = model_info.get('detection_categories', {})

    for start in range(0, len(image_files), max(chunk_size, 1)):
        chunk = image_files[start:start + max(chunk_size, 1)]
        pairs = []
        for path in chunk:
            image_id = os.path.relpath(path, image_folder) \
                if (relative_paths and image_folder is not None) else path
            try:
                with open(path, 'rb') as f:
                    pairs.append((image_id, f.read()))
            except OSError:
                records.append({'file': image_id, 'detections': None,
                                'failure': 'image access failure'})
        if not pairs:
            continue
        envelope = detect_images(
            server_url, pairs, detection_threshold=detection_threshold)
        records.extend(envelope['images'])
        categories = envelope.get('detection_categories', categories)
        if not quiet:
            print('processed {}/{} images'.format(
                min(start + len(chunk), len(image_files)),
                len(image_files)))

    if output_file is not None:
        # The standard writer enforces the full output contract
        # (sorting, info block, failure semantics)
        from megadetector_tpu_torch.detection.run_detector_batch import \
            write_results_to_file
        results = write_results_to_file(
            records, output_file,
            detector_file=str(model_info.get('model_version', 'unknown')),
            detection_categories=categories)
    else:
        results = {
            'images': sorted(records, key=lambda r: r['file']),
            'detection_categories': categories,
        }
    return results


# %% CLI

def main():

    parser = argparse.ArgumentParser(
        description='Client for the MegaDetector serving daemon')
    parser.add_argument('server_url', help='e.g. http://127.0.0.1:8000')
    parser.add_argument('input', help='image file or folder')
    parser.add_argument('--output_file', default=None,
                        help='write MD-format results here')
    parser.add_argument('--detection_threshold', type=float, default=None)
    parser.add_argument('--chunk_size', type=int, default=8)
    args = parser.parse_args()

    if os.path.isdir(args.input):
        results = detect_folder(
            args.server_url, image_folder=args.input,
            output_file=args.output_file,
            detection_threshold=args.detection_threshold,
            chunk_size=args.chunk_size)
        n_failed = sum(1 for r in results['images']
                       if r.get('detections') is None)
        print('{} images, {} failures'.format(
            len(results['images']), n_failed))
    else:
        record = detect_file(
            args.server_url, args.input,
            detection_threshold=args.detection_threshold)
        json.dump(record, sys.stdout, indent=1)
        print()


if __name__ == '__main__':
    main()
