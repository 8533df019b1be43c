"""
Diagnose images that failed to load during cropping/inference.

Reference role (megadetector/classification/analyze_failed_images.py):
take a list of failing image paths and explain each failure. The
reference checks Azure blobs; this version checks the local
filesystem: missing file, zero bytes, truncated image data, or a
format PIL cannot decode — and flags files that now load fine
(transient failures). Writes a JSON report.

The port's own copy of
megadetector_tpu/classification/analyze_failed_images.py: the same public
names, signatures, defaults and output bytes.
"""

import argparse
import json
import os
import sys

from concurrent.futures import ThreadPoolExecutor


def diagnose_one(path):
    """Returns (path, status) with status one of 'ok', 'missing',
    'empty', 'truncated', 'undecodable: <err>'."""

    from PIL import Image, ImageFile

    if not os.path.isfile(path):
        return path, 'missing'
    if os.path.getsize(path) == 0:
        return path, 'empty'

    # Strict load first (LOAD_TRUNCATED_IMAGES off): catches files PIL
    # would silently half-decode
    old = ImageFile.LOAD_TRUNCATED_IMAGES
    ImageFile.LOAD_TRUNCATED_IMAGES = False
    try:
        with Image.open(path) as im:
            im.load()
        return path, 'ok'
    except OSError as e:
        if 'truncated' in str(e).lower():
            return path, 'truncated'
        return path, 'undecodable: {}'.format(e)
    except Exception as e:
        return path, 'undecodable: {}'.format(e)
    finally:
        ImageFile.LOAD_TRUNCATED_IMAGES = old


def check_image_condition(img_path, truncated_images_lock=None,
                          account=None, container=None, sas_token=None,
                          datasets_table=None):
    """
    Diagnose one image file; returns (img_path, status) with status one
    of 'nonexistent', 'non_image', 'good', 'truncated', or 'bad'
    (reference: analyze_failed_images.py:38-112 — there Azure blobs;
    here local paths, so the Azure arguments must be None).
    """

    assert account is None and container is None and \
        sas_token is None and datasets_table is None, \
        'Azure Blob Storage access is not supported; use local paths'

    from megadetector_tpu_torch.utils.path_utils import is_image_file
    if not is_image_file(img_path):
        return img_path, 'non_image'
    if not os.path.isfile(img_path):
        return img_path, 'nonexistent'

    _, status = diagnose_one(img_path)
    if status == 'ok':
        return img_path, 'good'
    if status == 'truncated':
        # Re-check: can PIL open it at all with truncation allowed?
        from PIL import Image, ImageFile
        old = ImageFile.LOAD_TRUNCATED_IMAGES
        ImageFile.LOAD_TRUNCATED_IMAGES = True
        try:
            with Image.open(img_path) as im:
                im.load()
            return img_path, 'truncated'
        except Exception:
            return img_path, 'bad'
        finally:
            ImageFile.LOAD_TRUNCATED_IMAGES = old
    if status == 'missing':
        return img_path, 'nonexistent'
    return img_path, 'bad'


def analyze_images(url_or_path, json_keys=None, account=None,
                   container=None, sas_token=None, images_dir=None,
                   output_json=None, threads=1):
    """
    Diagnose every image named in [url_or_path] — a text file of paths
    (one per line) or a .json file (a list, or a dict whose
    [json_keys] values are lists) (reference:
    analyze_failed_images.py:115-175, minus the Azure access). Returns
    the analyze_failed_images report.
    """

    assert account is None and container is None and \
        sas_token is None, \
        'Azure Blob Storage access is not supported; use local paths'

    if url_or_path.endswith('.json'):
        with open(url_or_path) as f:
            js = json.load(f)
        if json_keys is None:
            assert isinstance(js, list)
            image_paths = js
        else:
            image_paths = []
            for key in json_keys:
                image_paths.extend(js[key])
    else:
        with open(url_or_path) as f:
            image_paths = [line.strip() for line in f
                           if line.strip()]

    return analyze_failed_images(image_paths, images_dir=images_dir,
                                 output_json=output_json,
                                 threads=threads)


def analyze_failed_images(image_paths, images_dir=None, output_json=None,
                          threads=1):
    """
    Diagnose every path (relative to [images_dir] when given). Returns
    {'by_status': {status: [paths]}, 'n_total': N}.
    """

    full = [os.path.join(images_dir, p) if images_dir else p
            for p in image_paths]
    if threads > 1:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            results = list(pool.map(diagnose_one, full))
    else:
        results = [diagnose_one(p) for p in full]

    by_status = {}
    for (p, status), rel in zip(results, image_paths):
        key = status.split(':')[0]
        by_status.setdefault(key, []).append(
            {'file': rel, 'detail': status})

    report = {'n_total': len(image_paths), 'by_status': by_status}
    if output_json is not None:
        with open(output_json, 'w') as f:
            json.dump(report, f, indent=1)
        print('Wrote failure analysis to {}'.format(output_json))
    for status, items in sorted(by_status.items()):
        print('{}: {}'.format(status, len(items)))
    return report


def main():
    parser = argparse.ArgumentParser(
        description='Diagnose images that failed to load')
    parser.add_argument('failed_list',
                        help='text file of image paths (one per line) '
                             'or a crop_detections log / MD results '
                             'JSON with failures')
    parser.add_argument('--images_dir', default=None)
    parser.add_argument('--output_json', default=None)
    parser.add_argument('--threads', type=int, default=1)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    if args.failed_list.endswith('.json'):
        with open(args.failed_list) as f:
            data = json.load(f)
        if 'failed_images' in data:
            paths = data['failed_images']
        elif 'images' in data:
            paths = [im['file'] for im in data['images']
                     if im.get('failure')]
        else:
            raise ValueError('Unrecognized JSON input')
    else:
        with open(args.failed_list) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
    analyze_failed_images(paths, images_dir=args.images_dir,
                          output_json=args.output_json,
                          threads=args.threads)


if __name__ == '__main__':
    main()
