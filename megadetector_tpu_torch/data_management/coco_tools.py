"""
COCO dataset manipulation tools (reference modules:
megadetector/data_management/{remap_coco_categories, threshold_coco_dataset,
combine_coco_camera_traps_files, resize_coco_dataset, get_image_sizes}.py).

The port's own copy of megadetector_tpu/data_management/coco_tools.py: the
same public names, signatures, defaults and output bytes.
"""

import json
import os

from copy import deepcopy

from megadetector_tpu_torch.utils import ct_utils


def _load_coco(d):
    if isinstance(d, str):
        with open(d) as f:
            return json.load(f)
    return deepcopy(d)


def remap_coco_categories(input_data, output_category_name_to_id,
                          input_category_name_to_output_category_name,
                          output_file=None,
                          allow_unused_categories=False):
    """
    Remap a COCO dataset's categories onto a new scheme (reference:
    remap_coco_categories.py:23). Annotations whose category isn't in
    the mapping are dropped (allow_unused_categories=True) or error.
    Returns the remapped dict.
    """

    data = _load_coco(input_data)

    input_id_to_name = {c['id']: c['name'] for c in data['categories']}
    old_id_to_new_id = {}
    for old_id, old_name in input_id_to_name.items():
        new_name = input_category_name_to_output_category_name.get(
            old_name)
        if new_name is None:
            if not allow_unused_categories:
                raise ValueError(
                    'Unmapped input category {}'.format(old_name))
            continue
        assert new_name in output_category_name_to_id, \
            'Mapped name {} missing from the output scheme'.format(
                new_name)
        old_id_to_new_id[old_id] = \
            output_category_name_to_id[new_name]

    annotations = []
    for ann in data['annotations']:
        new_id = old_id_to_new_id.get(ann['category_id'])
        if new_id is None:
            if not allow_unused_categories:
                raise ValueError('Annotation {} uses unmapped category '
                                 '{}'.format(ann.get('id'),
                                             ann['category_id']))
            continue
        ann['category_id'] = new_id
        annotations.append(ann)
    data['annotations'] = annotations
    data['categories'] = [
        {'id': cid, 'name': name}
        for name, cid in sorted(output_category_name_to_id.items(),
                                key=lambda kv: kv[1])]

    if output_file is not None:
        ct_utils.write_json(output_file, data, force_str=True)
    return data


def threshold_coco_dataset(input_filename, confidence_threshold=0.0,
                           output_filename=None,
                           confidence_field='score',
                           missing_confidence_handling='error'):
    """
    Drop annotations whose [confidence_field] falls below the threshold
    (reference: threshold_coco_dataset.py:23). Returns the dict.
    """

    assert missing_confidence_handling in ('error', 'warning')
    data = _load_coco(input_filename)

    kept = []
    for ann in data['annotations']:
        if confidence_field not in ann:
            msg = 'annotation {} is missing field {}'.format(
                ann.get('id', 'unknown'), confidence_field)
            if missing_confidence_handling == 'error':
                raise ValueError(msg)
            print('Warning: ' + msg)
            continue
        if ann[confidence_field] >= confidence_threshold:
            kept.append(ann)
    print('Keeping {} of {} annotations'.format(
        len(kept), len(data['annotations'])))
    data['annotations'] = kept

    if output_filename is not None:
        ct_utils.write_json(output_filename, data, force_str=True)
    return data


def combine_cct_dictionaries(input_dicts, require_uniqueness=True):
    """
    Merge CCT dicts: image/annotation/category IDs namespaced as needed,
    categories unified by name (reference:
    combine_coco_camera_traps_files.py:80). A dict may carry a
    'filename_prefix' key prepended to its image file names.
    """

    merged = {'images': [], 'annotations': [], 'categories': [],
              'info': {'description': 'combined CCT dataset'}}
    name_to_cat_id = {}
    seen_image_ids = {}
    seen_files = set()

    for i_dict, d in enumerate(input_dicts):
        prefix = d.get('filename_prefix', '')
        old_to_new_cat = {}
        for c in d['categories']:
            name = c['name']
            if name not in name_to_cat_id:
                name_to_cat_id[name] = len(name_to_cat_id)
                merged['categories'].append(
                    {'id': name_to_cat_id[name], 'name': name})
            old_to_new_cat[c['id']] = name_to_cat_id[name]

        old_to_new_image = {}
        for im in d['images']:
            im = dict(im)
            if prefix:
                im['file_name'] = prefix + im['file_name']
            if require_uniqueness:
                assert im['file_name'] not in seen_files, \
                    'Duplicate image {}'.format(im['file_name'])
            seen_files.add(im['file_name'])
            new_id = im['id']
            if new_id in seen_image_ids:
                new_id = '{}_{}'.format(i_dict, im['id'])
            old_to_new_image[im['id']] = new_id
            im['id'] = new_id
            seen_image_ids[new_id] = True
            merged['images'].append(im)

        for ann in d['annotations']:
            ann = dict(ann)
            ann['image_id'] = old_to_new_image[ann['image_id']]
            ann['category_id'] = old_to_new_cat[ann['category_id']]
            ann['id'] = '{}_{}'.format(i_dict, ann['id'])
            merged['annotations'].append(ann)

    return merged


def combine_cct_files(input_files, output_file=None,
                      require_uniqueness=True, filename_prefixes=None):
    """Merge CCT .json files (reference:
    combine_coco_camera_traps_files.py:30)."""

    if filename_prefixes is not None:
        assert len(filename_prefixes) == len(input_files)
    input_dicts = []
    for fn in input_files:
        with open(fn, encoding='utf-8') as f:
            d = json.load(f)
        if filename_prefixes is not None:
            d['filename_prefix'] = filename_prefixes[fn]
        input_dicts.append(d)
    merged = combine_cct_dictionaries(
        input_dicts, require_uniqueness=require_uniqueness)
    if output_file is not None:
        ct_utils.write_json(output_file, merged, force_str=True)
    return merged


def get_image_sizes(filenames, image_prefix=None, output_file=None,
                    n_workers=8):
    """
    Read (width, height) for a list of images (reference:
    get_image_sizes.py:59). Returns {filename: (w, h) or None}.
    """

    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image

    def one(fn):
        path = os.path.join(image_prefix, fn) if image_prefix else fn
        try:
            with Image.open(path) as im:
                return fn, im.size
        except Exception:
            return fn, None

    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        results = dict(pool.map(one, filenames))

    if output_file is not None:
        ct_utils.write_json(output_file,
                            {k: list(v) if v else None
                             for k, v in results.items()},
                            force_str=True)
    return results


def resize_coco_dataset(input_folder, input_filename, output_folder,
                        output_filename=None, target_size=(-1, -1),
                        correct_size_image_handling='copy'):
    """
    Resize every image in a COCO dataset (annotations rescaled to
    match; reference: resize_coco_dataset.py:148). target_size of -1 on
    one axis preserves aspect ratio; correct_size_image_handling is
    'copy' or 'link'.

    Returns the resized COCO dict.
    """

    import shutil
    from PIL import Image

    data = _load_coco(input_filename)
    os.makedirs(output_folder, exist_ok=True)

    image_id_to_anns = {}
    for ann in data['annotations']:
        image_id_to_anns.setdefault(ann['image_id'], []).append(ann)

    for im in data['images']:
        src = os.path.join(input_folder, im['file_name'])
        dst = os.path.join(output_folder, im['file_name'])
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with Image.open(src) as pil:
            w0, h0 = pil.size
            tw, th = target_size
            if tw <= 0 and th <= 0:
                tw, th = w0, h0
            elif tw <= 0:
                tw = max(1, int(round(w0 * th / h0)))
            elif th <= 0:
                th = max(1, int(round(h0 * tw / w0)))
            if (tw, th) == (w0, h0):
                if correct_size_image_handling == 'link':
                    if not os.path.exists(dst):
                        os.link(src, dst)
                else:
                    shutil.copyfile(src, dst)
            else:
                pil.resize((tw, th), Image.BILINEAR).save(dst)

        sx, sy = tw / w0, th / h0
        im['width'], im['height'] = tw, th
        for ann in image_id_to_anns.get(im['id'], []):
            if 'bbox' in ann:
                x, y, w, h = ann['bbox']
                ann['bbox'] = [x * sx, y * sy, w * sx, h * sy]

    if output_filename is not None:
        ct_utils.write_json(output_filename, data, force_str=True)
    return data


def main():
    """CLI with one subcommand per reference script
    (remap_coco_categories / threshold_coco_dataset /
    combine_coco_camera_traps_files / get_image_sizes /
    resize_coco_dataset)."""

    import argparse
    import sys

    parser = argparse.ArgumentParser(description='COCO dataset tools')
    sub = parser.add_subparsers(dest='command', required=True)

    p = sub.add_parser('threshold', help='drop low-confidence annotations')
    p.add_argument('input_file')
    p.add_argument('output_file')
    p.add_argument('--confidence_threshold', type=float, default=0.0)
    p.add_argument('--confidence_field', default='score')
    p.add_argument('--missing_confidence_handling', default='error')

    p = sub.add_parser('combine', help='merge CCT .json files')
    p.add_argument('input_files', nargs='+')
    p.add_argument('--output_file', required=True)
    p.add_argument('--no_require_uniqueness', action='store_true')

    p = sub.add_parser('sizes', help='read image sizes for a folder')
    p.add_argument('image_folder')
    p.add_argument('output_file')
    p.add_argument('--n_workers', type=int, default=8)

    p = sub.add_parser('resize', help='resize a COCO dataset')
    p.add_argument('input_folder')
    p.add_argument('input_filename')
    p.add_argument('output_folder')
    p.add_argument('output_filename')
    p.add_argument('--width', type=int, default=-1)
    p.add_argument('--height', type=int, default=-1)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()

    if args.command == 'threshold':
        threshold_coco_dataset(
            args.input_file, args.confidence_threshold,
            args.output_file, confidence_field=args.confidence_field,
            missing_confidence_handling=args.missing_confidence_handling)
    elif args.command == 'combine':
        combine_cct_files(args.input_files, args.output_file,
                          require_uniqueness=not
                          args.no_require_uniqueness)
    elif args.command == 'sizes':
        from megadetector_tpu_torch.utils.path_utils import find_images
        files = find_images(args.image_folder, recursive=True,
                            return_relative_paths=True)
        get_image_sizes(files, image_prefix=args.image_folder,
                        output_file=args.output_file,
                        n_workers=args.n_workers)
    elif args.command == 'resize':
        resize_coco_dataset(args.input_folder, args.input_filename,
                            args.output_folder, args.output_filename,
                            target_size=(args.width, args.height))


if __name__ == '__main__':
    main()
