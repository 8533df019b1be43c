"""
Image-file maintenance tools (reference modules:
megadetector/data_management/{remove_exif, rename_images,
generate_crops_from_cct}.py).

The port's own copy of megadetector_tpu/data_management/image_file_tools.py:
the same public names, signatures, defaults and output bytes.
"""

import os
import shutil

from megadetector_tpu_torch.utils import ct_utils
from megadetector_tpu_torch.utils.path_utils import find_images


def remove_exif_from_image(fn, output_fn=None):
    """
    Re-encode one image without its EXIF/metadata blocks (reference:
    remove_exif.py:26). Writes in place unless [output_fn] is given.
    """

    from PIL import Image

    output_fn = output_fn or fn
    with Image.open(fn) as im:
        pixels = list(im.getdata())
        clean = Image.new(im.mode, im.size)
        clean.putdata(pixels)
        kwargs = {}
        if output_fn.lower().endswith(('.jpg', '.jpeg')):
            kwargs['quality'] = 95
        clean.save(output_fn, **kwargs)
    return output_fn


def remove_exif(image_base_folder, recursive=True, n_workers=1):
    """
    Strip EXIF from every image under a folder (reference:
    remove_exif.py:58). Returns the list of processed files.
    """

    from concurrent.futures import ThreadPoolExecutor

    images = find_images(image_base_folder, recursive=recursive)
    if n_workers <= 1:
        for fn in images:
            remove_exif_from_image(fn)
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            list(pool.map(remove_exif_from_image, images))
    print('Removed EXIF from {} images'.format(len(images)))
    return images


def rename_images(input_folder, output_folder, dry_run=False,
                  verbose=False, n_copy_workers=8):
    """
    Copy a nested image tree into a flat folder with EXIF timestamps in
    the filenames (camtrapR imageRename-style; reference:
    rename_images.py:24): <subfolders>#<datetime>#<original name>.
    Returns {input relative path: output filename}.
    """

    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image

    assert os.path.isdir(input_folder)
    assert os.path.abspath(input_folder) != os.path.abspath(
        output_folder), 'Output folder must differ from input'
    if not dry_run:
        os.makedirs(output_folder, exist_ok=True)

    images = find_images(input_folder, recursive=True,
                         return_relative_paths=True)

    def datetime_token(rel):
        try:
            with Image.open(os.path.join(input_folder, rel)) as im:
                exif = im.getexif() or {}
                # 36867 DateTimeOriginal, 306 DateTime
                dt = None
                try:
                    dt = im.getexif().get_ifd(0x8769).get(36867)
                except Exception:
                    dt = None
                dt = dt or exif.get(306)
        except Exception:
            dt = None
        if not dt:
            return 'unknown'
        return str(dt).replace(':', '-').replace(' ', '_')

    mapping = {}
    used = set()
    for rel in images:
        rel_fwd = rel.replace('\\', '/')
        folder_token = os.path.dirname(rel_fwd).replace('/', '~')
        base = os.path.basename(rel_fwd)
        name = '#'.join(t for t in
                        (folder_token, datetime_token(rel_fwd), base)
                        if t)
        stem, ext = os.path.splitext(name)
        candidate = name
        i = 0
        while candidate in used:
            i += 1
            candidate = '{}_{}{}'.format(stem, i, ext)
        used.add(candidate)
        mapping[rel_fwd] = candidate

    if not dry_run:
        def copy_one(item):
            rel, out_name = item
            shutil.copyfile(os.path.join(input_folder, rel),
                            os.path.join(output_folder, out_name))
        with ThreadPoolExecutor(max_workers=n_copy_workers) as pool:
            list(pool.map(copy_one, mapping.items()))

    if verbose:
        print('Mapped {} images'.format(len(mapping)))
    return mapping


def generate_crops_from_cct(cct_file, image_dir, output_dir, padding=0,
                            flat_output=True):
    """
    Write a crop file for every bbox annotation in a CCT database
    (reference: generate_crops_from_cct.py:22). Crop filenames are
    '<image stem>_crop<k>.jpg'. Returns the list of crop files written.
    """

    import json
    from PIL import Image

    if isinstance(cct_file, str):
        with open(cct_file) as f:
            cct = json.load(f)
    else:
        cct = cct_file
    os.makedirs(output_dir, exist_ok=True)

    image_id_to_image = {im['id']: im for im in cct['images']}
    crops_written = []
    image_id_to_crop_count = {}

    for ann in cct['annotations']:
        if 'bbox' not in ann or ann['bbox'] is None:
            continue
        im_rec = image_id_to_image[ann['image_id']]
        k = image_id_to_crop_count.get(ann['image_id'], 0)
        image_id_to_crop_count[ann['image_id']] = k + 1

        src = os.path.join(image_dir, im_rec['file_name'])
        with Image.open(src) as pil:
            x, y, w, h = ann['bbox']  # CCT: absolute xywh
            x0 = max(0, int(x - padding))
            y0 = max(0, int(y - padding))
            x1 = min(pil.size[0], int(x + w + padding))
            y1 = min(pil.size[1], int(y + h + padding))
            if x1 <= x0 or y1 <= y0:
                continue
            crop = pil.crop((x0, y0, x1, y1))
            stem = os.path.splitext(
                im_rec['file_name'].replace('\\', '/'))[0]
            if flat_output:
                stem = stem.replace('/', '~')
            out_name = '{}_crop{:03d}.jpg'.format(stem, k)
            out_path = os.path.join(output_dir, out_name)
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            crop.convert('RGB').save(out_path, quality=95)
            crops_written.append(out_path)

    print('Wrote {} crops'.format(len(crops_written)))
    return crops_written


def main():
    """CLI with one subcommand per reference script (remove_exif /
    rename_images / generate_crops_from_cct)."""

    import argparse
    import sys

    parser = argparse.ArgumentParser(description='Image file tools')
    sub = parser.add_subparsers(dest='command', required=True)

    p = sub.add_parser('remove-exif', help='strip EXIF in place')
    p.add_argument('image_folder')
    p.add_argument('--n_workers', type=int, default=1)

    p = sub.add_parser('rename', help='flatten/rename images into '
                                      'datetime-stamped names')
    p.add_argument('input_folder')
    p.add_argument('output_folder')
    p.add_argument('--dry_run', action='store_true')

    p = sub.add_parser('crops-from-cct', help='crop annotations out of '
                                              'a CCT database')
    p.add_argument('cct_file')
    p.add_argument('image_dir')
    p.add_argument('output_dir')
    p.add_argument('--padding', type=int, default=0)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()

    if args.command == 'remove-exif':
        remove_exif(args.image_folder, n_workers=args.n_workers)
    elif args.command == 'rename':
        rename_images(args.input_folder, args.output_folder,
                      dry_run=args.dry_run)
    elif args.command == 'crops-from-cct':
        generate_crops_from_cct(args.cct_file, args.image_dir,
                                args.output_dir, padding=args.padding)


if __name__ == '__main__':
    main()
