"""
Convert a COCO Camera Traps database to YOLO training format.

Behavioral contract follows the reference
(megadetector/data_management/coco_to_yolo.py:96): one .txt per image with
'class_index cx cy w h' rows (normalized center format), a class-list
file, optional dataset.yaml, category exclusion, and handling of images
with no annotations (empty label files or no file).

The port's own copy of megadetector_tpu/data_management/coco_to_yolo.py:
the same public names, signatures, defaults and output bytes. No
progress bars: the card's machine is not promised tqdm.
"""

import argparse
import json
import os
import sys


def write_yolo_dataset_file(dataset_file, dataset_base_dir, class_list,
                            train_folder_relative=None,
                            val_folder_relative=None,
                            test_folder_relative=None):
    """Write a YOLOv5-style dataset.yaml."""

    if isinstance(class_list, str):
        with open(class_list) as f:
            class_list = [line.strip() for line in f
                          if len(line.strip()) > 0]

    with open(dataset_file, 'w') as f:
        f.write('path: {}\n'.format(dataset_base_dir))
        if train_folder_relative is not None:
            f.write('train: {}\n'.format(train_folder_relative))
        if val_folder_relative is not None:
            f.write('val: {}\n'.format(val_folder_relative))
        if test_folder_relative is not None:
            f.write('test: {}\n'.format(test_folder_relative))
        f.write('\nnames:\n')
        for i, name in enumerate(class_list):
            f.write('  {}: {}\n'.format(i, name))
    return dataset_file


def coco_to_yolo(input_image_folder, output_folder, input_file,
                 source_format='coco',
                 overwrite_images=False,
                 create_image_and_label_folders=False,
                 class_file_name='classes.txt',
                 allow_empty_annotations=True,
                 clip_boxes=True,
                 category_names_to_exclude=None,
                 write_output=True,
                 flatten_paths=False):
    """
    Convert COCO(-CT) annotations to YOLO label files.

    Boxes in COCO are absolute [x, y, w, h]; YOLO wants normalized
    center format. Returns a dict with 'class_list' and
    'image_to_yolo_rows'.
    """

    if category_names_to_exclude is None:
        category_names_to_exclude = []

    with open(input_file) as f:
        data = json.load(f)

    # Category IDs -> contiguous 0-based YOLO indices (sorted by ID)
    categories = [c for c in data['categories']
                  if c['name'] not in category_names_to_exclude]
    categories = sorted(categories, key=lambda c: c['id'])
    cat_id_to_yolo_idx = {c['id']: i for i, c in enumerate(categories)}
    class_list = [c['name'] for c in categories]

    image_id_to_image = {im['id']: im for im in data['images']}
    image_id_to_rows = {im['id']: [] for im in data['images']}

    n_clipped = 0
    for ann in data.get('annotations', []):
        if ann.get('bbox') is None:
            continue
        if ann['category_id'] not in cat_id_to_yolo_idx:
            continue
        im = image_id_to_image.get(ann['image_id'])
        if im is None:
            continue
        img_w = im.get('width')
        img_h = im.get('height')
        assert img_w and img_h, \
            'Image {} is missing width/height'.format(im['id'])

        x, y, w, h = ann['bbox']
        if clip_boxes:
            x_clipped = max(x, 0)
            y_clipped = max(y, 0)
            w = min(w - (x_clipped - x), img_w - x_clipped)
            h = min(h - (y_clipped - y), img_h - y_clipped)
            if x != x_clipped or y != y_clipped:
                n_clipped += 1
            x, y = x_clipped, y_clipped
        if w <= 0 or h <= 0:
            continue

        cx = (x + w / 2.0) / img_w
        cy = (y + h / 2.0) / img_h
        rel_w = w / img_w
        rel_h = h / img_h
        image_id_to_rows[ann['image_id']].append(
            (cat_id_to_yolo_idx[ann['category_id']], cx, cy, rel_w, rel_h))

    image_to_yolo_rows = {}
    for image_id, rows in image_id_to_rows.items():
        im = image_id_to_image[image_id]
        image_to_yolo_rows[im['file_name']] = rows

    if write_output:
        os.makedirs(output_folder, exist_ok=True)
        with open(os.path.join(output_folder, class_file_name), 'w') as f:
            for name in class_list:
                f.write(name + '\n')

        for im in data['images']:
            rows = image_id_to_rows[im['id']]
            if len(rows) == 0 and not allow_empty_annotations:
                continue
            fn = im['file_name']
            if flatten_paths:
                fn = fn.replace('/', '#').replace('\\', '#')
            label_fn = os.path.join(
                output_folder, os.path.splitext(fn)[0] + '.txt')
            os.makedirs(os.path.dirname(label_fn), exist_ok=True)
            with open(label_fn, 'w') as f:
                for row in rows:
                    f.write('{} {:.6f} {:.6f} {:.6f} {:.6f}\n'.format(
                        *row))

            if input_image_folder is not None and \
                    input_image_folder != output_folder:
                src = os.path.join(input_image_folder, im['file_name'])
                dst = os.path.join(output_folder, fn)
                if os.path.isfile(src) and (overwrite_images or
                                            not os.path.isfile(dst)):
                    import shutil
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copy2(src, dst)

    if n_clipped > 0:
        print('Clipped {} boxes'.format(n_clipped))

    return {'class_list': class_list,
            'image_to_yolo_rows': image_to_yolo_rows}


def create_yolo_symlinks(source_folder, images_folder,
                         labels_folder, class_list_file=None,
                         class_list_output_name='object.data',
                         force_lowercase_image_extension=False):
    """
    Symlink a mixed YOLO folder's images and .txt labels into separate
    images/labels trees (for tools that expect split layouts;
    reference: coco_to_yolo.py:549-605). Falls back to copying on
    filesystems without symlink support.
    """

    import shutil

    assert source_folder != images_folder and \
        source_folder != labels_folder

    os.makedirs(images_folder, exist_ok=True)
    os.makedirs(labels_folder, exist_ok=True)

    def _link(source, target):
        if os.path.lexists(target):
            os.remove(target)
        try:
            os.symlink(os.path.abspath(source), target)
        except OSError:
            shutil.copyfile(source, target)

    from megadetector_tpu_torch.utils.path_utils import find_images
    image_files_relative = find_images(
        source_folder, recursive=True, return_relative_paths=True)
    for image_fn_relative in image_files_relative:
        source_file_abs = os.path.join(source_folder, image_fn_relative)
        target_file_abs = os.path.join(images_folder, image_fn_relative)
        if force_lowercase_image_extension:
            base, ext = os.path.splitext(target_file_abs)
            target_file_abs = base + ext.lower()
        os.makedirs(os.path.dirname(target_file_abs), exist_ok=True)
        _link(source_file_abs, target_file_abs)

        source_label = os.path.splitext(source_file_abs)[0] + '.txt'
        if os.path.isfile(source_label):
            target_label = os.path.join(
                labels_folder,
                os.path.splitext(image_fn_relative)[0] + '.txt')
            os.makedirs(os.path.dirname(target_label), exist_ok=True)
            _link(source_label, target_label)

    if class_list_file is not None:
        _link(class_list_file,
              os.path.join(labels_folder, class_list_output_name))


def main():
    parser = argparse.ArgumentParser(
        description='Convert a COCO(-CT) database to YOLO format')
    parser.add_argument('input_image_folder')
    parser.add_argument('output_folder')
    parser.add_argument('input_file')
    parser.add_argument('--exclude_categories', nargs='*', default=None)

    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()

    args = parser.parse_args()
    coco_to_yolo(args.input_image_folder, args.output_folder,
                 args.input_file,
                 category_names_to_exclude=args.exclude_categories)


if __name__ == '__main__':
    main()
