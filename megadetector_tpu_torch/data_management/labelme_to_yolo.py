"""
Convert labelme annotations to YOLO label files.

Behavioral contract follows the reference
(megadetector/data_management/labelme_to_yolo.py): one .txt next to each
image with normalized center-format rows; the class list is collected
from shape labels (or provided).

The port's own copy of megadetector_tpu/data_management/labelme_to_yolo.py:
the same public names, signatures, defaults and output bytes. Its
process pool is spawned where JAX's forks.
"""

import argparse
import json
import os
import sys

from megadetector_tpu_torch.utils.path_utils import find_images, \
    recursive_file_list


def labelme_to_yolo(input_folder, class_list=None,
                    class_file_name='classes.txt',
                    recursive=True, overwrite=True):
    """
    Write YOLO .txt labels next to the images in [input_folder]. Returns
    the (possibly extended) class list.
    """

    if class_list is None:
        class_list = []
    class_to_idx = {name: i for i, name in enumerate(class_list)}

    labelme_files = [fn for fn in recursive_file_list(
        input_folder, return_relative_paths=False, recursive=recursive)
        if fn.endswith('.json')]

    for labelme_path in labelme_files:
        try:
            with open(labelme_path) as f:
                labelme = json.load(f)
        except Exception:
            continue
        if 'shapes' not in labelme:
            continue
        w = labelme.get('imageWidth')
        h = labelme.get('imageHeight')
        if not w or not h:
            continue

        rows = []
        for shape in labelme['shapes']:
            if shape.get('shape_type') != 'rectangle':
                continue
            label = shape['label']
            if label not in class_to_idx:
                class_to_idx[label] = len(class_list)
                class_list.append(label)
            xs = [p[0] for p in shape['points']]
            ys = [p[1] for p in shape['points']]
            x0, x1 = min(xs), max(xs)
            y0, y1 = min(ys), max(ys)
            rows.append('{} {:.6f} {:.6f} {:.6f} {:.6f}'.format(
                class_to_idx[label],
                (x0 + x1) / 2 / w, (y0 + y1) / 2 / h,
                (x1 - x0) / w, (y1 - y0) / h))

        txt_path = os.path.splitext(labelme_path)[0] + '.txt'
        if os.path.isfile(txt_path) and not overwrite:
            continue
        with open(txt_path, 'w') as f:
            f.write('\n'.join(rows) + ('\n' if rows else ''))

    with open(os.path.join(input_folder, class_file_name), 'w') as f:
        for name in class_list:
            f.write(name + '\n')
    return class_list


def labelme_file_to_yolo_file(labelme_file,
                              category_name_to_category_id,
                              yolo_file=None,
                              required_token=None,
                              overwrite_behavior='overwrite'):
    """
    Convert one labelme .json file to a YOLO .txt file (defaults to
    s/json/txt), reproducing the reference's conversion semantics
    (labelme_to_yolo.py:25-146): pixel boxes normalized over
    (dim - 1), out-of-image shapes skipped, boxes clipped, and a result
    dict with 'labelme_file' and 'status' ('converted',
    'skip-exists', or 'skip-no-required-token'). When [required_token]
    is given and absent from the labelme dict, the file is skipped.
    """

    result = {'labelme_file': labelme_file, 'status': 'unknown'}

    assert os.path.isfile(labelme_file), \
        'Could not find labelme .json file {}'.format(labelme_file)
    assert labelme_file.endswith('.json'), \
        'Illegal labelme .json file {}'.format(labelme_file)

    if yolo_file is None:
        yolo_file = os.path.splitext(labelme_file)[0] + '.txt'

    if os.path.isfile(yolo_file):
        if overwrite_behavior == 'skip':
            result['status'] = 'skip-exists'
            return result
        assert overwrite_behavior == 'overwrite', \
            'Unrecognized overwrite behavior {}'.format(
                overwrite_behavior)

    with open(labelme_file, 'r') as f:
        labelme_data = json.load(f)

    if required_token is not None and \
            required_token not in labelme_data:
        result['status'] = 'skip-no-required-token'
        return result

    im_height = labelme_data['imageHeight']
    im_width = labelme_data['imageWidth']

    yolo_lines = []
    for shape in labelme_data['shapes']:
        assert shape['shape_type'] == 'rectangle', \
            'I only know how to convert rectangles to YOLO format'
        assert shape['label'] in category_name_to_category_id, \
            'Category {} not in category mapping'.format(shape['label'])
        assert len(shape['points']) == 2, 'Illegal rectangle'
        category_id = category_name_to_category_id[shape['label']]

        p0, p1 = shape['points']
        minx_abs = min(p0[0], p1[0])
        maxx_abs = max(p0[0], p1[0])
        miny_abs = min(p0[1], p1[1])
        maxy_abs = max(p0[1], p1[1])

        if (minx_abs >= (im_width - 1)) or (maxx_abs <= 0) or \
                (miny_abs >= (im_height - 1)) or (maxy_abs <= 0):
            print('Skipping invalid shape in {}'.format(labelme_file))
            continue

        # YOLOv5/v8 get sad about boxes extending outside the image
        maxx_abs = min(maxx_abs, im_width - 1)
        maxy_abs = min(maxy_abs, im_height - 1)
        minx_abs = max(minx_abs, 0.0)
        miny_abs = max(miny_abs, 0.0)

        if im_width == 1:
            minx_rel = maxx_rel = 0.0
        else:
            minx_rel = minx_abs / (im_width - 1)
            maxx_rel = maxx_abs / (im_width - 1)
        if im_height == 1:
            miny_rel = maxy_rel = 0.0
        else:
            miny_rel = miny_abs / (im_height - 1)
            maxy_rel = maxy_abs / (im_height - 1)

        yolo_lines.append('{} {:.3f} {:.3f} {:.3f} {:.3f}'.format(
            category_id,
            (maxx_rel + minx_rel) / 2.0, (maxy_rel + miny_rel) / 2.0,
            maxx_rel - minx_rel, maxy_rel - miny_rel))

    with open(yolo_file, 'w') as f:
        for s in yolo_lines:
            f.write(s + '\n')

    result['status'] = 'converted'
    return result


def labelme_folder_to_yolo(labelme_folder,
                           category_name_to_category_id=None,
                           required_token=None,
                           overwrite_behavior='overwrite',
                           relative_filenames_to_convert=None,
                           n_workers=1,
                           use_threads=True):
    """
    Convert the labelme .json files in [labelme_folder] to YOLO .txt
    files (reference: labelme_to_yolo.py:148-282). When
    [category_name_to_category_id] is None, first reads every label in
    the folder to build a zero-indexed mapping. Returns a dict with
    'category_name_to_category_id' and 'image_results' (one status dict
    per file, see labelme_file_to_yolo_file).
    """

    if relative_filenames_to_convert is not None:
        labelme_files_relative = relative_filenames_to_convert
        assert all(fn.endswith('.json')
                   for fn in labelme_files_relative), \
            'relative_filenames_to_convert contains non-json files'
    else:
        labelme_files_relative = [
            fn for fn in recursive_file_list(
                labelme_folder, return_relative_paths=True)
            if fn.endswith('.json')]

    if required_token is not None:
        valid = []
        for fn_relative in labelme_files_relative:
            with open(os.path.join(labelme_folder, fn_relative)) as f:
                if required_token in json.load(f):
                    valid.append(fn_relative)
        labelme_files_relative = valid

    if category_name_to_category_id is None:
        category_name_to_category_id = {}
        for fn_relative in labelme_files_relative:
            with open(os.path.join(labelme_folder, fn_relative)) as f:
                for shape in json.load(f)['shapes']:
                    if shape['label'] not in \
                            category_name_to_category_id:
                        category_name_to_category_id[shape['label']] = \
                            len(category_name_to_category_id)

    from functools import partial
    convert_one = partial(
        labelme_file_to_yolo_file,
        category_name_to_category_id=category_name_to_category_id,
        yolo_file=None,
        required_token=required_token,
        overwrite_behavior=overwrite_behavior)
    files_abs = [os.path.join(labelme_folder, fn)
                 for fn in labelme_files_relative]

    n_workers = min(n_workers, max(len(files_abs), 1))
    if n_workers <= 1:
        image_results = [convert_one(fn) for fn in files_abs]
    else:
        # partial over the module-level function stays picklable for
        # process pools. Spawned, not forked: the caller may hold a CUDA
        # context and loader threads
        import multiprocessing
        from multiprocessing.pool import ThreadPool
        pool_cls = ThreadPool if use_threads else \
            multiprocessing.get_context('spawn').Pool
        with pool_cls(n_workers) as pool:
            image_results = list(pool.map(convert_one, files_abs))

    return {'category_name_to_category_id':
            category_name_to_category_id,
            'image_results': image_results}


def main():
    parser = argparse.ArgumentParser(
        description='Convert labelme annotations to YOLO labels')
    parser.add_argument('input_folder')
    if len(sys.argv[1:]) == 0:
        parser.print_help()
        parser.exit()
    args = parser.parse_args()
    labelme_to_yolo(args.input_folder)


if __name__ == '__main__':
    main()
