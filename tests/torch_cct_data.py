"""
Shared inputs for the port's CCT-database and classification-tool tests
(numpy and PIL only): a seeded COCO Camera Traps world of JPEGs in
camera and location folders, and a byte comparison of two output trees
with time fields masked.
"""

import copy
import importlib
import os
import re

import numpy as np
from PIL import Image

# both(root, tag, run) and relative(value, folder), shared with the
# postprocessing tools' tests
from torch_postprocessing_data import both, relative  # noqa: F401

CATEGORIES = [{'id': 0, 'name': 'empty'}, {'id': 1, 'name': 'deer'},
              {'id': 2, 'name': 'fox'}, {'id': 5, 'name': 'Elk'}]
SIZES = ((48, 64), (64, 48), (40, 72))


def pair(path):
    """(JAX module, the port's module) of [path] (e.g.
    'data_management.cct_to_md')."""

    return tuple(importlib.import_module('{}.{}'.format(package, path))
                 for package in ('megadetector_tpu', 'megadetector_tpu_torch'))


def cct_world(root, n=16, seed=0):
    """[n] seeded JPEGs under root/images/cam{0,1}/loc{0,1}/ and a CCT dict
    over them (no width or height; one image listed but not on disk, one
    image with no annotation, boxes on most annotations, one annotation
    of two on some images). Returns (images folder, CCT dict)."""

    rng = np.random.RandomState(seed)
    folder = os.path.join(str(root), 'images')
    images, annotations = [], []
    for i in range(n):
        rel = 'cam{}/loc{}/img_{:02d}.jpg'.format(i % 2, (i // 2) % 2, i)
        h, w = SIZES[i % 3]
        if i != n - 1:
            os.makedirs(os.path.dirname(os.path.join(folder, rel)),
                        exist_ok=True)
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                os.path.join(folder, rel), quality=90)
        images.append({'id': 'im{:02d}'.format(i), 'file_name': rel,
                       'location': 'cam{}_loc{}'.format(i % 2, (i // 2) % 2),
                       'datetime': '2024-01-{:02d} 10:00:00'.format(i + 1)})
        if i == 3:
            continue
        category = [1, 2, 5, 0][i % 4]
        ann = {'id': 'ann{:02d}'.format(i), 'image_id': images[-1]['id'],
               'category_id': category}
        if category:
            x, y = rng.uniform(0, 0.5, 2)
            bw, bh = rng.uniform(0.1, 0.45, 2)
            ann['bbox'] = [round(float(x * w), 2), round(float(y * h), 2),
                           round(float(bw * w), 2), round(float(bh * h), 2)]
        annotations.append(ann)
        if i % 5 == 1:
            annotations.append({'id': 'ann{:02d}b'.format(i),
                                'image_id': images[-1]['id'],
                                'category_id': 2,
                                'bbox': [1.5, 2.0, 10.25, 8.0]})
    return folder, {'info': {'version': '1.0', 'description': 'world'},
                    'images': images, 'annotations': annotations,
                    'categories': copy.deepcopy(CATEGORIES)}


def with_sizes(db, folder):
    """[db] with each image's width and height read from [folder] (the
    missing image left without)."""

    db = copy.deepcopy(db)
    for im in db['images']:
        path = os.path.join(folder, im['file_name'])
        if os.path.isfile(path):
            with Image.open(path) as pil:
                im['width'], im['height'] = pil.size
    return db


def tree(root, mask=()):
    """{relative path: bytes} of every file under [root], with the string
    value of each JSON key named in [mask] (time fields) made constant and
    every other byte kept."""

    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, 'rb') as f:
                data = f.read()
            for key in mask:
                data = re.sub(rb'("' + key.encode() + rb'": )"[^"]*"',
                              rb'\1"MASKED"', data)
            out[os.path.relpath(path, root).replace('\\', '/')] = data
    return out


def masked(value, keys):
    """[value] with every dict entry whose key is in [keys] set to None."""

    if isinstance(value, dict):
        return {k: None if k in keys else masked(v, keys)
                for k, v in value.items()}
    if isinstance(value, list):
        return [masked(v, keys) for v in value]
    return value


def assert_same_tree(got, want, mask=()):
    """The same files under [got] and [want], byte for byte (JSON files
    with the keys in [mask] masked), with [want]'s folder path read as
    [got]'s."""

    a, b = tree(got, mask), tree(want, mask)
    assert sorted(a) == sorted(b)
    assert a, 'no files under {}'.format(got)
    for rel in sorted(b):
        assert a[rel] == b[rel].replace(want.encode(), got.encode()), rel
    return sorted(a)
