"""
Shared inputs for the port's folder-workflow tests (numpy and PIL only):
seeded JPEGs in camera folders, synthetic MD results files whose boxes
repeat at each camera (the repeats RDE finds), with optional
classifications under plain or taxonomy-string categories, a COCO Camera
Traps ground truth for them, and a byte comparison of two output trees.
"""

import json
import os
import re

import numpy as np
from PIL import Image

# Three camera locations; the second sits under a capture-point folder
# that ct_utils.image_file_to_camera_folder strips
FOLDERS = ('cam_a', 'cam_b/100RECNX', 'cam_c')
SIZES = ((96, 128), (128, 96))
DETECTION_CATEGORIES = {'1': 'animal', '2': 'person', '3': 'vehicle'}
CLASS_NAMES = ['deer', 'fox', 'cow', 'other']
TAXA = ['uuid1;mammalia;cetartiodactyla;cervidae;odocoileus;virginianus;'
        'white-tailed deer',
        'uuid2;mammalia;carnivora;canidae;vulpes;vulpes;red fox',
        'uuid3;mammalia;carnivora;canidae;urocyon;cinereoargenteus;'
        'gray fox',
        'uuid4;mammalia;carnivora;canidae;;;canidae']


def write_images(root, per_folder=8, seed=0):
    """Seeded JPEGs (gradients plus noise) under root/FOLDERS; returns
    their sorted relative paths."""

    rng = np.random.RandomState(seed)
    files = []
    for folder in FOLDERS:
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        for i in range(per_folder):
            h, w = SIZES[i % 2]
            yy, xx = np.mgrid[0:h, 0:w]
            img = np.zeros((h, w, 3), np.int32)
            img[..., 0] = 255 * xx // w
            img[..., 1] = 255 * yy // h
            img[..., 2] = 40 * i
            img += rng.randint(-30, 30, (h, w, 3))
            rel = '{}/img_{:02d}.jpg'.format(folder, i)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(root, rel), quality=90)
            files.append(rel)
    return sorted(files)


def _classifications(rng, n_classes):
    scores = rng.dirichlet(np.full(n_classes, 0.4))
    order = np.argsort(-scores)[:3]
    return [[str(int(c) + 1), round(float(scores[c]), 3)] for c in order]


def results(files, seed=0, classified=False, taxa=False, failure=True):
    """
    An MD results dict over [files]: every camera has one box that
    recurs (within a few thousandths) in most of its images at confidence
    0.3-0.7, plus up to three random boxes an image; the first file of the
    last folder is a failure when [failure]. With [classified], animal
    detections carry top-3 classifications (over TAXA's taxonomy strings
    with [taxa]).
    """

    rng = np.random.RandomState(seed)
    repeat_box = {folder: [round(float(v), 4) for v in (
        rng.uniform(0.1, 0.6), rng.uniform(0.1, 0.6),
        rng.uniform(0.05, 0.15), rng.uniform(0.05, 0.15))]
        for folder in FOLDERS}
    n_classes = len(TAXA) if taxa else len(CLASS_NAMES)
    images = []
    for fn in files:
        folder = os.path.dirname(fn)
        if failure and fn == [f for f in files
                              if f.startswith(FOLDERS[-1])][0]:
            images.append({'file': fn, 'failure': 'image access failure',
                           'detections': None})
            continue
        detections = []
        if rng.uniform() < 0.8:
            jitter = rng.uniform(-0.002, 0.002, 4)
            box = [round(float(v + d), 4)
                   for v, d in zip(repeat_box[folder], jitter)]
            detections.append({'category': '1',
                               'conf': round(float(rng.uniform(0.3, 0.7)),
                                             3),
                               'bbox': box})
        for _ in range(rng.randint(0, 4)):
            w, h = rng.uniform(0.05, 0.5, 2)
            x, y = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            detections.append({
                'category': str(rng.choice([1, 1, 1, 2, 3])),
                'conf': round(float(rng.uniform(0.005, 0.99)), 3),
                'bbox': [round(float(v), 4) for v in (x, y, w, h)]})
        if classified:
            for d in detections:
                if d['category'] == '1':
                    d['classifications'] = _classifications(rng, n_classes)
        detections.sort(key=lambda d: -d['conf'])
        images.append({'file': fn, 'detections': detections})
    data = {'info': {'format_version': '1.4', 'detector': 'synthetic.npz',
                     'detector_metadata': {
                         'megadetector_version': 'v5a.0.0',
                         'typical_detection_threshold': 0.2,
                         'conservative_detection_threshold': 0.05}},
            'detection_categories': dict(DETECTION_CATEGORIES),
            'images': images}
    if classified:
        if taxa:
            data['classification_categories'] = {
                str(i + 1): t.split(';')[-1] for i, t in enumerate(TAXA)}
            data['classification_category_descriptions'] = {
                str(i + 1): t for i, t in enumerate(TAXA)}
        else:
            data['classification_categories'] = {
                str(i + 1): n for i, n in enumerate(CLASS_NAMES)}
    return data


def ground_truth(files, seed=0):
    """A COCO Camera Traps dict over [files]: one image in five empty,
    one unlabeled, the rest animals (one ambiguous with an empty label)."""

    rng = np.random.RandomState(seed + 100)
    categories = [{'id': 0, 'name': 'empty'}, {'id': 1, 'name': 'deer'},
                  {'id': 2, 'name': 'fox'}, {'id': 3, 'name': 'unknown'}]
    images, annotations = [], []
    for i, fn in enumerate(files):
        image_id = 'im{:03d}'.format(i)
        images.append({'id': image_id, 'file_name': fn})
        kind = i % 5
        cats = [[0], [1], [2], [3], [1, 0]][kind] if i % 7 else []
        for c in cats:
            annotations.append({'id': 'ann{}_{}'.format(i, c),
                                'image_id': image_id, 'category_id': c})
        if kind == 1 and rng.uniform() < 0.5:
            annotations.append({'id': 'ann{}_x'.format(i),
                                'image_id': image_id, 'category_id': 2})
    return {'info': {'version': '1'}, 'images': images,
            'annotations': annotations, 'categories': categories}


def write_json(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(data, f, indent=1)
    return path


# Folder names that carry the time they were written
_STAMPED = re.compile(r'filtering_\d{4}\.\d\d\.\d\d\.\d\d\.\d\d\.\d\d')


def unstamped(text):
    """[text] with RDE's timestamped folder names made constant."""

    return _STAMPED.sub('filtering_STAMP', text)


def tree(root):
    """{relative path: bytes} of every file under [root], with
    timestamped folder names made constant."""

    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            rel = unstamped(os.path.relpath(path, root).replace('\\', '/'))
            with open(path, 'rb') as f:
                out[rel] = f.read()
    return out


def assert_json_close(got, want, atol):
    """The same JSON structure, strings and integers, and floats within
    [atol]."""

    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            assert_json_close(got[k], want[k], atol)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            assert_json_close(a, b, atol)
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= atol, \
            (got, want)
    else:
        assert got == want


def assert_same_tree(got, want, replace=(), close=(), atol=1e-6):
    """Every file under [got] byte-identical to its namesake under [want]
    and the same set of files; [replace] holds (bytes, bytes) substitutions
    applied to [want]'s files first (e.g. its own folder's path). The JSON
    files named in [close] (a model's scores) need only agree to [atol]."""

    a, b = tree(got), tree(want)
    assert sorted(a) == sorted(b)
    assert a, 'no files under {}'.format(got)
    for rel in sorted(b):
        ref = b[rel]
        for old, new in replace:
            ref = ref.replace(old, new)
        if rel in close:
            assert_json_close(json.loads(a[rel]), json.loads(ref), atol)
        else:
            assert a[rel] == ref, rel
    return sorted(a)
