"""
Shared inputs for the port's postprocessing-tool tests (numpy and PIL
only): two detectors' results over the seeded JPEGs of
torch_workflow_data (A with classifications, image sizes on every other
image, capture times and a video record with frame numbers; B a
perturbed copy of A, as a second model would see the same images), a
COCO ground truth in pixels, per-image species labels, and a helper that
runs one call of the JAX module and of the port's copy into sibling
folders.
"""

import os

import numpy as np
from PIL import Image

import torch_workflow_data as wd


def image_sizes(images, files):
    """{relative path: (width, height)} of the JPEGs under [images]."""

    out = {}
    for fn in files:
        with Image.open(os.path.join(images, fn)) as im:
            out[fn] = im.size
    return out


def results_a(files, sizes, seed=0):
    """Model A: torch_workflow_data's classified results, width and height
    on every other image, a capture time on every third, and a video
    record (frame numbers on its detections) that no image folder holds."""

    data = wd.results(files, seed=seed, classified=True)
    for i, im in enumerate(data['images']):
        if i % 2 == 0:
            im['width'], im['height'] = sizes[im['file']]
        if i % 3 == 0:
            im['datetime'] = '2024:05:{:02d} 10:00:00'.format(i + 1)
    data['images'].append({
        'file': 'cam_c/clip.mp4', 'frame_rate': 30.0,
        'frames_processed': [0, 30, 60],
        'detections': [
            {'category': '1', 'conf': 0.81, 'bbox': [0.1, 0.2, 0.3, 0.3],
             'frame_number': 30,
             'classifications': [['1', 0.7], ['2', 0.2]]},
            {'category': '2', 'conf': 0.44, 'bbox': [0.5, 0.5, 0.2, 0.4],
             'frame_number': 60}]})
    return data


def results_b(a, seed=1):
    """Model B over A's images: most of A's boxes jittered a little, at
    0.6-0.95 of A's confidence, and up to two boxes of its own an image;
    no classifications."""

    rng = np.random.RandomState(seed)
    images = []
    for im in a['images']:
        if im['detections'] is None:
            images.append(dict(im))
            continue
        detections = []
        for d in im['detections']:
            if rng.uniform() < 0.75:
                box = [round(float(np.clip(v + rng.uniform(-0.01, 0.01),
                                           0, 1)), 4) for v in d['bbox']]
                detections.append({
                    'category': d['category'],
                    'conf': round(d['conf'] * float(rng.uniform(0.6, 0.95)),
                                  3),
                    'bbox': box})
        for _ in range(rng.randint(0, 3)):
            w, h = rng.uniform(0.02, 0.3, 2)
            x, y = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            detections.append({
                'category': str(rng.choice([1, 2, 3])),
                'conf': round(float(rng.uniform(0.01, 0.95)), 3),
                'bbox': [round(float(v), 4) for v in (x, y, w, h)]})
        detections.sort(key=lambda d: -d['conf'])
        images.append({k: v for k, v in im.items()
                       if k != 'detections'} | {'detections': detections})
    return {'info': dict(a['info'], detector='model_b.npz'),
            'detection_categories': dict(a['detection_categories']),
            'images': images}


def coco_truth(a, sizes, seed=2):
    """A COCO ground truth in pixels over A's images: each of A's boxes
    above 0.25 kept with probability 0.7, jittered, its category name
    changed with probability 0.1; one box of its own in one image of
    four; images without a size entry are left out."""

    rng = np.random.RandomState(seed)
    names = ['animal', 'person', 'vehicle']
    images, annotations = [], []
    for i, im in enumerate(a['images']):
        if im['file'] not in sizes:
            continue
        w, h = sizes[im['file']]
        image_id = 'im{:03d}'.format(i)
        images.append({'id': image_id, 'file_name': im['file'],
                       'width': w, 'height': h})
        boxes = [(int(d['category']), d['bbox'])
                 for d in im['detections'] or [] if d['conf'] > 0.25
                 and rng.uniform() < 0.7]
        if rng.uniform() < 0.25:
            boxes.append((int(rng.randint(1, 4)), [0.6, 0.1, 0.3, 0.2]))
        for category, (x, y, bw, bh) in boxes:
            if rng.uniform() < 0.1:
                category = category % 3 + 1
            j = rng.uniform(-0.01, 0.01, 4)
            annotations.append({
                'id': len(annotations), 'image_id': image_id,
                'category_id': category,
                'bbox': [float((x + j[0]) * w), float((y + j[1]) * h),
                         float((bw + j[2]) * w), float((bh + j[3]) * h)]})
    return {'info': {'version': '1'}, 'images': images,
            'annotations': annotations,
            'categories': [{'id': i + 1, 'name': n}
                           for i, n in enumerate(names)]}


def class_truth(files, seed=3):
    """{file: species name} over [files]: a class name, 'empty' or
    'blank' (both count as empty), seeded."""

    rng = np.random.RandomState(seed)
    choices = list(wd.CLASS_NAMES) + ['empty', 'blank']
    return {fn: str(rng.choice(choices)) for fn in files}


def both(root, tag, run):
    """run(side, out_dir) for the JAX module (side 0) and the port's copy
    (side 1) into root/tag/jax and root/tag/port; returns ((the port's
    value, its folder), (JAX's value, its folder))."""

    out = []
    for side, name in enumerate(('jax', 'port')):
        folder = os.path.join(str(root), tag, name)
        os.makedirs(folder, exist_ok=True)
        out.append((run(side, folder), folder))
    return out[1], out[0]


def relative(value, folder):
    """[value] with [folder] + '/' taken out of every string in it."""

    if isinstance(value, str):
        return value.replace(folder + os.sep, '').replace(folder, '')
    if isinstance(value, dict):
        return {relative(k, folder): relative(v, folder)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(relative(v, folder) for v in value)
    return value
