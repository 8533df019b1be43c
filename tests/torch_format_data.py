"""
Shared inputs for the port's data-format converter, importer, image-tool
and LILA tests (numpy and PIL only): tests/torch_cct_data.py's seeded CCT
world with sizes filled, MD results over its images (boxes that reach
the image's edge, an image without detections, a failed image), a
folder of YOLO label files, and helpers that run a module's main()
through sys.argv and serve a folder on loopback.
"""

import json
import os
import socket
import sys

import numpy as np

import torch_cct_data as cd

DETECTION_CATEGORIES = {'1': 'animal', '2': 'person', '3': 'vehicle'}


def world(root, n=16, seed=0):
    """cd.cct_world with each image's width and height filled, written to
    root/db.json. Returns (images folder, db dict, db path)."""

    folder, db = cd.cct_world(root, n=n, seed=seed)
    db = cd.with_sizes(db, folder)
    path = os.path.join(str(root), 'db.json')
    with open(path, 'w') as f:
        json.dump(db, f, indent=1)
    return folder, db, path


def md_results(db, seed=0):
    """MD results over [db]'s images: 0-4 seeded boxes an image at MD
    rounding, the first reaching the right edge, none on image 2, the
    missing image failed."""

    rng = np.random.RandomState(seed)
    images = []
    for i, im in enumerate(db['images']):
        if 'width' not in im:
            images.append({'file': im['file_name'], 'detections': None,
                           'failure': 'Failure image access'})
            continue
        detections = []
        for k in range(0 if i == 2 else rng.randint(1, 5)):
            x, y = rng.uniform(0, 0.7, 2)
            w, h = rng.uniform(0.05, 0.3, 2)
            if k == 0:
                w = 1 - x
            detections.append({
                'category': str(rng.randint(1, 4)),
                'conf': round(float(rng.uniform(0.05, 1)), 3),
                'bbox': [round(float(v), 4) for v in (x, y, w, h)]})
        images.append({'file': im['file_name'], 'detections': detections})
    return {'info': {'format_version': '1.4', 'detector': 'md_test.npz'},
            'detection_categories': dict(DETECTION_CATEGORIES),
            'images': images}


def run_main(module, argv, monkeypatch):
    """module.main() with sys.argv [argv] (its first entry the program's
    name); returns main's value."""

    monkeypatch.setattr(sys, 'argv', list(argv))
    return module.main()


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def read(path, mode='rb'):
    with open(path, mode) as f:
        return f.read()
