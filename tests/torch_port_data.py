"""
Shared inputs for the port's tests (numpy and torch only, no jax, so the
card's tests can use them too): seeded images and a yolov5n parameter set
whose detect heads give well-separated detections.
"""

import numpy as np
import torch

from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.ops.boxes import letterbox

IMAGE_SIZE = 256
# Two aspect buckets: 4 images fill one batch of 4, 3 leave one tail
SIZES = [(240, 320)] * 4 + [(300, 200)] * 3


def images():
    """Seeded uint8 HWC images at SIZES: gradients plus broadband noise."""

    rng = np.random.RandomState(0)
    out = []
    for h, w in SIZES:
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.zeros((h, w, 3), np.int32)
        img[..., 0] = 255 * xx // w
        img[..., 1] = 255 * yy // h
        img[..., 2] = 96
        img += rng.randint(-40, 40, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def sharpened_params(imgs):
    """
    yolov5n parameters (seed 0) whose detect heads are rescaled so the
    objectness and class logits have std 2 on [imgs], with the objectness
    bias lowered by 9. Random weights otherwise give near-tied scores
    that saturate max_det; these give fewer, well-separated detections.
    """

    config = yolov5.YoloV5Config('yolov5n', 3)
    params = yolov5.init_params(config, seed=0)
    model = yolov5.YoloV5(config).load_params(params).eval()
    x = np.stack([letterbox(im, (IMAGE_SIZE, IMAGE_SIZE), stride=32,
                            auto=False)[0] for im in imgs[:4]])
    with torch.inference_mode():
        heads = model(torch.from_numpy(x.astype(np.float32) / 255.0),
                      decode=False)
    no = config.num_outputs
    detect = params['l{}'.format(len(config.layers) - 1)]
    for lvl, head in enumerate(heads):
        h = head.numpy().reshape(head.shape[:3] + (3, no))
        w = detect['m{}'.format(lvl)]['w']
        b = detect['m{}'.format(lvl)]['b']
        for a in range(3):
            for c in range(4, no):
                s = 2.0 / h[..., a, c].std()
                w[..., a * no + c] *= s
                b[a * no + c] = -h[..., a, c].mean() * s - \
                    (9.0 if c == 4 else 0.0)
    return params


METADATA = {'arch': 'yolov5n', 'model_type': 'yolov5', 'num_classes': 3,
            'class_names': ['animal', 'person', 'vehicle'],
            'image_size': IMAGE_SIZE}


def golden_options():
    """md_tests comparison options at the golden tolerances."""

    from megadetector_tpu.utils import md_tests

    options = md_tests.MDTestOptions()
    options.comparison_confidence_threshold = 0.005
    options.iou_match_threshold = 0.85
    options.max_conf_error = 0.005
    options.max_coord_error = 0.001
    return options
