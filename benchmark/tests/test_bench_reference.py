"""The plain reference against itself at a tiny size: greedy NMS by its
definition, a lower floor only adding boxes below, batch invariance, the
canvases of the traffic's frames, weights that follow the seed."""

import copy
import json
import os

import numpy as np
import torch

from benchmark import run, traffic as traffic_lib, weights
from benchmark.reference import yolov5 as ref_yolov5
from benchmark.tests import conftest


def _small(config_name, small):
    with open(os.path.join(run.BENCH_DIR, 'configs',
                           config_name + '.json')) as f:
        return small(json.load(f))


def test_greedy_nms_by_definition():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (60, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (60, 2))], 1)
    scores = rng.uniform(0, 1, 60)
    kept = list(ref_yolov5.greedy_nms(boxes, scores, 0.45))

    def iou(a, b):
        w = max(0, min(a[2], b[2]) - max(a[0], b[0]))
        h = max(0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = w * h
        area = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * \
            (b[3] - b[1]) - inter
        return inter / area

    expect = []
    for i in np.argsort(-scores):
        if all(iou(boxes[i], boxes[j]) <= 0.45 for j in expect):
            expect.append(i)
    assert kept == expect


def test_canvases_of_the_traffic():
    assert ref_yolov5.canvas_shape((1536, 2048), 1280, 64) == (960, 1280)
    assert ref_yolov5.canvas_shape((1080, 1920), 1280, 64) == (768, 1280)
    img = np.zeros((1080, 1920, 3), np.uint8)
    canvas, gain, (pw, ph) = ref_yolov5.letterbox(img, 1280, 64)
    assert canvas.shape == (768, 1280, 3) and (pw, ph) == (0, 24)


def test_detector_floor_and_batch_invariance():
    config = _small('md-yolov5l6-1280', conftest._small_detector)
    traffic = dict(conftest.SMALL_TRAFFIC['camtrap'], items='frames',
                   blocks_per_frame=6, noise=20, runs_per_period=[3, 2])
    device = torch.device('cpu')
    pool = traffic_lib.generate(traffic, 5, device)['pool']
    params, _ = weights.detector_weights(config, 5, device, pool)
    frames = pool[0][:3] + pool[1][:2]
    low = ref_yolov5.detect(config, params, frames, 0.001, device)
    high = ref_yolov5.detect(config, params, frames, 0.005, device, batch=1)
    for lo, hi in zip(low, high):
        above = [d for d in lo if d[1] > 0.005]
        assert len(above) == len(hi)
        for a, b in zip(above, hi):
            assert a[0] == b[0]
            np.testing.assert_allclose(a[1], b[1], rtol=1e-4)
            np.testing.assert_allclose(a[2], b[2], atol=1e-4)


def test_weights_follow_the_seed():
    config = _small('md-yolov5l6-1280', conftest._small_detector)
    traffic = dict(conftest.SMALL_TRAFFIC['camtrap'], items='frames',
                   blocks_per_frame=6, noise=20, runs_per_period=[3, 2])
    device = torch.device('cpu')

    def draw(seed):
        pool = traffic_lib.generate(traffic, seed, device)['pool']
        return weights.detector_weights(copy.deepcopy(config), seed, device,
                                        pool)[1]
    a, b, c = draw(2 ** 31 + 5), draw(2 ** 31 + 5), draw(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
