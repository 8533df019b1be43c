"""
Fixtures of the benchmark's own tests: small copies of the cells (the
same configuration files with fewer layers, narrower widths and smaller
frames) that the harness can run on the CPU, and the look for a card,
made inside a fixture so that every worker collects the same tests.
"""

import copy
import json
import os

import pytest
import torch

from benchmark import run


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""

    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA CUDA card')
    return torch.device('cuda', 0)


def _small_detector(config):
    config = copy.deepcopy(config)
    config.update(depth_multiple=0.33, width_multiple=0.25, image_size=256)
    config['metadata'] = dict(config['metadata'], arch='yolov5n6',
                              image_size=256)
    config['weights'] = dict(config['weights'], small_canvas=128,
                             calibration_frames_per_size=2)
    return config


SMALL_TRAFFIC = {
    'camtrap': dict(frame_sizes=[[192, 256], [120, 256]], pool_per_size=8,
                    chunk=64, run_length=16, loader_workers=2,
                    warmup_passes=1, trace_chunks=1),
}


@pytest.fixture
def small_spec(tmp_path):
    """(spec, traffic folder): BENCHMARK.json with every configuration
    file replaced by a small copy in [tmp_path] and the traffic files'
    small copies there; the configurations' float dtype is float32, so a
    sound run reads the reference's answers to rounding."""

    spec = run.load_spec()
    for entry in spec['configs']:
        with open(os.path.join(run.ROOT, entry['file'])) as f:
            config = _small_detector(json.load(f))
        config['detector_options'] = dict(config['detector_options'],
                                          dtype='float32')
        path = tmp_path / (entry['name'] + '.json')
        path.write_text(json.dumps(config))
        entry['file'] = str(path)
    for name, small in SMALL_TRAFFIC.items():
        with open(os.path.join(run.BENCH_DIR, 'traffic', name + '.json')) as f:
            traffic = json.load(f)
        traffic.update(small)
        (tmp_path / (name + '.json')).write_text(json.dumps(traffic))
    return spec, str(tmp_path)
