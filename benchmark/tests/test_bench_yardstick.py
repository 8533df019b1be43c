"""The operation and byte counters against hand counts at small shapes,
and the trace reduction on a made-up trace."""

import json
import os

import pytest

from benchmark import run, yardstick


def _config(name):
    with open(os.path.join(run.BENCH_DIR, 'configs', name + '.json')) as f:
        return json.load(f)


def test_detector_walk_by_hand():
    config = _config('md-yolov5l6-1280')
    recs = yardstick.conv_walk(config, 2, 64, 128)
    l0 = recs[0]
    # 6x6 stride 2 pad 2, 3 -> 64 channels: 32 x 64 outputs
    assert (l0['path'], l0['h_out'], l0['w_out'], l0['c_out']) == \
        ('l0', 32, 64, 64)
    assert yardstick.macs(l0) == 2 * 32 * 64 * 64 * 3 * 6 * 6
    assert yardstick.bias_silu_bf16_bytes(l0) == 4 * 2 * 64 * 32 * 64 + 128
    # 135 convs: 130 with SiLU, four linear detect heads, and l0
    assert len(recs) == 135
    assert sum(r['act'] for r in recs) == 131
    heads = [r for r in recs if not r['act']]
    assert [r['c_out'] for r in heads] == [24] * 4
    assert [r['h_out'] for r in heads] == [8, 4, 2, 1]


def test_detector_flops_scale_with_area():
    config = _config('md-yolov5l6-1280')
    small = yardstick.model_flops(yardstick.conv_walk(config, 1, 128, 128))
    big = yardstick.model_flops(yardstick.conv_walk(config, 1, 256, 256))
    assert big == 4 * small


def test_trace_reduction():
    device = [('a', 0, 10), ('b', 5, 20), ('a', 30, 40), ('c', 95, 120)]
    host = [('bench.window', 0, 100), ('bench.call', 20, 30)]
    merged = yardstick.busy_intervals(device, 0, 100)
    assert merged == [[0, 20], [30, 40], [95, 100]]
    assert yardstick.busy_within(merged, 10, 35) == 15
    assert yardstick.kernel_seconds(device, '^a$') == pytest.approx(20e-6)
    assert yardstick.top_ops(device)[0] == ['c', pytest.approx(25e-6)]
    gaps = dict(yardstick.idle_gaps(merged, host, 0, 100))
    assert gaps['bench.call'] == pytest.approx(10e-6)
    assert gaps['bench.window'] == pytest.approx(55e-6)
