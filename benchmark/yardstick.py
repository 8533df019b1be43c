"""
The benchmark's yardstick: the H100's published peaks, the operations and
bytes of a configuration's convolutions (walked from the plain reference
on the meta device, so the count does not depend on what implements the
model), and the reduction of a torch.profiler trace to device busy time,
kernel time by name and idle gaps by what the host was doing.
"""

import importlib
import json
import re

import torch

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at its 700 W limit
PEAKS = {
    'bfloat16': 989e12,       # FLOP/s
    'int8': 1979e12,          # OP/s
    'hbm_bytes': 3.35e12,     # bytes/s
}


def conv_walk(config, batch, height, width):
    """Every conv of [config]'s network on a [batch, 3, height, width]
    input, in forward order: dicts of path, batch, c_in, c_out, k, stride,
    groups, h_in, w_in, h_out, w_out, act. No weights, no arithmetic: the
    reference's forward on the meta device (benchmark/reference/<family>.py,
    whose conv_node(x, node, stride, extra, act) computes a node)."""

    ref = importlib.import_module('benchmark.reference.' + config['family'])
    shapes = ref.param_shapes(config)
    params = {}
    for path, shape in shapes.items():
        node = params
        for key in path.split('/'):
            node = node.setdefault(key, {})
        node['w'] = torch.empty(shape, device='meta')
        node['b'] = torch.empty(shape[-1], device='meta')
    paths = {id(_node_of(params, p)): p for p in shapes}
    records = []

    def hook(node, x, stride, extra, act):
        w = node['w']
        y = ref.conv_node(x, node, stride, extra, act)
        records.append(dict(path=paths[id(node)], batch=x.shape[0],
                            c_in=x.shape[1], c_out=y.shape[1], k=w.shape[0],
                            stride=stride, groups=x.shape[1] // w.shape[2],
                            h_in=x.shape[2], w_in=x.shape[3],
                            h_out=y.shape[2], w_out=y.shape[3], act=act))
        return y

    with torch.inference_mode():
        ref.forward(config, params, torch.empty(
            (batch, 3, height, width), device='meta'), hook=hook)
    return records


def _node_of(params, path):
    node = params
    for key in path.split('/'):
        node = node[key]
    return node


def macs(rec):
    """Multiply-accumulates of one conv record."""

    return (rec['batch'] * rec['h_out'] * rec['w_out'] * rec['c_out'] *
            rec['c_in'] // rec['groups'] * rec['k'] * rec['k'])


def model_flops(records):
    """2 x MACs over [records]."""

    return 2 * sum(macs(r) for r in records)


def out_elements(rec):
    return rec['batch'] * rec['c_out'] * rec['h_out'] * rec['w_out']


def bias_silu_bf16_bytes(rec):
    """E7's bytes for one conv output: the bf16 conv result read, the bf16
    activation written, the bf16 bias read."""

    return 4 * out_elements(rec) + 2 * rec['c_out']


#%% Trace reduction

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


def load_trace(path):
    """A Chrome trace written by torch.profiler: (device events, host
    annotations), each a list of (name, start_us, end_us)."""

    with open(path) as f:
        events = json.load(f)['traceEvents']
    device, host = [], []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat', '')
        start = float(e['ts'])
        end = start + float(e.get('dur', 0.0))
        if cat in DEVICE_CATEGORIES:
            device.append((e['name'], start, end))
        elif cat == 'user_annotation' and e['name'].startswith('bench.'):
            host.append((e['name'], start, end))
    device.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return device, host


def busy_intervals(device, lo, hi):
    """The union of device activity clipped to [lo, hi], merged and
    sorted."""

    merged = []
    for _, s, e in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_within(merged, lo, hi):
    """Microseconds of [merged] intervals inside [lo, hi]."""

    total = 0.0
    for s, e in merged:
        if e <= lo:
            continue
        if s >= hi:
            break
        total += min(e, hi) - max(s, lo)
    return total


def kernel_seconds(device, pattern):
    """Seconds of device events whose name matches [pattern] (a regular
    expression)."""

    rx = re.compile(pattern)
    return sum(e - s for name, s, e in device if rx.search(name)) / 1e6


def top_ops(device, n=10):
    """The [n] device operations that took most time: [[name, s], ...]."""

    by_name = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    return [[k[:64], v] for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(merged, host, lo, hi, n=10):
    """The device's idle time in [lo, hi] by the innermost host annotation
    open at the time ('host' where none is): [[name, s], ...], largest
    first."""

    gaps = []
    cursor = lo
    for s, e in merged:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < hi:
        gaps.append((cursor, hi))
    by_name = {}
    for gs, ge in gaps:
        # Split the gap over the annotations it crosses
        points = sorted({gs, ge} | {t for _, a, b in host for t in (a, b)
                                     if gs < t < ge})
        for a, b in zip(points, points[1:]):
            mid = (a + b) / 2
            open_ = [h for h in host if h[1] <= mid < h[2]]
            name = min(open_, key=lambda h: h[2] - h[1])[0] if open_ \
                else 'host'
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:n]]


#%% Readings shared by the metric readers

def trace_window(obs):
    """(merged busy intervals, lo, hi) of the traced window, or None."""

    t = obs.get('trace')
    if t is None:
        return None
    return busy_intervals(t['device'], t['lo'], t['hi']), t['lo'], t['hi']


def traced_spans(obs, name):
    """The trace's host annotations called [name], inside the window."""

    t = obs['trace']
    return [h for h in t['host']
            if h[0] == name and t['lo'] <= h[1] and h[2] <= t['hi']]


def traced_batches(obs):
    """(images, (canvas h, w)) of each detector batch run in the traced
    window."""

    return [(n, shape) for _, _, n, shape, traced in obs['spans'] if traced]


def counter(obs, name, traced=True):
    """A launch counter's change over the traced window (or the whole
    window)."""

    values = obs['traced_counters'] if traced else obs['counters']
    if values is None:
        return None
    return values[obs['counter_names'].index(name)]


def walk_cached(config, batch, h, w, _cache={}):
    key = (json.dumps(config, sort_keys=True), batch, h, w)
    if key not in _cache:
        _cache[key] = conv_walk(config, batch, h, w)
    return _cache[key]


def detector_e7(obs):
    """(E7 launches a batch, E7 bytes a batch at canvas (h, w)): every
    conv with SiLU but l0, which the fused stem computes."""

    def per_batch(shape, batch):
        recs = [r for r in walk_cached(obs['config'], batch, *shape)
                if r['act'] and r['path'] != 'l0']
        return len(recs), sum(bias_silu_bf16_bytes(r) for r in recs)
    return per_batch

