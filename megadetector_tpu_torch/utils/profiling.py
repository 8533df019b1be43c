"""
Tracing and per-stage timing: the port's counterpart of
megadetector_tpu/utils/profiling.py.

The reference's observability is wall-clock spans and an images/sec
summary line (megadetector/detection/run_detector.py:802-878,
run_detector_batch.py:2152-2155). This module keeps that surface (stage
timers that aggregate mean/std/total, a throughput meter, copied) and
traces the device with torch.profiler: xla_trace (the JAX module's name,
kept) records the host and the card's kernels (CUDA activity) and writes
a Chrome trace (trace_<nanoseconds>.json, for Perfetto or chrome://tracing) into
its log_dir; annotate(name) is torch.profiler.record_function, a named
span in that trace.
"""

import contextlib
import math
import os
import time

from collections import defaultdict


class StageTimer:
    """
    Accumulates wall-clock spans per named stage
    (load / preprocess / device_put / forward / nms / postprocess /
    write). Thread-safe enough for the loader-pool use case (GIL-guarded
    float appends).
    """

    def __init__(self):
        self.samples = defaultdict(list)
        self._start_time = time.time()

    @contextlib.contextmanager
    def time_stage(self, stage):
        t0 = time.time()
        try:
            yield
        finally:
            self.samples[stage].append(time.time() - t0)

    def record(self, stage, seconds):
        self.samples[stage].append(seconds)

    def stats(self):
        """{stage: {'n', 'total', 'mean', 'std'}}."""

        out = {}
        for stage, xs in self.samples.items():
            n = len(xs)
            total = sum(xs)
            mean = total / n
            var = sum((x - mean) ** 2 for x in xs) / n if n > 1 else 0.0
            out[stage] = {'n': n, 'total': total, 'mean': mean,
                          'std': math.sqrt(var)}
        return out

    def summary(self):
        """Human-readable per-stage summary."""

        lines = []
        for stage, s in sorted(self.stats().items(),
                               key=lambda kv: -kv[1]['total']):
            lines.append(
                '{:<14s} n={:<6d} total={:>8.2f}s mean={:>7.1f}ms '
                'std={:>6.1f}ms'.format(
                    stage, s['n'], s['total'], 1000 * s['mean'],
                    1000 * s['std']))
        return '\n'.join(lines)

    def print_summary(self):
        print(self.summary())


class ThroughputMeter:
    """images/sec meter with the reference's summary-line format."""

    def __init__(self):
        self.n_items = 0
        self.t_start = time.time()

    def update(self, n=1):
        self.n_items += n

    @property
    def elapsed(self):
        return time.time() - self.t_start

    @property
    def rate(self):
        e = self.elapsed
        return self.n_items / e if e > 0 else 0.0

    def summary_line(self, label='images'):
        return ('Finished inference for {} {} in {:.1f}s '
                '({:.2f} {}/sec)'.format(
                    self.n_items, label, self.elapsed, self.rate, label))


@contextlib.contextmanager
def xla_trace(log_dir, enabled=True):
    """
    Capture a torch.profiler trace of the host and, where a card is
    present, its kernels (CUDA activity) into [log_dir] as
    trace_<nanoseconds>.json (Chrome trace format, for Perfetto). Yields the
    profiler (None when disabled or when it cannot start). No-op when
    disabled; a profiler that cannot start or stop prints a warning, as
    the JAX module does.
    """

    if not enabled:
        yield None
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:
        print('Warning: could not start the trace: {}'.format(e))
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                path = os.path.join(log_dir, 'trace_{}.json'.format(
                    time.time_ns()))
                prof.export_chrome_trace(path)
                print('Wrote trace to {}'.format(path))
            except Exception as e:
                print('Warning: could not stop the trace: {}'.format(e))


def annotate(name):
    """torch.profiler.record_function: a named span in the trace (host
    side, around the kernels it launches)."""

    import torch
    return torch.profiler.record_function(name)
