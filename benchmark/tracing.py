"""
The traced window: torch.profiler over the host and the card (CUPTI),
its Chrome trace written to a temporary file and reduced to device events
and the benchmark's own host annotations (bench.*), which name the calls
into the program and bound the traced window.
"""

import contextlib
import os
import tempfile

import torch

from benchmark import yardstick


@contextlib.contextmanager
def annotate(name, enabled=True):
    """A named host range in the trace while [enabled]."""

    if not enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


class Tracer:
    """start() / stop() around the traced window; result() is None when
    disabled, else {'device', 'host', 'lo', 'hi'} (microseconds of the
    trace's clock)."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.active = False
        self._prof = None
        self._window = None
        self._result = None

    def start(self):
        if not self.enabled:
            return
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = torch.profiler.record_function('bench.window')
        self._window.__enter__()
        self.active = True

    def stop(self):
        if not self.active:
            return
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        fd, path = tempfile.mkstemp(suffix='.json', prefix='mdbench-trace-')
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            device, host = yardstick.load_trace(path)
        finally:
            os.remove(path)
        self._prof = None
        window = [h for h in host if h[0] == 'bench.window']
        lo, hi = window[0][1], window[0][2]
        self._result = {'device': device, 'host': host, 'lo': lo, 'hi': hi}

    def result(self):
        return self._result
