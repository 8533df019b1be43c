"""
The detector's per-shape program cache: the port's counterpart of the JAX
detector's _get_compiled and _PROGRAM_CACHE, which compile one program per
(batch, canvas, capacity) and dispatch it as a single call.

A program is a function of device tensors, run under one key. On a CUDA
device a key's first call runs eagerly (the warm-up: cuDNN picks its
algorithms and the kernels set their shared-memory attributes before any
capture), its second call captures the program into a torch.cuda.CUDAGraph
and replays it, and every later call replays it. On the CPU every call
runs eagerly: no graphs there, by design, as the kernels' plain versions
run there.

- Static inputs. A program's host inputs (numpy arrays) are copied into
  device tensors kept per key, through pinned host buffers kept per key
  (non_blocking copies). The host refills a pinned buffer only after the
  event of its last copy has completed. Device inputs (another program's
  outputs) must be the same tensors at every replay; a program captures
  only when its caller says they are static.
- The pool. The graphs of one cache share one memory pool. Every captured
  program keeps its static inputs and outputs alive for the cache's
  lifetime, so no later capture takes their memory and any replay order is
  safe; dropping the cache frees the graphs and the pool.
- Launch counters. Each kernel wrapper adds one to its module's counter
  where it launches; a capture launches nothing on the card. So a capture
  records each counter's change and puts the counters back, and every
  replay adds that change: a program call then counts each kernel once per
  launch on the card, whether it ran eagerly or replayed.
- No quiet fallback: a capture or replay that fails raises KernelError.
"""

import numpy as np
import torch

from megadetector_tpu_torch.ops import (bottleneck_int8, conv_int8,
                                        cuda_nms, gemm_int8, l0_fused,
                                        silu_bf16)
from megadetector_tpu_torch.ops._build import KernelError

# The kernel wrappers' launch counters, as (module, attribute)
LAUNCH_COUNTERS = ((cuda_nms, 'launches'), (conv_int8, 'launches'),
                   (conv_int8, 'exp_launches'),
                   (bottleneck_int8, 'launches'), (l0_fused, 'launches'),
                   (silu_bf16, 'launches'), (gemm_int8, 'launches'))


def read_counters():
    return [getattr(module, name) for module, name in LAUNCH_COUNTERS]


def _set_counters(values):
    for (module, name), v in zip(LAUNCH_COUNTERS, values):
        setattr(module, name, v)


class CudaGraphCapture:
    """Captures programs into torch.cuda.CUDAGraphs that share one pool."""

    def __init__(self):
        self.pool = None

    def capture(self, fn, inputs):
        """(graph, fn(*inputs)'s outputs, now static); graph.replay()
        reruns the program on the card."""

        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # 'relaxed': the kernels' C entry points set function attributes
        # and query errors, which the stricter modes may refuse
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode='relaxed'):
            outputs = fn(*inputs)
        return graph, outputs


class _Entry:
    """One key's program: its calls, static inputs and, once captured,
    its graph, static outputs and counter changes."""

    def __init__(self):
        self.calls = 0
        self.host_static = None   # device tensors the host inputs go to
        self.pinned = None        # their pinned host twins (CUDA)
        self.copy_done = None     # event of the last copy out of pinned
        self.graph = None
        self.inputs = None        # the tensors the graph reads
        self.outputs = None
        self.delta = None


class ProgramCache:
    """
    Programs by key on [device]. [capturer] captures on the card
    (default: CudaGraphCapture there, none on the CPU); the tests pass a
    stand-in with the same capture(fn, inputs) -> (graph, outputs).
    """

    def __init__(self, device, capturer=None):
        self.device = torch.device(device)
        if capturer is None and self.device.type == 'cuda':
            capturer = CudaGraphCapture()
        self.capturer = capturer
        self.entries = {}
        self.captures = 0
        self.replays = 0

    def run(self, key, fn, host_inputs=(), device_inputs=(), graphs=True,
            capture=True):
        """
        fn(*staged host inputs, *device_inputs) under [key]: eagerly on the
        first call, when [graphs] is false or there is no capturer, and
        when [capture] is false (the device inputs are not static yet);
        otherwise captured on the second call and replayed from then on.
        Returns (outputs, replayed); a replay's outputs are the graph's
        static tensors, rewritten by every replay of this key.
        """

        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = _Entry()
        inputs = self._stage(entry, host_inputs) + tuple(device_inputs)
        entry.calls += 1
        use_graph = graphs and self.capturer is not None
        if use_graph and entry.graph is not None:
            if len(inputs) != len(entry.inputs) or any(
                    a is not b for a, b in zip(inputs, entry.inputs)):
                raise KernelError('program {}: its inputs are not the '
                                  'tensors it was captured with'.format(key))
            self._replay(entry, key)
            return entry.outputs, True
        if not use_graph or not capture or entry.calls < 2:
            return fn(*inputs), False

        before = read_counters()
        try:
            entry.graph, entry.outputs = self.capturer.capture(fn, inputs)
        except Exception as e:
            entry.graph = entry.outputs = None
            raise KernelError('capture of program {} failed: {}'.format(
                key, e)) from e
        finally:
            after = read_counters()
            _set_counters(before)
        entry.delta = [a - b for a, b in zip(after, before)]
        entry.inputs = inputs
        self.captures += 1
        self._replay(entry, key)
        return entry.outputs, True

    def _replay(self, entry, key):
        try:
            entry.graph.replay()
        except Exception as e:
            raise KernelError('replay of program {} failed: {}'.format(
                key, e)) from e
        _set_counters([c + d for c, d in zip(read_counters(), entry.delta)])
        self.replays += 1

    def _stage(self, entry, host_inputs):
        """The key's static device tensors, refilled from [host_inputs]
        (numpy arrays of the key's shapes)."""

        sources = [torch.from_numpy(np.ascontiguousarray(a))
                   for a in host_inputs]
        if entry.host_static is None:
            entry.host_static = tuple(
                torch.empty_like(t, device=self.device) for t in sources)
            if self.device.type == 'cuda':
                entry.pinned = tuple(
                    torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in sources)
        if entry.pinned is None:
            for t, dst in zip(sources, entry.host_static):
                dst.copy_(t)
            return entry.host_static
        if entry.copy_done is not None:
            entry.copy_done.synchronize()
        for t, pinned, dst in zip(sources, entry.pinned, entry.host_static):
            pinned.copy_(t)
            dst.copy_(pinned, non_blocking=True)
        entry.copy_done = torch.cuda.Event()
        entry.copy_done.record()
        return entry.host_static
