"""
A MegaDetector cell: frames through the port's batch driver
(load_and_run_detector_batch), chunk after chunk, with the detector object
passed in behind a thin recorder that times each batch call.

Set-up: the traffic's frame pool and the weights from the seed (rescaled
on the reference), the checkpoint written to a temporary folder (and, for
an int8 configuration, quantized by the port's quantize_checkpoint,
calibrated on frames of the pool), the detector loaded, then the pool run
through the driver `warmup_passes` times: every program key the window can
meet (canvas, capacity) is eager, captured and replayed before the window.

Window: whole driver calls on chunks of the arrival order until
`seconds` have passed. With trace on, the first `trace_chunks` chunks run
under torch.profiler.

After the window: the peak memory is read, the detector freed, and every
result of the window is held against the reference's detections of its
frame (the pool's frames, each run once through the reference).
"""

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import compare, systems, tracing, traffic as traffic_lib
from benchmark import weights
from benchmark.reference import yolov5 as ref_yolov5


class Recorder:
    """The detector as the driver sees it: every attribute is the
    detector's; each generate_detections_one_batch call is timed as
    (start, end, images, canvas), and named in the trace while
    [annotate]."""

    def __init__(self, detector):
        self._detector = detector
        self.spans = []
        self.annotate = False

    def __getattr__(self, name):
        return getattr(self._detector, name)

    def generate_detections_one_batch(self, img_originals, *args, **kwargs):
        start = time.perf_counter()
        with tracing.annotate('bench.generate_detections_one_batch',
                              self.annotate):
            out = self._detector.generate_detections_one_batch(
                img_originals, *args, **kwargs)
        shape = tuple(img_originals[0].get('target_shape') or (0, 0))
        self.spans.append((start, time.perf_counter(), len(img_originals),
                           shape, self.annotate))
        return out


def _program_calls(detector):
    return {k: e.calls for k, e in detector._programs.entries.items()}


def run(cell, config, traffic, seed, seconds, trace, device):
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch
    from megadetector_tpu_torch.models import program_cache

    marks = [('imports', time.perf_counter())]
    inputs = traffic_lib.generate(traffic, seed, device)
    pool = inputs['pool']
    marks.append(('traffic', time.perf_counter()))
    params, flat = weights.detector_weights(config, seed, device, pool)
    marks.append(('weights', time.perf_counter()))
    host_flat = {k: v.cpu() for k, v in flat.items()}
    del params, flat
    tmp = tempfile.mkdtemp(prefix='mdbench-')
    try:
        path = weights.write_checkpoint(host_flat, config['metadata'],
                                        os.path.join(tmp, 'detector.npz'))
        if config.get('quantize'):
            from megadetector_tpu_torch.models.convert_weights import \
                quantize_checkpoint
            q = config['quantize']
            side = q['calibration_canvas']
            stride = max(ref_yolov5.strides(config))
            images = np.stack([ref_yolov5.letterbox(pool[s][j], side,
                                                    stride, auto=False)[0]
                               for s in sorted(pool)
                               for j in range(q['frames_per_size'])])
            path = quantize_checkpoint(
                path, os.path.join(tmp, 'detector_int8.npz'),
                mode=q['mode'], device=device,
                calibration_images=images.astype(np.float32) / 255.0)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        detector = load_detector(path, detector_options=dict(
            config['detector_options']), device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    marks.append(('load', time.perf_counter()))
    recorder = Recorder(detector)
    threshold = float(config['confidence_threshold'])

    def drive(pairs):
        return load_and_run_detector_batch(
            recorder, pairs, confidence_threshold=threshold,
            batch_size=traffic['batch_size'], quiet=True,
            loader_workers=traffic['loader_workers'],
            queue_depth=traffic['queue_depth'])

    warm = [('warm/{}/{}'.format(s, j), frame) for s in sorted(pool)
            for j, frame in enumerate(pool[s])]
    for _ in range(traffic['warmup_passes']):
        drive(warm)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)

    marks.append(('warmup', time.perf_counter()))
    recorder.spans.clear()
    calls0 = _program_calls(detector)
    counters0 = program_cache.read_counters()
    replays0 = detector._programs.replays
    programs0 = detector.programs_run
    chunks = traffic_lib.frame_chunks(inputs, traffic)
    done = []
    failed = 0
    tracer = tracing.Tracer(trace and device.type == 'cuda')
    traced = {}
    start = time.perf_counter()
    n_chunk = 0
    while True:
        chunk = next(chunks)
        in_trace = trace and n_chunk < traffic['trace_chunks']
        if in_trace and n_chunk == 0:
            tracer.start()
            recorder.annotate = True
            traced['counters'] = program_cache.read_counters()
        results = drive([(i, frame) for i, frame, _ in chunk])
        n_chunk += 1
        if in_trace and n_chunk == traffic['trace_chunks']:
            recorder.annotate = False
            traced['counters'] = [
                b - a for a, b in zip(traced['counters'],
                                      program_cache.read_counters())]
            tracer.stop()
        for (_, _, key), r in zip(chunk, results):
            if r.get('failure') or r.get('detections') is None:
                failed += 1
            done.append((key, r))
        if time.perf_counter() - start >= seconds:
            break
    end = time.perf_counter()
    if tracer.active:
        recorder.annotate = False
        tracer.stop()

    calls = _program_calls(detector)
    escalated = sum(n - calls0.get(k, 0) for k, n in calls.items()
                    if 'select' in k and
                    k[k.index('select') + 1] > detector.pre_nms_topk)
    obs = {
        'setup_s': start - systems.PROCESS_START,
        'window_s': end - start,
        'completed': len(done) - failed,
        'attempted': len(done),
        'failed': failed,
        'end_to_end': {'images_per_s': (len(done) - failed) /
                       (end - start)},
        'spans': list(recorder.spans),
        'batches': detector.programs_run - programs0,
        'escalated': escalated,
        'program_calls': sum(calls.values()) - sum(calls0.values()),
        'replays': detector._programs.replays - replays0,
        'counters': [b - a for a, b in zip(
            counters0, program_cache.read_counters())],
        'traced_counters': traced.get('counters'),
        'counter_names': [m.__name__.split('.')[-1] + '.' + a
                          for m, a in program_cache.LAUNCH_COUNTERS],
        'memory_peak_bytes': int(torch.cuda.max_memory_allocated(device))
        if device.type == 'cuda' else 0,
        'trace': tracer.result(),
        'facts': {'detections_per_image': float(np.mean(
            [len(r['detections']) for _, r in done
             if r.get('detections') is not None] or [0])),
            'setup_steps_s': systems.steps(marks)},
    }
    del recorder, detector
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    obs['numbers'], record = check(config, pool, done, host_flat, device)
    obs['facts'].update(record)
    return obs


def check(config, pool, done, host_flat, device):
    """(compared numbers, figures for the record): every window result
    against the reference's detections of its frame."""

    params = weights._tree({k: v.to(device) for k, v in host_flat.items()})
    keys = [(s, j) for s in sorted(pool) for j in range(len(pool[s]))]
    reference = ref_yolov5.detect(
        config, params, [pool[s][j] for s, j in keys],
        float(config['reference_floor']), device)
    reference = dict(zip(keys, reference))
    del params
    tally = compare.DetectionTally(float(config['compare_floor']),
                                   conf_ratio=float(config['conf_ratio']))
    for key, r in done:
        dets = r.get('detections')
        if dets is not None:
            tally.add([compare.md_to_xyxy(d) for d in dets], reference[key],
                      pad=1.0 / min(pool[key[0]][key[1]].shape[:2]))
    return tally.numbers()
