"""
Real-time MegaDetector inference server with dynamic micro-batching.

The reference exposed this capability as its hosted "Synchronous API"
("intended for real-time scenarios where a small number of images are
processed at a time and latency is a priority", reference:
megadetector/api/README.md:7-10; the implementation itself is archived
upstream). This module is the port of megadetector_tpu/serving/server.py,
a self-hosted daemon on one CUDA card:

- HTTP daemon (stdlib ThreadingHTTPServer, no service dependencies);
  request threads decode images in parallel, a single batcher thread
  owns the card.
- Dynamic micro-batching: concurrent requests are grouped into one
  device batch (up to max_batch_size, waiting at most batch_wait_ms
  for stragglers), padded to a fixed program shape via the detector's
  pad_batches_to option, so each canvas shape has one program-cache key
  (one CUDA graph, replayed from its second call) whatever the load.
- MD-format responses: each image yields the same record the batch
  pipeline writes ('file', 'detections', 'max_detection_conf', failure
  containment with the contractual failure strings), wrapped in an
  envelope carrying 'detection_categories'.

Where it differs from the JAX server:

- One card: the detector's own device serves; use_mesh is taken and has
  no effect (the batch driver's rule), and where more than one card is
  visible the server says which one it uses (the data-parallel split is
  ROADMAP A8).
- A device fault (models/detector.is_device_fault: a kernel's build or
  launch failure, a CUDA runtime error, the card's memory running out) is
  never served as an 'inference failure' record, as the JAX server's
  catch-all does: the batcher stops, every pending and later request gets
  HTTP 500 naming the fault, /healthz answers 503, and serve_forever()
  re-raises the fault once FAULT_LINGER_S has passed (or at shutdown), so
  that main() exits non-zero. Only data errors are contained.

Endpoints:
    POST /v1/detect        raw image bytes (query: id=..., threshold=...)
    POST /v1/detect_batch  JSON {"images": [{"id":..., "data": <base64>}],
                                 "detection_threshold": ...}
    GET  /healthz          readiness + model identity (503 after a fault)
    GET  /metrics          counters, latency percentiles, throughput
    GET  /v1/model         model metadata (version, classes, image size)

Run:  python -m megadetector_tpu_torch.serving.server MODEL [--port 8000]
      [--device cuda|cuda:N|cpu] ...
"""

import argparse
import base64
import io
import json
import sys
import threading
import time

from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import torch

from megadetector_tpu_torch.models.detector import (
    DEFAULT_DETECTOR_LABEL_MAP,
    FAILURE_IMAGE_OPEN,
    is_device_fault,
)
from megadetector_tpu_torch.utils import ct_utils


DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD = 0.005

#: After a device fault, how long serve_forever goes on answering (HTTP
#: 500 / 503, so that clients in flight hear why) before it re-raises the
#: fault (seconds)
FAULT_LINGER_S = 2.0


class ServingOptions:
    """Options for MDServer."""

    def __init__(self):

        #: Interface to bind (default loopback; set 0.0.0.0 to expose)
        self.host = '127.0.0.1'

        #: TCP port (0 picks a free port, reported via server.port)
        self.port = 8000

        #: Device batch capacity; also the padded program batch shape,
        #: so exactly one program per canvas shape serves all loads
        self.max_batch_size = 8

        #: How long the batcher waits for additional requests once it
        #: has at least one (milliseconds). Small values favor latency,
        #: larger values favor batching efficiency under load.
        self.batch_wait_ms = 15.0

        #: Confidence floor recorded in responses (the reference's
        #: output floor, run_detector.py:251); per-request 'threshold'
        #: can only raise it
        self.detection_threshold = DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD

        #: Back-pressure: pending images beyond this return HTTP 429
        self.max_queue_size = 64

        #: Per-request wall limit waiting for a result (covers a first
        #: kernel build, hence generous)
        self.request_timeout_s = 600.0

        #: Maximum accepted request body (bytes); oversized posts get 413
        self.max_body_bytes = 64 * 1024 * 1024

        #: Passed through to load_detector (e.g. {'image_size': 640,
        #: 'compute_dtype': 'int8', 'canvas_mode': 'auto'})
        self.detector_options = None

        #: Force the CPU backend (useful for tests and CPU-only hosts)
        self.force_cpu = False

        #: 'cuda', 'cuda:N', 'cpu' or None (CUDA; the CPU with force_cpu)
        self.device = None

        self.verbose = False


class _Pending:
    """One image waiting for (or holding) a detection result."""

    __slots__ = ('image', 'image_id', 'threshold', 'event', 'result',
                 'error', 't_start')

    def __init__(self, image, image_id, threshold):
        self.image = image
        self.image_id = image_id
        self.threshold = threshold
        self.event = threading.Event()
        self.result = None
        #: Set (with the event) when a device fault ends the batcher
        self.error = None
        self.t_start = time.monotonic()


class _Metrics:
    """Thread-safe serving counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.t_started = time.monotonic()
        self.requests_total = 0
        self.images_total = 0
        self.failures_total = 0
        self.rejected_total = 0
        self.batches_total = 0
        self.batched_images_total = 0
        self.latencies_s = deque(maxlen=1024)

    def record_request(self, n_images=1):
        with self._lock:
            self.requests_total += 1
            self.images_total += n_images

    def record_rejection(self):
        with self._lock:
            self.rejected_total += 1

    def record_batch(self, n):
        with self._lock:
            self.batches_total += 1
            self.batched_images_total += n

    def record_result(self, latency_s, failed):
        with self._lock:
            self.latencies_s.append(latency_s)
            if failed:
                self.failures_total += 1

    def snapshot(self):
        with self._lock:
            lat = sorted(self.latencies_s)
            uptime = max(time.monotonic() - self.t_started, 1e-9)

            def pct(p):
                if not lat:
                    return None
                return round(lat[min(int(len(lat) * p), len(lat) - 1)], 4)

            return {
                'uptime_s': round(uptime, 1),
                'requests_total': self.requests_total,
                'images_total': self.images_total,
                'failures_total': self.failures_total,
                'rejected_total': self.rejected_total,
                'batches_total': self.batches_total,
                'mean_batch_size': round(
                    self.batched_images_total / self.batches_total, 2)
                    if self.batches_total else None,
                'images_per_second': round(self.images_total / uptime, 3),
                'latency_p50_s': pct(0.50),
                'latency_p90_s': pct(0.90),
                'latency_p99_s': pct(0.99),
            }


class _Batcher(threading.Thread):
    """
    The single card owner: drains pending requests into device batches.
    One thread, so detector programs never race on the card. A device
    fault stops it (fault, fault_time); see _fail.
    """

    def __init__(self, detector, options, metrics):
        super().__init__(daemon=True, name='md-serving-batcher')
        self.detector = detector
        self.options = options
        self.metrics = metrics
        self._queue = deque()
        self._lock = threading.Lock()
        self._wakeup = threading.Event()
        self._halt = False
        self.fault = None
        self.fault_time = None

    @staticmethod
    def fault_message(fault):
        return 'device fault: {}: {}'.format(type(fault).__name__, fault)

    def submit(self, pending):
        """Enqueue one _Pending; returns False when over capacity. After a
        fault the pending is answered at once with the fault."""

        with self._lock:
            if self.fault is not None:
                pending.error = self.fault_message(self.fault)
                pending.event.set()
                return True
            if len(self._queue) >= self.options.max_queue_size:
                return False
            self._queue.append(pending)
        self._wakeup.set()
        return True

    def queue_depth(self):
        with self._lock:
            return len(self._queue)

    def stop(self):
        self._halt = True
        self._wakeup.set()
        if self.is_alive():
            self.join(timeout=30)

    def _fail(self, fault, batch):
        """A device fault: stop, and answer the batch and everything
        queued with it."""

        print('Serving stopped by a device fault ({} images in the batch): '
              '{}'.format(len(batch), fault), file=sys.stderr)
        message = self.fault_message(fault)
        with self._lock:
            self.fault = fault
            self.fault_time = time.monotonic()
            self._halt = True
            failed = list(batch) + list(self._queue)
            self._queue.clear()
        for pending in failed:
            pending.error = message
            pending.event.set()

    def _take_batch(self):
        """
        Block until at least one request is pending, then gather up to
        max_batch_size, waiting batch_wait_ms for stragglers.
        """

        while not self._halt:
            with self._lock:
                if self._queue:
                    break
            self._wakeup.wait(timeout=0.25)
            self._wakeup.clear()
        if self._halt:
            return []

        deadline = time.monotonic() + self.options.batch_wait_ms / 1000.0
        while True:
            with self._lock:
                full = len(self._queue) >= self.options.max_batch_size
            remaining = deadline - time.monotonic()
            if full or remaining <= 0 or self._halt:
                break
            self._wakeup.wait(timeout=min(remaining, 0.005))
            self._wakeup.clear()

        with self._lock:
            batch = [self._queue.popleft()
                     for _ in range(min(len(self._queue),
                                        self.options.max_batch_size))]
        return batch

    def run(self):
        while not self._halt:
            batch = self._take_batch()
            if not batch:
                continue
            self._run_batch(batch)

    def _run_batch(self, batch):
        # One program invocation records everything down to the lowest
        # threshold in the batch; per-request filtering happens at
        # response assembly
        floor = min([p.threshold for p in batch] +
                    [self.options.detection_threshold])
        try:
            results = self.detector.generate_detections_one_batch(
                [p.image for p in batch],
                [p.image_id for p in batch],
                detection_threshold=floor,
                verbose=self.options.verbose)
        except Exception as e:
            if is_device_fault(e):
                self._fail(e, batch)
                return
            # Containment of data errors only
            print('Serving batch failure ({} images): {}'.format(
                len(batch), e), file=sys.stderr)
            results = [{'file': p.image_id, 'detections': None,
                        'failure': 'inference failure'} for p in batch]
        self.metrics.record_batch(len(batch))
        now = time.monotonic()
        for pending, record in zip(batch, results):
            pending.result = _filter_record(record, pending.threshold)
            self.metrics.record_result(
                now - pending.t_start,
                failed=(record.get('detections') is None))
            pending.event.set()


def _filter_record(record, threshold):
    """Apply a per-request confidence threshold to one MD image record."""

    if record.get('detections') is None:
        return record
    detections = [d for d in record['detections']
                  if d['conf'] >= threshold]
    out = dict(record)
    out['detections'] = detections
    out['max_detection_conf'] = ct_utils.round_float(
        max([d['conf'] for d in detections], default=0.0), precision=3)
    return out


class MDServer:
    """
    The serving daemon: loads the detector, owns the batcher and the
    HTTP listener. Use as a context manager or call start()/shutdown().
    """

    def __init__(self, model_file, options=None):

        self.options = options or ServingOptions()
        self.metrics = _Metrics()

        from megadetector_tpu_torch.detection.run_detector import \
            load_detector
        detector_options = dict(self.options.detector_options or {})
        # Pin the padded program batch shape to the serving capacity so
        # partial micro-batches reuse the same program (one program-cache
        # key, one CUDA graph, per canvas)
        detector_options.setdefault('pad_batches_to',
                                    self.options.max_batch_size)
        # The JAX server's use_mesh splits batches over local devices; one
        # card serves here (ROADMAP A8), so any value is taken and has no
        # effect, as in the batch driver
        detector_options.pop('use_mesh', None)
        self.detector = load_detector(
            model_file, force_cpu=self.options.force_cpu,
            detector_options=detector_options,
            verbose=self.options.verbose, device=self.options.device)
        self.model_file = model_file
        n_cards = torch.cuda.device_count()
        if n_cards > 1:
            print('{} CUDA devices visible; serving on {} only (data-'
                  'parallel serving is not ported)'.format(
                      n_cards, self.detector.device))

        self.batcher = _Batcher(self.detector, self.options, self.metrics)

        server_ref = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = 'HTTP/1.1'

            def log_message(self, fmt, *args):
                if server_ref.options.verbose:
                    BaseHTTPRequestHandler.log_message(self, fmt, *args)

            def _send_json(self, code, payload):
                body = json.dumps(payload).encode('utf-8')
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == '/healthz':
                    health = server_ref.health()
                    self._send_json(
                        200 if health['status'] == 'ok' else 503, health)
                elif path == '/metrics':
                    self._send_json(200, server_ref.metrics.snapshot())
                elif path == '/v1/model':
                    self._send_json(200, server_ref.model_info())
                else:
                    self._send_json(404, {'error': 'unknown path'})

            def do_POST(self):
                path = urlparse(self.path).path
                try:
                    length = int(self.headers.get('Content-Length', 0))
                except ValueError:
                    self._send_json(411, {'error': 'length required'})
                    return
                if length > server_ref.options.max_body_bytes:
                    self._send_json(413, {'error': 'request too large'})
                    return
                body = self.rfile.read(length)
                if path == '/v1/detect':
                    query = parse_qs(urlparse(self.path).query)
                    image_id = query.get('id', ['image'])[0]
                    threshold = _parse_threshold(
                        query.get('threshold', [None])[0],
                        server_ref.options.detection_threshold)
                    if threshold is None:
                        self._send_json(400, {'error': 'bad threshold'})
                        return
                    code, payload = server_ref.handle_images(
                        [(image_id, body)], threshold)
                    self._send_json(code, payload)
                elif path == '/v1/detect_batch':
                    try:
                        request = json.loads(body.decode('utf-8'))
                        entries = request['images']
                        assert isinstance(entries, list) and entries
                        images = [(str(e.get('id', 'image_{}'.format(i))),
                                   base64.b64decode(e['data']))
                                  for i, e in enumerate(entries)]
                    except Exception:
                        self._send_json(
                            400, {'error': 'expected {"images": '
                                           '[{"id":..., "data": b64}]}'})
                        return
                    threshold = _parse_threshold(
                        request.get('detection_threshold'),
                        server_ref.options.detection_threshold)
                    if threshold is None:
                        self._send_json(400, {'error': 'bad threshold'})
                        return
                    code, payload = server_ref.handle_images(
                        images, threshold)
                    self._send_json(code, payload)
                else:
                    self._send_json(404, {'error': 'unknown path'})

        self.httpd = ThreadingHTTPServer(
            (self.options.host, self.options.port), _Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._serve_thread = None
        self._stopped = threading.Event()

    # %% Request handling

    def handle_images(self, id_bytes_pairs, threshold):
        """
        Decode, batch-infer, and assemble the response envelope for a
        list of (image_id, raw_bytes). Returns (http_code, payload).
        """

        self.metrics.record_request(n_images=len(id_bytes_pairs))
        if self.batcher.fault is not None:
            return 500, {'error': self.batcher.fault_message(
                self.batcher.fault)}
        pendings = []
        for image_id, raw in id_bytes_pairs:
            image = _decode_image(raw)
            pendings.append(_Pending(image, image_id, threshold))

        for pending in pendings:
            if pending.image is None:
                # Contractual failure record, no device work
                pending.result = {'file': pending.image_id,
                                  'detections': None,
                                  'failure': FAILURE_IMAGE_OPEN}
                self.metrics.record_result(
                    time.monotonic() - pending.t_start, failed=True)
                pending.event.set()
            elif not self.batcher.submit(pending):
                self.metrics.record_rejection()
                return 429, {'error': 'server overloaded',
                             'queue_depth': self.batcher.queue_depth()}

        timeout = self.options.request_timeout_s
        for pending in pendings:
            if not pending.event.wait(timeout=timeout):
                return 504, {'error': 'inference timed out'}
            if pending.error is not None:
                return 500, {'error': pending.error}

        return 200, {
            'images': [p.result for p in pendings],
            'detection_categories': self.detection_categories(),
        }

    # %% Introspection

    def detection_categories(self):
        names = getattr(self.detector, 'class_names', None) or \
            list(DEFAULT_DETECTOR_LABEL_MAP.values())
        return {str(i + 1): name for i, name in enumerate(names)}

    def model_info(self):
        metadata = getattr(self.detector, 'metadata', None) or {}
        return {
            'model_file': self.model_file,
            'model_version': metadata.get('model_version_string',
                                          'unknown'),
            'image_size': getattr(self.detector, 'default_image_size',
                                  None),
            'detection_categories': self.detection_categories(),
            'max_batch_size': self.options.max_batch_size,
            'detection_threshold_floor': self.options.detection_threshold,
        }

    def health(self):
        health = {'status': 'ok',
                  'model_version': self.model_info()['model_version'],
                  'queue_depth': self.batcher.queue_depth()}
        if self.batcher.fault is not None:
            health['status'] = 'fault'
            health['error'] = self.batcher.fault_message(self.batcher.fault)
        return health

    # %% Lifecycle

    def start(self):
        """Start the batcher and the HTTP listener (non-blocking)."""

        self.batcher.start()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name='md-serving-http')
        self._serve_thread.start()
        return self

    def serve_forever(self):
        """Blocking variant of start() for CLI use: returns at shutdown()
        or a keyboard interrupt; after a device fault, shuts down once
        FAULT_LINGER_S has passed (or at shutdown()) and re-raises the
        fault."""

        self.start()
        print('MegaDetector serving on http://{}:{} (model {})'.format(
            self.options.host, self.port, self.model_file))
        try:
            while not self._stopped.wait(0.05):
                fault_time = self.batcher.fault_time
                if fault_time is not None and time.monotonic() - \
                        fault_time >= FAULT_LINGER_S:
                    break
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()
        if self.batcher.fault is not None:
            raise self.batcher.fault

    def shutdown(self):
        if self._stopped.is_set():
            return
        self._stopped.set()
        if self._serve_thread is not None:
            self.httpd.shutdown()
            self._serve_thread.join(timeout=30)
        self.httpd.server_close()
        self.batcher.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.shutdown()


def _decode_image(raw):
    """Bytes -> RGB uint8 numpy array, or None when undecodable."""

    import numpy as np
    from megadetector_tpu_torch.visualization import visualization_utils \
        as vis_utils
    try:
        image = vis_utils.load_image(io.BytesIO(raw))
        arr = np.asarray(image)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        return arr
    except Exception:
        return None


def _parse_threshold(value, default):
    """Parse a request threshold; returns None on invalid input."""

    if value is None:
        return default
    try:
        threshold = float(value)
    except (TypeError, ValueError):
        return None
    if not (0.0 <= threshold <= 1.0):
        return None
    return threshold


# %% CLI

def main(argv=None):

    parser = argparse.ArgumentParser(
        description='Real-time MegaDetector inference server '
                    '(dynamic micro-batching)')
    parser.add_argument('model_file',
                        help='converted detector checkpoint or known '
                             'model name (e.g. MDV5A)')
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--max_batch_size', type=int, default=8)
    parser.add_argument('--batch_wait_ms', type=float, default=15.0)
    parser.add_argument('--detection_threshold', type=float,
                        default=DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD)
    parser.add_argument('--max_queue_size', type=int, default=64)
    parser.add_argument('--force_cpu', action='store_true')
    parser.add_argument('--device', default=None,
                        help='cuda (default), cuda:N or cpu')
    parser.add_argument('--verbose', action='store_true')
    parser.add_argument('--detector_options', nargs='*', default=None,
                        metavar='KEY=VALUE')
    args = parser.parse_args(argv)

    options = ServingOptions()
    options.host = args.host
    options.port = args.port
    options.max_batch_size = args.max_batch_size
    options.batch_wait_ms = args.batch_wait_ms
    options.detection_threshold = args.detection_threshold
    options.max_queue_size = args.max_queue_size
    options.force_cpu = args.force_cpu
    options.device = args.device
    options.verbose = args.verbose
    if args.detector_options:
        options.detector_options = ct_utils.parse_kvp_list(
            args.detector_options)

    MDServer(args.model_file, options).serve_forever()


if __name__ == '__main__':
    main()
