"""
The port's serving daemon and client (megadetector_tpu_torch/serving/) on
the CPU:

- the ten cases of tests/test_serving.py against the port's server
  (dynamic micro-batching, MD-format responses, failure containment,
  metrics, the client folder round trip through the port's writer);
- its responses equal to the JAX MDServer's, both in this process on the
  same images and model, at the golden tolerances;
- one program-cache key per canvas under partial batches
  (pad_batches_to = max_batch_size);
- the two places where it differs from the JAX server: one card (use_mesh
  taken and without effect, the card named where several are visible) and
  device faults (a KernelError in run_program: HTTP 500 naming it,
  /healthz 503, serve_forever re-raising; the JAX server would have
  served 'inference failure' records).
"""

import io
import json
import threading

import numpy as np
import pytest

from PIL import Image

import torch

from megadetector_tpu.models import yolov5
from megadetector_tpu.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.ops._build import KernelError
from megadetector_tpu_torch.serving import MDServer, ServingOptions
from megadetector_tpu_torch.serving import client as md_client
from megadetector_tpu_torch.serving import server as server_module


def _jpeg_bytes(seed=0, size=(72, 56)):
    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 255, (size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='JPEG')
    return buf.getvalue()


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    folder = tmp_path_factory.mktemp('serving_model')
    cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
    params = yolov5.init_params(cfg, seed=11)
    path = str(folder / 'md_serving_test.npz')
    save_checkpoint(params, path, {
        'metadata_format_version': 1.0,
        'model_version_string': 'v5a.0.1-serving-test',
        'arch': 'yolov5n',
        'model_type': 'yolov5',
        'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'],
        'image_size': 64,
        'strides': [8, 16, 32],
        'anchors': cfg.anchors.tolist(),
    })
    return path


@pytest.fixture(scope='module')
def server(checkpoint):
    options = ServingOptions()
    options.port = 0
    options.max_batch_size = 4
    options.batch_wait_ms = 5.0
    options.force_cpu = True
    server = MDServer(checkpoint, options)
    server.start()
    yield server
    server.shutdown()


@pytest.fixture(scope='module')
def url(server):
    return 'http://127.0.0.1:{}'.format(server.port)


def test_health_and_model_info(url):
    health = md_client.server_health(url)
    assert health['status'] == 'ok'
    assert health['model_version'] == 'v5a.0.1-serving-test'
    info = md_client._get_json(url, '/v1/model')
    assert info['detection_categories'] == \
        {'1': 'animal', '2': 'person', '3': 'vehicle'}
    assert info['image_size'] == 64


def test_single_detect(url):
    record = md_client.detect_image_bytes(
        url, _jpeg_bytes(seed=1), image_id='cam1/img1.jpg')
    assert record['file'] == 'cam1/img1.jpg'
    assert isinstance(record['detections'], list)
    for det in record['detections']:
        assert set(det) >= {'category', 'conf', 'bbox'}
        assert det['conf'] >= 0.005
        assert len(det['bbox']) == 4


def test_corrupt_image_failure_record(url):
    record = md_client.detect_image_bytes(
        url, b'not actually a jpeg', image_id='broken.jpg')
    assert record['detections'] is None
    assert record['failure'] == 'image access failure'


def test_batch_endpoint_and_order(url):
    pairs = [('a.jpg', _jpeg_bytes(seed=2)),
             ('b.jpg', b'garbage'),
             ('c.jpg', _jpeg_bytes(seed=3))]
    envelope = md_client.detect_images(url, pairs)
    files = [r['file'] for r in envelope['images']]
    assert files == ['a.jpg', 'b.jpg', 'c.jpg']
    assert envelope['images'][1]['failure'] == 'image access failure'
    assert envelope['images'][0]['detections'] is not None
    assert envelope['detection_categories']['1'] == 'animal'


def test_threshold_filtering(url):
    raw = _jpeg_bytes(seed=4)
    low = md_client.detect_image_bytes(url, raw, detection_threshold=0.005)
    high = md_client.detect_image_bytes(url, raw, detection_threshold=1.0)
    assert high['detections'] == []
    assert high['max_detection_conf'] == 0.0
    assert len(low['detections']) >= len(high['detections'])


def test_concurrent_requests_batch_together(url, server):
    """Many parallel requests should coalesce into shared device batches."""

    batches_before = server.metrics.snapshot()['batches_total']
    n_requests = 8
    results = [None] * n_requests
    errors = []

    def _worker(i):
        try:
            results[i] = md_client.detect_image_bytes(
                url, _jpeg_bytes(seed=10 + i),
                image_id='thread_{}.jpg'.format(i))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=_worker, args=(i,))
               for i in range(n_requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors
    assert all(r is not None and r['detections'] is not None
               for r in results)
    snapshot = server.metrics.snapshot()
    new_batches = snapshot['batches_total'] - batches_before
    # 8 images in <8 batches proves at least one shared batch
    assert 1 <= new_batches < n_requests


def test_metrics_counters(url, server):
    md_client.detect_image_bytes(url, _jpeg_bytes(seed=20))
    snapshot = md_client.server_metrics(url)
    assert snapshot['images_total'] >= 1
    assert snapshot['failures_total'] >= 1  # from the corrupt-image test
    assert snapshot['latency_p50_s'] is not None
    assert snapshot['images_per_second'] > 0


def test_unknown_path_404(url):
    with pytest.raises(RuntimeError, match='404'):
        md_client._post_json(url, '/v1/nope', {})


def test_bad_threshold_400(url):
    with pytest.raises(RuntimeError, match='400'):
        md_client._post_json(url, '/v1/detect_batch', {
            'images': [{'id': 'x', 'data': ''}],
            'detection_threshold': 'high'})


def test_client_folder_round_trip(url, tmp_path):
    folder = tmp_path / 'images'
    folder.mkdir()
    for i in range(3):
        (folder / 'img_{}.jpg'.format(i)).write_bytes(
            _jpeg_bytes(seed=30 + i))
    (folder / 'bad.jpg').write_bytes(b'junk')
    output_file = str(tmp_path / 'results.json')

    results = md_client.detect_folder(
        url, image_folder=str(folder), output_file=output_file,
        chunk_size=2, quiet=True)
    assert len(results['images']) == 4

    with open(output_file) as f:
        written = json.load(f)
    assert written['info']['format_version']
    files = [r['file'] for r in written['images']]
    assert files == sorted(files)
    failed = [r for r in written['images'] if r['detections'] is None]
    assert len(failed) == 1 and failed[0]['failure']

    # The standard validators (the port's and the JAX package's) accept
    # the client-written file
    from megadetector_tpu.postprocessing.validate_batch_results import \
        validate_batch_results
    from megadetector_tpu_torch.postprocessing import \
        validate_batch_results as port_validate
    validation = validate_batch_results(output_file)
    assert validation['validation_results']['validation_errors'] == []
    validation = port_validate.validate_batch_results(output_file)
    assert validation['validation_results']['validation_errors'] == []


#%% Against the JAX server, program keys, one card, device faults


def test_responses_equal_the_jax_server(checkpoint, url):
    import torch_port_data as data
    from megadetector_tpu.serving import MDServer as JaxServer
    from megadetector_tpu.serving import ServingOptions as JaxOptions
    from megadetector_tpu.utils import md_tests

    options = JaxOptions()
    options.port = 0
    options.max_batch_size = 4
    options.batch_wait_ms = 5.0
    options.force_cpu = True
    pairs = [('img_{}.jpg'.format(i), _jpeg_bytes(seed=40 + i,
                                                  size=(72 + 8 * i, 56)))
             for i in range(5)] + [('bad.jpg', b'junk')]
    with JaxServer(checkpoint, options) as jax_server:
        jax_url = 'http://127.0.0.1:{}'.format(jax_server.port)
        ref = md_client.detect_images(jax_url, pairs)
    ours = md_client.detect_images(url, pairs)
    assert ours['detection_categories'] == ref['detection_categories']
    assert [r['file'] for r in ours['images']] == \
        [r['file'] for r in ref['images']]
    assert ours['images'][-1] == ref['images'][-1]
    result = md_tests.compare_results(
        {'images': ref['images'][:-1]}, {'images': ours['images'][:-1]},
        data.golden_options())
    assert result['errors'] == [], result['errors']
    assert result['n_images_compared'] == 5


def test_one_program_key_per_canvas_under_partial_batches(server, url):
    programs = server.detector._programs
    keys_before = set(programs.entries)
    for n in (1, 3, 2):
        envelope = md_client.detect_images(
            url, [('p{}.jpg'.format(i), _jpeg_bytes(seed=60 + i))
                  for i in range(n)])
        assert all(r['detections'] is not None
                   for r in envelope['images'])
    # every image has the same canvas: one forward key, at the padded
    # serving capacity, whatever the batch's fill
    def is_forward(key):
        return key[0] == 'forward' and 'select' not in key

    new = [k for k in set(programs.entries) - keys_before if is_forward(k)]
    assert len(new) <= 1
    forwards = [k for k in programs.entries if is_forward(k)]
    assert forwards and all(k[1] == 4 for k in forwards)
    canvases = [k[2:4] for k in forwards]
    assert len(canvases) == len(set(canvases)), forwards


def test_use_mesh_is_taken_and_one_card_named(checkpoint, monkeypatch,
                                              capsys):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    options = ServingOptions()
    options.port = 0
    options.force_cpu = True
    options.detector_options = {'use_mesh': 'true'}
    server = MDServer(checkpoint, options)
    try:
        assert server.detector.device.type == 'cpu'
        assert server.detector.pad_batches_to == options.max_batch_size
    finally:
        server.shutdown()
    out = capsys.readouterr().out
    assert '2 CUDA devices visible; serving on cpu only' in out


def _get(url, path):
    from urllib.error import HTTPError
    from urllib.request import urlopen
    try:
        with urlopen(url + path, timeout=60) as response:
            return response.status, json.loads(response.read())
    except HTTPError as e:
        return e.code, json.loads(e.read())


def test_device_fault_is_never_served_as_a_failure_record(checkpoint,
                                                          monkeypatch):
    options = ServingOptions()
    options.port = 0
    options.max_batch_size = 4
    options.batch_wait_ms = 5.0
    options.force_cpu = True
    monkeypatch.setattr(server_module, 'FAULT_LINGER_S', 60.0)
    server = MDServer(checkpoint, options)

    def broken(*args, **kwargs):
        raise KernelError('md_silu_bf16 launch failed: injected')

    monkeypatch.setattr(server.detector, 'run_program', broken)
    raised = []

    def serve():
        try:
            server.serve_forever()
        except Exception as e:
            raised.append(e)

    thread = threading.Thread(target=serve)
    thread.start()
    try:
        url = 'http://127.0.0.1:{}'.format(server.port)
        for _ in range(200):
            if server._serve_thread is not None:
                break
            threading.Event().wait(0.01)
        assert _get(url, '/healthz')[0] == 200
        with pytest.raises(RuntimeError, match='500.*KernelError.*injected'):
            md_client.detect_image_bytes(url, _jpeg_bytes(seed=70))
        # later requests: 500 with the fault, no device work
        with pytest.raises(RuntimeError, match='500.*device fault'):
            md_client.detect_images(url, [('a.jpg', _jpeg_bytes(seed=71))])
        code, health = _get(url, '/healthz')
        assert code == 503 and health['status'] == 'fault'
        assert 'KernelError' in health['error']
        assert not server.batcher.is_alive()
        assert server.metrics.snapshot()['failures_total'] == 0
    finally:
        server.shutdown()
        thread.join(timeout=60)
    assert len(raised) == 1 and isinstance(raised[0], KernelError)


def test_data_errors_are_still_contained(checkpoint, monkeypatch):
    """A failure that is not the device's becomes 'inference failure'
    records, as in the JAX server, and serving goes on."""

    options = ServingOptions()
    options.port = 0
    options.force_cpu = True
    with MDServer(checkpoint, options) as server:
        url = 'http://127.0.0.1:{}'.format(server.port)
        calls = []
        real = server.detector.generate_detections_one_batch

        def flaky(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                raise ValueError('a malformed batch')
            return real(*args, **kwargs)

        monkeypatch.setattr(server.detector, 'generate_detections_one_batch',
                            flaky)
        record = md_client.detect_image_bytes(url, _jpeg_bytes(seed=80))
        assert record['failure'] == 'inference failure'
        record = md_client.detect_image_bytes(url, _jpeg_bytes(seed=81))
        assert record['detections'] is not None
        assert md_client.server_health(url)['status'] == 'ok'
