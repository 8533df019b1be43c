"""
The detector's program cache (models/program_cache.py) on the CPU, where
every program runs eagerly, and on a stand-in graph object that captures
and replays as a CUDA graph would:

- the programs through the cache give the outputs of the network,
  selection and NMS called directly, fused and unfused, host and device
  preprocessing;
- capacity escalation reads n_candidates alone, and the full outputs once
  at the end;
- the launch-counter bookkeeping: a capture counts nothing, every replay
  adds the captured launches, a failed capture or replay raises
  KernelError and leaves the counters as they were;
- the keys: thresholds, staging shape, identity, augment; the forward's
  outputs are the tensors every replay of selection + NMS reads; the
  order c1, c2, c1 across two canvases gives the eager outputs.
"""

import numpy as np
import pytest
import torch

from megadetector_tpu_torch import device as port_device
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.models import program_cache
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models.program_cache import ProgramCache
from megadetector_tpu_torch.ops import conv_int8, cuda_nms
from megadetector_tpu_torch.ops._build import KernelError
from megadetector_tpu_torch.ops.decode import select_topk_candidates
from megadetector_tpu_torch.ops.nms import batched_nms, nms_on_candidates
from megadetector_tpu_torch.ops.preprocess_device import (letterbox_batch,
                                                          stage_images)

import torch_port_data as data


def _copy_into(static, new):
    if isinstance(static, dict):
        for k in static:
            static[k].copy_(new[k])
    else:
        for a, b in zip(static, new):
            a.copy_(b)


class StandInGraph:
    """Replays like a CUDA graph: reruns the program into its static
    outputs, and (as no wrapper's Python runs in a replay) leaves the
    launch counters as they were."""

    def __init__(self, fn, inputs, outputs, log):
        self.fn, self.inputs, self.outputs, self.log = fn, inputs, outputs, \
            log

    def replay(self):
        saved = program_cache.read_counters()
        with torch.inference_mode():
            _copy_into(self.outputs, self.fn(*self.inputs))
        program_cache._set_counters(saved)
        self.log.append('replay')


class StandInCapture:
    def __init__(self):
        self.log = []

    def capture(self, fn, inputs):
        self.log.append('capture')
        outputs = fn(*inputs)
        return StandInGraph(fn, inputs, outputs, self.log), outputs


@pytest.fixture(scope='module')
def model_path(tmp_path_factory):
    images = data.images()
    path = str(tmp_path_factory.mktemp('cache') / 'md_v5a.0.0_cache.npz')
    save_checkpoint(data.sharpened_params(images), path, data.METADATA)
    return path


def _batch(detector, images):
    infos = [detector.preprocess_image(im) for im in images]
    return np.stack([i['img_processed'] for i in infos])


def _direct(detector, x, conf, iou, capacity):
    """The network, selection and NMS called directly (the eager program
    as it was before the cache)."""

    config = detector.config
    with torch.inference_mode():
        if detector._fused_decode:
            heads = detector.model(x, decode=False)
            out = nms_on_candidates(select_topk_candidates(
                heads, config.anchors, config.strides, config.num_classes,
                conf, capacity), iou, max_det=detector.max_det)
        else:
            out = batched_nms(detector.model(x, decode=True), conf, iou,
                              max_det=detector.max_det,
                              pre_nms_topk=capacity)
    return {k: v.numpy() for k, v in out.items()}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize('fused', [True, False])
def test_cache_path_gives_the_direct_outputs(model_path, fused):
    detector = run_detector.load_detector(
        model_path, device='cpu', detector_options={
            'fused_decode': str(fused).lower(), 'canvas_mode': 'square',
            'auto_escalate_topk': 'false'})
    batch = _batch(detector, data.images()[:3])
    for conf in (0.005, 0.3):
        out, topk = detector.run_program(batch, conf, 0.45)
        assert topk == 512
        _assert_same(out, _direct(detector, torch.from_numpy(batch), conf,
                                  0.45, 512))
    assert detector._programs.captures == 0


def test_device_preprocess_program_gives_the_direct_outputs(model_path):
    detector = run_detector.load_detector(
        model_path, device='cpu', detector_options={
            'preprocess_mode': 'device', 'auto_escalate_topk': 'false'})
    images = data.images()[:4]
    staged, sizes = stage_images(images, multiple=64)
    out, _ = detector.run_program_staged(staged, sizes, (192, 256), 256,
                                         False, 0.005, 0.45)
    with torch.inference_mode():
        x = letterbox_batch(torch.from_numpy(staged),
                            torch.from_numpy(sizes), (192, 256),
                            scale_target=256)
    _assert_same(out, _direct(detector, x, 0.005, 0.45, 512))
    # The staging shape and identity are part of the key
    keys = [k for k in detector._programs.entries
            if k[0] == 'device_preprocess' and 'select' not in k]
    assert keys == [('device_preprocess', 4) + staged.shape[1:] +
                    (192, 256, 256, False, True)]


def test_escalation_reads_n_candidates_alone(model_path, monkeypatch):
    """Random-init yolov5n puts thousands of candidates above the 0.005
    floor: the program escalates once, to the capacity that holds them,
    reading n_candidates alone before it and every output once after."""

    from megadetector_tpu_torch.models import yolov5

    config = yolov5.YoloV5Config('yolov5n', 3)
    path = model_path.replace('.npz', '_random.npz')
    save_checkpoint(yolov5.init_params(config, seed=0), path, data.METADATA)
    detector = run_detector.load_detector(path, device='cpu',
                                          detector_options={
                                              'canvas_mode': 'square'})
    batch = _batch(detector, data.images()[:2])
    reads = []
    real = detector._read_host
    monkeypatch.setattr(detector, '_read_host',
                        lambda t: reads.append(tuple(t.shape)) or real(t))

    out, topk = detector.run_program(batch, 0.005, 0.45)
    needed = int(out['n_candidates'].max())
    assert 512 < needed <= topk <= 8192 and topk // 2 < needed
    assert reads == [(2,)]
    assert detector.host_reads == 2
    _assert_same(out, _direct(detector, torch.from_numpy(batch), 0.005,
                              0.45, topk))
    keys = sorted(k[-3] for k in detector._programs.entries
                  if 'select' in k)
    assert keys == [512, topk]

    # No escalation wanted: one read, the final one
    detector.auto_escalate_topk = False
    detector.host_reads = 0
    detector.run_program(batch, 0.005, 0.45)
    assert detector.host_reads == 1 and len(reads) == 1


def _counting_program(x):
    """A program that 'launches' one NMS kernel and two conv kernels."""

    cuda_nms.launches += 1
    conv_int8.launches += 2
    return (x * 2.0 + 1.0,)


def test_launch_counters_under_capture_and_replay():
    capturer = StandInCapture()
    cache = ProgramCache('cpu', capturer=capturer)
    before = program_cache.read_counters()
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    outs = []
    for i in range(4):
        out, replayed = cache.run(('k',), _counting_program,
                                  host_inputs=(x + i,))
        outs.append((out[0].clone(), replayed))
    # Eager, capture + replay, replay, replay
    assert [r for _, r in outs] == [False, True, True, True]
    assert capturer.log == ['capture', 'replay', 'replay', 'replay']
    for i, (out, _) in enumerate(outs):
        assert torch.equal(out, torch.from_numpy((x + i) * 2.0 + 1.0))
    after = program_cache.read_counters()
    delta = dict(zip(program_cache.LAUNCH_COUNTERS,
                     [a - b for a, b in zip(after, before)]))
    assert delta[(cuda_nms, 'launches')] == 4
    assert delta[(conv_int8, 'launches')] == 8
    assert sum(delta.values()) == 12
    assert cache.captures == 1 and cache.replays == 3
    assert cache.entries[('k',)].delta[1] == 2


def test_no_capture_without_graphs_or_static_inputs():
    capturer = StandInCapture()
    cache = ProgramCache('cpu', capturer=capturer)
    x = np.ones((2, 2), np.float32)
    for _ in range(3):
        assert not cache.run(('eager',), _counting_program,
                             host_inputs=(x,), graphs=False)[1]
        assert not cache.run(('dynamic',), _counting_program,
                             host_inputs=(x,), capture=False)[1]
    assert capturer.log == []
    # The CPU has no capturer: eager always
    assert ProgramCache('cpu').capturer is None


def test_failed_capture_and_replay_raise_kernel_error():
    class FailingCapture:
        def capture(self, fn, inputs):
            fn(*inputs)
            raise RuntimeError('operation not permitted when stream is '
                               'capturing')

    cache = ProgramCache('cpu', capturer=FailingCapture())
    x = np.ones((2, 2), np.float32)
    cache.run(('k',), _counting_program, host_inputs=(x,))
    before = program_cache.read_counters()
    with pytest.raises(KernelError, match='capture'):
        cache.run(('k',), _counting_program, host_inputs=(x,))
    assert program_cache.read_counters() == before

    class BrokenGraph:
        def replay(self):
            raise RuntimeError('replay failed')

    class BrokenCapture:
        def capture(self, fn, inputs):
            return BrokenGraph(), fn(*inputs)

    cache = ProgramCache('cpu', capturer=BrokenCapture())
    cache.run(('k',), _counting_program, host_inputs=(x,))
    with pytest.raises(KernelError, match='replay'):
        cache.run(('k',), _counting_program, host_inputs=(x,))


def test_replay_refuses_other_device_inputs():
    cache = ProgramCache('cpu', capturer=StandInCapture())
    a, b = torch.ones(3), torch.zeros(3)
    for _ in range(2):
        cache.run(('k',), lambda t: (t + 1,), device_inputs=(a,))
    assert cache.run(('k',), lambda t: (t + 1,), device_inputs=(a,))[1]
    with pytest.raises(KernelError, match='captured with'):
        cache.run(('k',), lambda t: (t + 1,), device_inputs=(b,))


def _stand_in_detector(path, **options):
    detector = run_detector.load_detector(path, device='cpu',
                                          detector_options=options)
    capturer = StandInCapture()
    detector._programs = ProgramCache('cpu', capturer=capturer)
    detector._cuda_graphs = True
    return detector, capturer


@pytest.mark.parametrize('options', [
    {}, {'fused_decode': 'false'}, {'auto_escalate_topk': 'false'}])
def test_replayed_detector_programs_equal_eager_in_any_order(model_path,
                                                             options):
    """c1, c2, c1 (two canvases), three calls each: eager, capture and
    replay, replay; every output equals the eager program's."""

    eager = run_detector.load_detector(model_path, device='cpu',
                                       detector_options=options)
    detector, capturer = _stand_in_detector(model_path, **options)
    images = data.images()
    c1 = _batch(eager, images[:2])
    c2 = _batch(eager, images[4:6])
    assert c1.shape != c2.shape
    want = {1: eager.run_program(c1, 0.005, 0.45),
            2: eager.run_program(c2, 0.005, 0.45)}
    for canvas in (1, 2, 1, 1, 2, 2):
        out, topk = detector.run_program(c1 if canvas == 1 else c2, 0.005,
                                         0.45)
        assert topk == want[canvas][1]
        _assert_same(out, want[canvas][0])
    assert 'capture' in capturer.log and 'replay' in capturer.log
    # Each key captured once
    n_keys = len(detector._programs.entries)
    assert detector._programs.captures == n_keys
    assert detector.programs_run == 6


def test_keys_take_thresholds_augment_and_the_canvas(model_path):
    detector, capturer = _stand_in_detector(model_path)
    batch = _batch(detector, data.images()[:2])
    _, h, w, _ = batch.shape
    eager = run_detector.load_detector(model_path, device='cpu')
    for conf, iou in ((0.005, 0.45), (0.005, 0.45), (0.1, 0.45),
                      (0.1, 0.45), (0.1, 0.6)):
        out, _ = detector.run_program(batch, conf, iou)
        _assert_same(out, eager.run_program(batch, conf, iou)[0])
    for _ in range(3):
        out, _ = detector.run_program(batch, 0.005, 0.45, augment=True)
        _assert_same(out, eager.run_program(batch, 0.005, 0.45,
                                            augment=True)[0])
    keys = set(detector._programs.entries)
    assert ('forward', 2, h, w, True) in keys
    selects = sorted(k[-2:] for k in keys if 'select' in k)
    assert selects == [(0.005, 0.45), (0.1, 0.45), (0.1, 0.6)]
    assert ('augment', 2, h, w, True, 0.005, 0.45) in keys
    # A new threshold captured a new graph on its second call
    entries = detector._programs.entries
    assert entries[('forward', 2, h, w, True, 'select', 512, 0.1,
                    0.45)].graph is not None
    assert entries[('forward', 2, h, w, True, 'select', 512, 0.1,
                    0.6)].graph is None
    assert entries[('augment', 2, h, w, True, 0.005, 0.45)].graph \
        is not None


def test_device_constant_is_made_once():
    a = port_device.device_constant([[1.5, 2.0]], torch.float32, 'cpu')
    b = port_device.device_constant(np.array([[1.5, 2.0]]), torch.float32,
                                    torch.device('cpu'))
    c = port_device.device_constant([[1.5, 2.0]], torch.int64, 'cpu')
    assert a is b and a is not c
    assert a.dtype == torch.float32 and c.dtype == torch.int64
    assert torch.equal(a, torch.tensor([[1.5, 2.0]]))
