"""
The legacy TF1 frozen-graph detector (detection/tf_detector.py, MDv2-v4)
in the port, held to the JAX package's on tests/test_tf_detector.py's
synthetic graphs (skipped where tensorflow is absent, as that test is):
the same results for the same images, one at a time and in batches
(in-graph resize, the batch-1 contract, contained failures);
run_detector.load_detector dispatches .pb files to it on the CPU only
(the default, the card, raises), and refuses a .mdpkg that is not the
port's own artifact (a JAX one included); without
tensorflow the error names it.
"""

import os
import sys

import numpy as np
import pytest

pytest.importorskip('tensorflow')

from megadetector_tpu.detection.tf_detector import \
    TFDetector as JaxTFDetector  # noqa: E402
from megadetector_tpu_torch.detection import run_detector  # noqa: E402
from megadetector_tpu_torch.detection.tf_detector import \
    TFDetector  # noqa: E402

from test_tf_detector import realistic_pb, synthetic_pb  # noqa: E402,F401


def _images():
    rng = np.random.RandomState(0)
    return [np.full((80, 100, 3), 200, np.uint8),
            np.full((200, 40, 3), 20, np.uint8),
            rng.randint(0, 255, (31, 77, 3)).astype(np.uint8),
            rng.randint(0, 255, (512, 384, 3)).astype(np.uint8)]


@pytest.mark.parametrize('graph', ['synthetic_pb', 'realistic_pb'])
def test_results_identical_to_jax(graph, request):
    path = request.getfixturevalue(graph)
    ours = run_detector.load_detector(path, device='cpu')
    assert isinstance(ours, TFDetector)
    assert isinstance(run_detector.load_detector(path, force_cpu=True),
                      TFDetector)
    ref = JaxTFDetector(path)
    images = _images()
    ids = ['im{}.jpg'.format(i) for i in range(len(images))]
    for threshold in (0.005, 0.05, 0.5):
        for img, image_id in zip(images, ids):
            assert ours.generate_detections_one_image(
                img, image_id, detection_threshold=threshold) == \
                ref.generate_detections_one_image(
                    img, image_id, detection_threshold=threshold)
        assert ours.generate_detections_one_batch(
            images, ids, detection_threshold=threshold) == \
            ref.generate_detections_one_batch(
                images, ids, detection_threshold=threshold)
    info = ours.preprocess_image(images[0], 'a.jpg')
    want = ref.preprocess_image(images[0], 'a.jpg')
    assert sorted(info) == sorted(want) and info['file'] == 'a.jpg'
    assert ours.generate_detections_one_image(info, 'a.jpg') == \
        ref.generate_detections_one_image(want, 'a.jpg')
    assert (ours.BATCH_SIZE, ours.DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD) == \
        (ref.BATCH_SIZE, ref.DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD)


def test_failures_contained_as_in_jax(realistic_pb):
    ours, ref = TFDetector(realistic_pb), JaxTFDetector(realistic_pb)
    stacked = np.zeros((2, 60, 60, 3), np.uint8)  # batch 2 in the graph
    got = ours.generate_detections_one_image(stacked, 'bad.jpg')
    assert got == ref.generate_detections_one_image(stacked, 'bad.jpg')
    assert got['detections'] is None and got['failure'] == \
        'inference failure'


@pytest.mark.parametrize('device', [None, 'cuda', 'cuda:0'])
def test_pb_refused_off_the_cpu(synthetic_pb, device):
    """The default (the card) and any CUDA device are refused before
    tensorflow is touched: the graph would run on TF's CPU runtime
    instead of the card asked for."""

    with pytest.raises(ValueError, match="device='cpu'"):
        run_detector.load_detector(synthetic_pb, device=device)


def test_mdpkg_still_refused(tmp_path):
    """A .mdpkg that is not the port's artifact is refused with
    ValueError: an empty file, and a JAX artifact (format_version 1,
    StableHLO programs). The port's own artifacts load
    (tests/test_torch_export_detector.py)."""

    path = tmp_path / 'x.mdpkg'
    path.write_bytes(b'')
    with pytest.raises(ValueError, match='not a detector artifact'):
        run_detector.load_detector(str(path), device='cpu')
    jax_artifact = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'data', 'stub_golden_model.mdpkg')
    with pytest.raises(ValueError, match='JAX artifact'):
        run_detector.load_detector(jax_artifact, device='cpu')


def test_missing_tensorflow_is_named(synthetic_pb, monkeypatch):
    for name in ('tensorflow', 'tensorflow.compat', 'tensorflow.compat.v1'):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match='tensorflow is not installed'):
        run_detector.load_detector(synthetic_pb, device='cpu')
