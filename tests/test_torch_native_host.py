"""
The port's native host kernels (megadetector_tpu_torch/native/
letterbox_nms.cpp, a library of its own beside the JPEG loader's) against
numpy oracles, as tests/test_native.py holds the JAX package's: the
letterbox against the port's ops/boxes.letterbox(auto=False, scaleup=True)
to JAX's bar (mean |diff| < 1, p99 <= 4), greedy NMS against JAX's Python
oracle, the clustering against a Python statement of its grid-hash rule
(tests/torch_host_tools_data.cluster_rule, which phase 41 also uses).
Also: the port's source is JAX's from its first #include on, the library
builds without libjpeg under a hashed name in the build folder, processes
that build at once all load a whole library, and a missing g++ makes
is_available() False and the bindings raise. The JAX package's native
module is not called here: its build writes straight to its final path.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from megadetector_tpu_torch import native
from megadetector_tpu_torch.ops import boxes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tests'))
# The clustering rule in Python, shared with chip_smoke.py's phase 41
from torch_host_tools_data import cluster_rule  # noqa: E402

pytestmark = pytest.mark.skipif(not native.is_available(),
                                reason='g++ unavailable')


def nms_oracle(boxes_xyxy, scores, iou_thres):
    """tests/test_native.py's Python oracle: greedy suppression in
    descending score order, IoU = inter / max(union, 1e-9) > iou_thres."""

    n = len(scores)
    order = np.argsort(-scores, kind='stable')
    suppressed = np.zeros(n, bool)
    keep = []
    areas = (boxes_xyxy[:, 2] - boxes_xyxy[:, 0]) * \
        (boxes_xyxy[:, 3] - boxes_xyxy[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        ix0 = np.maximum(boxes_xyxy[:, 0], boxes_xyxy[i, 0])
        iy0 = np.maximum(boxes_xyxy[:, 1], boxes_xyxy[i, 1])
        ix1 = np.minimum(boxes_xyxy[:, 2], boxes_xyxy[i, 2])
        iy1 = np.minimum(boxes_xyxy[:, 3], boxes_xyxy[i, 3])
        inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
        iou = inter / np.maximum(areas + areas[i] - inter, 1e-9)
        suppressed |= iou > iou_thres
        suppressed[i] = True
    return keep


def test_source_is_the_jax_source():
    with open(os.path.join(REPO, 'megadetector_tpu', 'native',
                           'letterbox_nms.cpp')) as f:
        jax_src = f.read()
    with open(os.path.join(REPO, 'megadetector_tpu_torch', 'native',
                           'letterbox_nms.cpp')) as f:
        port_src = f.read()
    body = jax_src[jax_src.index('\n#include'):]
    assert port_src[port_src.index('\n#include'):] == body


def test_library_is_its_own_and_needs_no_libjpeg():
    path = native.host_library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith('libmdnative-')
    assert path != native.library_path()
    assert os.path.isfile(path)
    lib = native.load_host_library()
    assert native.load_host_library() is lib
    assert not hasattr(lib, 'decode_jpeg_letterbox_rect')
    ldd = subprocess.run(['ldd', path], capture_output=True, text=True)
    assert 'libjpeg' not in ldd.stdout


@pytest.mark.parametrize('shape', [(480, 640), (100, 50), (128, 128),
                                   (97, 131), (720, 1280), (33, 500)])
@pytest.mark.parametrize('canvas', [128, (128, 192), (256, 160)])
def test_letterbox_u8_matches_host_letterbox(shape, canvas):
    img = np.random.RandomState(sum(shape)).randint(
        0, 255, shape + (3,), dtype=np.uint8)
    ref, _, _ = boxes.letterbox(img, canvas, auto=False, scaleup=True)
    out = native.letterbox_u8(img, canvas)
    assert out.shape == ref.shape and out.dtype == np.uint8
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert np.mean(diff) < 1.0
    assert np.percentile(diff, 99) <= 4
    # The padding is the pad value exactly
    pad = native.letterbox_u8(np.zeros(shape + (3,), np.uint8), canvas,
                              pad_value=7)
    assert set(np.unique(pad)) <= {0, 7}


def test_nms_examples():
    b = np.array([[0, 0, 100, 100], [5, 5, 105, 105], [300, 300, 400, 400]],
                 dtype=np.float32)
    keep = native.nms_xyxy(b, np.array([0.9, 0.8, 0.7], np.float32), 0.45)
    assert keep.dtype == np.int32 and keep.tolist() == [0, 2]
    assert native.nms_xyxy(np.zeros((0, 4), np.float32),
                           np.zeros(0, np.float32), 0.5).tolist() == []


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('iou_thres', [0.3, 0.5, 0.65])
def test_nms_matches_python_oracle(seed, iou_thres):
    rng = np.random.RandomState(seed)
    n = 300
    xy = rng.uniform(0, 900, (n, 2)).astype(np.float32)
    wh = rng.uniform(20, 160, (n, 2)).astype(np.float32)
    b = np.concatenate([xy, xy + wh], axis=1)
    # distinct scores: std::sort's order is then the oracle's
    scores = rng.permutation(n).astype(np.float32) / n
    keep = native.nms_xyxy(b, scores, iou_thres)
    expected = nms_oracle(b, scores, iou_thres)
    assert keep.tolist() == expected
    assert np.all(np.diff(scores[keep]) < 0)


def test_cluster_boxes_examples():
    b = np.array([[0.40, 0.40, 0.10, 0.10], [0.401, 0.401, 0.10, 0.10],
                  [0.80, 0.80, 0.05, 0.05], [0.40, 0.40, 0.10, 0.10]],
                 dtype=np.float32)
    ids, n = native.cluster_boxes(b, np.array([1, 1, 1, 1]), 0.9)
    assert n == 2 and ids[0] == ids[1] == ids[3] != ids[2]
    ids, n = native.cluster_boxes(b, np.array([1, 2, 1, 1]), 0.9)
    assert n == 3
    ids, n = native.cluster_boxes(b, np.array([1, 2, 1, 1]), 0.9,
                                  category_agnostic=True)
    assert n == 2


@pytest.mark.parametrize('seed', range(3))
@pytest.mark.parametrize('agnostic', [False, True])
def test_cluster_boxes_matches_python_rule(seed, agnostic):
    rng = np.random.RandomState(seed)
    n = 400
    centers = rng.uniform(0, 0.9, (40, 2))
    pick = rng.randint(0, 40, n)
    xy = centers[pick] + rng.normal(0, 0.004, (n, 2))
    wh = rng.uniform(0.02, 0.2, (40, 2))[pick] * \
        rng.uniform(0.97, 1.03, (n, 2))
    b = np.clip(np.concatenate([xy, wh], axis=1), 0, 1).astype(np.float32)
    cats = rng.randint(0, 3, n).astype(np.int32)
    ids, n_clusters = native.cluster_boxes(b, cats, 0.8,
                                           category_agnostic=agnostic)
    want, n_want = cluster_rule(b, cats, 0.8, category_agnostic=agnostic)
    assert ids.tolist() == want and n_clusters == n_want
    assert n_clusters < 0.6 * n  # boxes did cluster


_RACE = """
import sys
from megadetector_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
native.load_host_library()
import numpy as np
print(native.nms_xyxy(np.array([[0, 0, 1, 1]], np.float32),
                      np.array([1.0], np.float32), 0.5).tolist(),
      native.host_library_path())
"""


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Processes that build at once (as xdist workers do) each write a
    temporary file and os.replace it: every one loads a whole library."""

    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    build = str(tmp_path / 'build')
    procs = [subprocess.Popen([sys.executable, '-c', _RACE, build],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = {o[0].strip() for o in outs}
    assert len(lines) == 1 and lines.pop().startswith('[0] ' + build)
    assert [f for f in os.listdir(build) if '.tmp' in f] == []


def test_bindings_refuse_misshapen_input():
    for call in (lambda: native.letterbox_u8(np.zeros((8, 8), np.uint8), 16),
                 lambda: native.letterbox_u8(np.zeros((8, 8, 3), np.uint8),
                                             0),
                 lambda: native.nms_xyxy(np.zeros((3, 5), np.float32),
                                         np.zeros(3, np.float32), 0.5),
                 lambda: native.nms_xyxy(np.zeros((3, 4), np.float32),
                                         np.zeros(2, np.float32), 0.5),
                 lambda: native.cluster_boxes(np.zeros((3, 4), np.float32),
                                              np.zeros(4), 0.5)):
        with pytest.raises(ValueError):
            call()


def test_missing_compiler_is_unavailable_and_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(native, '_host_lib', None)
    monkeypatch.setattr(native.shutil, 'which', lambda name: None)
    assert native.is_available() is False
    with pytest.raises(native.NativeLoaderError, match='g\\+\\+ not found'):
        native.nms_xyxy(np.zeros((1, 4), np.float32),
                        np.ones(1, np.float32), 0.5)
    assert os.listdir(str(tmp_path)) == []
