"""
The port's SpeciesClassifier (megadetector_tpu_torch/models/classifier.py)
against the JAX package's models/classifier.py on the CPU: options,
defaults and errors; preprocess_crop in both crop modes; extract_crop on
random and degenerate boxes; classify_batch with pad_to (float32 within
rtol 1e-4 at folded_stem off, the JAX default's folded stem at the golden
conf tolerance, bf16 no further from JAX's bf16 than that is from JAX's
float32); top_k; two batches in flight (dispatch 1, dispatch 2, fetch 1,
fetch 2) on a stand-in CUDA graph whose replays rewrite one static
output; the default device raising without a card.
"""

import numpy as np
import pytest
import torch

from megadetector_tpu.models import classifier as jclf
from megadetector_tpu.models import efficientnet as jeff
from megadetector_tpu.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models import classifier as tclf
from megadetector_tpu_torch.models import program_cache

NAMES = ['deer', 'fox', 'cow', 'other']


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    folder = tmp_path_factory.mktemp('classifier')
    cfg = jeff.EfficientNetConfig('efficientnetv2_test', num_classes=4)
    path = str(folder / 'classifier.npz')
    save_checkpoint(jeff.init_params(cfg, seed=3), path, {
        'arch': 'efficientnetv2_test', 'num_classes': 4,
        'class_names': NAMES, 'image_size': 64,
        'normalization_mean': [0.1, 0.2, 0.3],
        'normalization_std': [0.9, 1.1, 1.0]})
    return path


@pytest.fixture(scope='module')
def bare_ckpt(tmp_path_factory):
    """No metadata: every default from the classifier."""

    folder = tmp_path_factory.mktemp('bare')
    cfg = jeff.EfficientNetConfig('efficientnetv2_test', num_classes=3)
    path = str(folder / 'bare.npz')
    save_checkpoint(jeff.init_params(cfg, seed=1), path)
    return path


def _crops(seed, n=3, shape=(40, 30, 3)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, shape, dtype=np.uint8) for _ in range(n)]


def _port(path, options=None):
    return tclf.SpeciesClassifier(path, options, device='cpu')


def test_known_options_are_jax_s_plus_force_cpu():
    assert tclf.SpeciesClassifier.KNOWN_OPTIONS == \
        jclf.SpeciesClassifier.KNOWN_OPTIONS + ('force_cpu',)


@pytest.mark.parametrize('options,error', [
    ({'no_such_option': 1}, ValueError),
    ({'quantize': 'int4'}, ValueError),
    ({'folded_stem': 'bogus'}, ValueError),
    ({'dtype': 'float16'}, KeyError)])
def test_errors_as_jax(ckpt, options, error):
    with pytest.raises(error):
        jclf.SpeciesClassifier(ckpt, options)
    with pytest.raises(error):
        _port(ckpt, options)


@pytest.mark.parametrize('path_name,options', [
    ('ckpt', {}), ('ckpt', {'quantize': 'int8'}),
    ('ckpt', {'image_size': 48, 'crop_mode': 'pad', 'quantize': False}),
    ('bare_ckpt', {}), ('bare_ckpt', {'num_classes': 3, 'dtype': 'bf16'})])
def test_defaults_as_jax(request, path_name, options):
    path = request.getfixturevalue(path_name)
    j = jclf.SpeciesClassifier(path, options)
    t = _port(path, options)
    for name in ('image_size', 'class_names', 'crop_mode', 'quantize',
                 'calibration_headroom', 'metadata'):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(t.mean, j.mean)
    np.testing.assert_array_equal(t.std, j.std)
    assert vars(t.config) == vars(j.config)
    assert str(t.compute_dtype).split('.')[-1] == \
        np.dtype(j.compute_dtype).name
    assert t._calibrated == j._calibrated


def test_device_none_means_the_card(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tclf.SpeciesClassifier(ckpt)
    clf = tclf.SpeciesClassifier(ckpt, {'force_cpu': 'true'})
    assert clf.device.type == 'cpu'


@pytest.mark.parametrize('mode', ['stretch', 'pad'])
@pytest.mark.parametrize('shape', [(40, 30, 3), (17, 90, 3), (64, 64, 3),
                                   (200, 120, 3)])
def test_preprocess_crop_bit_identical(ckpt, mode, shape):
    crop = _crops(4, 1, shape)[0]
    j = jclf.SpeciesClassifier(ckpt, {'crop_mode': mode})
    t = _port(ckpt, {'crop_mode': mode})
    want = j.preprocess_crop(crop)
    got = t.preprocess_crop(crop)
    assert got.shape == (64, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_extract_crop_on_random_and_degenerate_boxes():
    rng = np.random.RandomState(8)
    img = rng.randint(0, 255, (90, 160, 3), dtype=np.uint8)
    boxes = [list(rng.uniform(-0.2, 1.0, 4)) for _ in range(200)]
    boxes += [[0.5, 0.5, 0.0, 0.0], [0.3, 0.2, 0.0, 0.4],
              [1.0, 1.0, 0.1, 0.1], [-0.5, -0.5, 0.2, 0.2],
              [0.0, 0.0, 1.0, 1.0], [0.2, 0.1, -0.1, 0.3]]
    for box in boxes:
        for expansion in (0.0, 0.15):
            for square in (False, True):
                want = jclf.extract_crop(img, box, expansion, square)
                got = tclf.extract_crop(img, box, expansion, square)
                assert got.shape == want.shape, box
                np.testing.assert_array_equal(got, want)


def test_classify_batch_pad_to_matches_jax_float32(ckpt):
    """At folded_stem off both run the same function up to float32 sum
    order: rtol 1e-4. pad_to serves every batch from one program."""

    crops = _crops(1)
    j = jclf.SpeciesClassifier(ckpt, {'folded_stem': 'off'})
    t = _port(ckpt, {'folded_stem': 'off'})
    want = j.classify_batch(crops, pad_to=8)
    got = t.classify_batch(crops, pad_to=8)
    assert got.shape == (3, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert list(t._programs.entries) == [('classify', 8, 64, 64, 3)]
    # the tail is the same program's rows
    s = t.image_size
    manual = t.classify_batch([t.preprocess_crop(c) for c in crops] +
                              [np.zeros((s, s, 3), np.uint8)] * 5)
    np.testing.assert_array_equal(got, manual[:3])
    assert list(t._programs.entries) == [('classify', 8, 64, 64, 3)]
    assert t.classify_batch(crops, pad_to=2).shape == (3, 4)


@pytest.mark.parametrize('fold', ['auto', 'w2', 'w4', 'off'])
def test_folded_stem_is_a_no_op_within_the_golden_tolerance(ckpt, fold):
    """The JAX default folds the stem (auto: w2 at even sizes); the port
    never does. Against JAX's folded programs: the golden conf tolerance.
    The port gives the same output for every value."""

    crops = _crops(2)
    want = jclf.SpeciesClassifier(ckpt, {'folded_stem': fold}) \
        .classify_batch(crops)
    got = _port(ckpt, {'folded_stem': fold}).classify_batch(crops)
    assert np.abs(got - want).max() <= 0.005
    np.testing.assert_array_equal(got, _port(ckpt).classify_batch(crops))


def test_bf16_no_further_from_jax_than_jax_bf16_from_float32(ckpt):
    crops = _crops(3, 4)
    j16 = jclf.SpeciesClassifier(ckpt, {'dtype': 'bfloat16'}) \
        .classify_batch(crops)
    j32 = jclf.SpeciesClassifier(ckpt, {'folded_stem': 'off'}) \
        .classify_batch(crops)
    got = _port(ckpt, {'dtype': 'bfloat16'}).classify_batch(crops)
    assert np.abs(got - j16).max() <= np.abs(j16 - j32).max()


def test_top_k_as_jax(ckpt):
    j = jclf.SpeciesClassifier(ckpt)
    t = _port(ckpt)
    rng = np.random.RandomState(0)
    for k in (1, 2, 4, 9):
        p = rng.dirichlet(np.ones(4)).astype(np.float32)
        p[1] = p[2]   # a tie: argsort order decides
        assert t.top_k(p, k=k) == j.top_k(p, k=k)


class _StandInGraph:
    """Replays like a CUDA graph: reruns the program into its one static
    output tensor."""

    def __init__(self, fn, inputs, output):
        self.fn, self.inputs, self.output = fn, inputs, output

    def replay(self):
        with torch.inference_mode():
            self.output.copy_(self.fn(*self.inputs))


class _StandInCapture:
    def capture(self, fn, inputs):
        output = fn(*inputs)
        return _StandInGraph(fn, inputs, output), output


def test_two_batches_in_flight_keep_their_own_results(ckpt):
    """dispatch 1, dispatch 2, fetch 1, fetch 2 equals serial calls, with
    every call after the first replaying into the same static output (as
    on the card): each handle holds its own copy."""

    t = _port(ckpt)
    t._programs = program_cache.ProgramCache('cpu',
                                             capturer=_StandInCapture())
    a, b = _crops(5, 4), _crops(6, 4)
    serial_a = t.classify_batch(a)
    serial_b = t.classify_batch(b)
    assert t._programs.replays == 1
    h1 = t.classify_batch_async(a)
    h2 = t.classify_batch_async(b)
    assert t._programs.replays == 3
    np.testing.assert_array_equal(t.fetch_batch(h1), serial_a)
    np.testing.assert_array_equal(t.fetch_batch(h2), serial_b)
    assert not np.array_equal(serial_a, serial_b)
    # and as JAX's sync and async calls agree
    j = jclf.SpeciesClassifier(ckpt, {'folded_stem': 'off'})
    np.testing.assert_allclose(serial_a, j.classify_batch(a), rtol=1e-4,
                               atol=1e-6)
    empty = t.fetch_batch(t.classify_batch_async([]))
    assert empty.shape == (0, 4) and empty.dtype == np.float32
