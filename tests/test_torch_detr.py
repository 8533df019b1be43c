"""
The port's DETR (megadetector_tpu_torch/models/detr.py) against the JAX
package's, on the CPU, at the tiny preset (detr_tiny: dim 96, 2 encoder
and 2 decoder blocks, 32 queries) and 64 px:

- DetrConfig and init_params: the same presets and arrays from a seed;
- the 2-d sine position encoding in float32 and in bf16 (JAX computes it
  in the compute dtype), multi-head attention, the tanh GELU: float32 at
  rtol 1e-4 and atol 1e-4 * max|ref|;
- the whole forward, float32, on a non-square 64x96 canvas: rtol 1e-4;
- bf16: the dtype of every LayerNorm, dense layer and attention output,
  in call order, equal to JAX's (bf16 up to the first LayerNorm, float32
  after it), and the port's largest class-score and box error against JAX
  bf16 no larger than JAX bf16's own against JAX float32;
- a DETR .npz (model_type 'rfdetr' with a detr arch, as the JAX tests
  write it) through load_and_run_detector_batch against the JAX driver at
  the MD-JSON golden tolerances (conf 0.005, coord 0.001), host and device
  preprocessing (stride 16, the patch); augment=True raises ValueError.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from PIL import Image

from megadetector_tpu.detection import run_detector_batch as jax_batch
from megadetector_tpu.models import detr as jax_detr
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector, \
    run_detector_batch
from megadetector_tpu_torch.models import detr
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models.params import ParamTree

import torch_port_data as data
from test_torch_rfdetr import _record_dtypes

ARCH = 'detr_tiny'
IMAGE_SIZE = 64


def _close(got, ref):
    """The float32 bar: rtol 1e-4, atol 1e-4 * max|ref|."""

    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize('arch', ['detr_small', 'detr_base', 'detr_tiny'])
def test_config_and_init_match_jax(arch):
    ours = detr.DetrConfig(arch, 3, image_size=IMAGE_SIZE)
    ref = jax_detr.DetrConfig(arch, 3, image_size=IMAGE_SIZE)
    assert vars(ours) == vars(ref)
    if arch != ARCH:
        return
    flat_ours = jax.tree_util.tree_flatten_with_path(
        detr.init_params(ours, seed=4))[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(
        jax_detr.init_params(ref, seed=4))[0]
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_ours, flat_ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_sine_pos_embed_matches_jax(dtype):
    ref = jax_detr._sine_pos_embed(4, 6, 96, getattr(jnp, dtype))
    got = detr.sine_pos_embed(4, 6, 96, getattr(torch, dtype), 'cpu')
    assert str(ref.dtype) == str(got.dtype).split('.')[-1] == dtype
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        # One bf16 ulp (2^-8 relative) where the two sines round apart
        np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=2 ** -9)


def test_attention_and_gelu_match_jax():
    rng = np.random.RandomState(3)
    q = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    k = rng.normal(0, 1, (2, 9, 64)).astype(np.float32)
    v = rng.normal(0, 1, (2, 9, 64)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_detr._mha, static_argnums=3)(q, k, v, 4))
    got = detr._mha(*(torch.from_numpy(a) for a in (q, k, v)), 4).numpy()
    _close(got, ref)
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(x))
    got = detr._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # The tanh form: the erf form differs by up to ~5e-4
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - ref).max() > 1e-4


@pytest.fixture(scope='module')
def forward_case():
    """detr_tiny parameters, a uint8 64x96 batch of 2, and the JAX float32
    forward's (class logits, raw boxes)."""

    config = jax_detr.DetrConfig(ARCH, 3, image_size=IMAGE_SIZE)
    params = jax_detr.init_params(config, seed=0)
    u8 = np.random.RandomState(0).randint(0, 256, (2, 64, 96, 3),
                                          dtype=np.uint8)
    x = jnp.asarray(u8, jnp.float32) / jnp.float32(255.0)
    ref32 = [np.asarray(a) for a in jax.jit(functools.partial(
        jax_detr.apply, config, dtype=jnp.float32, decode=False))(
            params, x)]
    return config, params, u8, ref32


def _model(params, dtype=torch.float32):
    return detr.Detr(detr.DetrConfig(ARCH, 3, image_size=IMAGE_SIZE)) \
        .load_params(params).set_compute_dtype(dtype).eval()


def test_forward_float32_matches_jax(forward_case):
    config, params, u8, ref = forward_case
    model = _model(params)
    with torch.inference_mode():
        logits, boxes = model(torch.from_numpy(u8), decode=False)
        decoded = model(torch.from_numpy(u8))
    _close(logits.numpy(), ref[0])
    _close(boxes.numpy(), ref[1])
    assert decoded.shape == (2, config.num_queries, 8)
    assert np.array_equal(decoded[..., 4].numpy(), np.ones((2, 32)))
    cx = 1.0 / (1.0 + np.exp(-ref[1][..., 0])) * 96
    np.testing.assert_allclose(decoded[..., 0].numpy(), cx, rtol=1e-5,
                               atol=1e-4)


_RECORDED = {'layer_norm': '_ln', '_dense': '_dense', '_mha': '_mha'}


def test_bf16_dtypes_and_error_match_jax(forward_case, monkeypatch):
    config, params, u8, ref32 = forward_case
    x16 = jnp.asarray(u8).astype(jnp.bfloat16) / jnp.bfloat16(255.0)
    apply16 = functools.partial(jax_detr.apply, config, dtype=jnp.bfloat16,
                                decode=False)
    ref16 = [np.asarray(a, np.float32)
             for a in jax.jit(apply16)(params, x16)]

    jax_log, port_log = [], []
    _record_dtypes(monkeypatch, jax_detr, _RECORDED.values(), jax_log)
    # A new partial: eval_shape would reuse the jit's cached trace
    jax.eval_shape(functools.partial(apply16), params, x16)
    # The port's detr reads layer_norm from its own namespace
    _record_dtypes(monkeypatch, detr, _RECORDED, port_log)
    model = _model(params, torch.bfloat16)
    with torch.inference_mode():
        got = [t.float().numpy()
               for t in model(torch.from_numpy(u8), decode=False)]
    assert [(_RECORDED[n], d) for n, d in port_log] == jax_log
    assert jax_log[0] == ('_dense', 'bfloat16')
    assert jax_log[1] == ('_ln', 'float32')
    assert jax_log.count(('_dense', 'bfloat16')) == 1

    def sigmoid(a):
        return 1.0 / (1.0 + np.exp(-a))

    for name, g, r16, r32 in zip(('conf', 'boxes'), map(sigmoid, got),
                                 map(sigmoid, ref16), map(sigmoid, ref32)):
        own = np.abs(r16 - r32).max()
        err = np.abs(g - r16).max()
        assert 0 < own and err <= own, (name, err, own)


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_detr')
    folder = root / 'images'
    folder.mkdir()
    for i, img in enumerate(data.images()):
        Image.fromarray(img).save(str(folder / 'im{:02d}.png'.format(i)))
    model = str(root / 'detr.npz')
    config = jax_detr.DetrConfig(ARCH, 3, image_size=IMAGE_SIZE)
    save_checkpoint(jax_detr.init_params(config, seed=2), model, {
        'model_version_string': 'rf-detr-test', 'arch': ARCH,
        'model_type': 'rfdetr', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'],
        'image_size': IMAGE_SIZE})
    return root, str(folder), model


@pytest.mark.parametrize('preprocess_mode', ['host', 'device'])
def test_detector_matches_jax_driver(checkpoint, preprocess_mode):
    root, folder, model = checkpoint
    options = {'preprocess_mode': preprocess_mode}
    # A low threshold keeps several queries an image
    ours = run_detector_batch.load_and_run_detector_batch(
        model, folder, batch_size=4, quiet=True, device='cpu',
        confidence_threshold=0.05, detector_options=dict(options))
    ref = jax_batch.load_and_run_detector_batch(
        model, folder, batch_size=4, quiet=True, loader_workers=1,
        confidence_threshold=0.05,
        detector_options=dict(options, force_cpu=True, use_mesh='false'))
    ours_out, ref_out = (
        module.write_results_to_file(
            results, str(root / '{}_{}.json'.format(tag, preprocess_mode)),
            relative_path_base=folder, detector_file=model)
        for module, results, tag in ((run_detector_batch, ours, 'ours'),
                                     (jax_batch, ref, 'ref')))
    counts = [len(im['detections']) for im in ours_out['images']]
    assert counts == [len(im['detections']) for im in ref_out['images']]
    assert all(0 < n <= 32 for n in counts), counts
    result = md_tests.compare_results(ref_out, ours_out,
                                      data.golden_options())
    assert result['n_images_compared'] == len(data.SIZES)
    assert result['errors'] == [], result['errors'][:5]


def test_detector_dispatch_and_augment_refused(checkpoint):
    _, _, model = checkpoint
    detector = run_detector.load_detector(model, device='cpu')
    assert isinstance(detector.model, detr.Detr)
    assert detector.letterbox_stride == 16
    assert detector._fused_decode is False
    with pytest.raises(ValueError, match='augment'):
        detector.generate_detections_one_batch(data.images()[:1],
                                               augment=True)


def test_param_tree_holds_float32_and_refuses_other_leaves():
    params = jax_detr.init_params(
        jax_detr.DetrConfig(ARCH, 3, image_size=IMAGE_SIZE), seed=0)
    tree = ParamTree(params)
    assert sorted(name for name, _ in tree.named_children()) == sorted(
        k for k, v in params.items() if isinstance(v, dict))
    assert tree['enc']['b0']['qkv']['w'].dtype == torch.float32
    assert torch.equal(tree['queries'], torch.from_numpy(params['queries']))
    with pytest.raises(ValueError, match='float'):
        ParamTree({'w': np.zeros(3, np.int8)})
    with pytest.raises(ValueError, match='Detr parameter tree'):
        detr.Detr(detr.DetrConfig(ARCH, 3)).load_params({'w': params})
