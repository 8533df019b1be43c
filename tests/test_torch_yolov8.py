"""
The port's anchor-free YOLOv8 family (megadetector_tpu_torch/models/
yolov8.py, the MDv1000 architecture) against the JAX package's, on the
CPU, at small sizes (yolov8n at 64-128 px):

- YoloV8Config and init_params: the same layers and, from a seed, the
  same arrays; the activated-conv count the card's launch check uses;
- each module: C2f (both shortcut forms; the channel split on dim 1 where
  JAX splits the last axis), the DFL decode, the whole forward (decoded
  and raw heads), float32 at rtol 1e-4 and atol 1e-4 * max|ref|;
- bf16: the heads' dtypes equal JAX's (bf16 heads, float32 decode), and
  the port's largest and mean error against JAX bf16 no larger than JAX
  bf16's own against JAX float32 (the bf16 bar of the yolov5 port); l0 is
  a plain conv (never the fused 6x6 stem) and the bias + SiLU epilogue
  runs once per activated conv;
- convert_ultralytics_state_dict on an ultralytics-layout state dict
  (tests/torch_yolo8_ref.make_torch_v8): bit-identical to JAX's;
- the detector through load_and_run_detector_batch against the JAX driver
  at the MD-JSON golden tolerances (conf 0.005, coord 0.001): float32 host
  and device preprocessing (stride 32); augment=True and bf16 on one
  canvas's batch against the JAX detector (augment at the same
  tolerances, bf16 IoU-matched no further from JAX bf16 than JAX bf16 is
  from JAX float32).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from PIL import Image

from megadetector_tpu.detection import run_detector_batch as jax_batch
from megadetector_tpu.models import yolov8 as jax_yolov8
from megadetector_tpu.models.detector import TPUDetector
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector, \
    run_detector_batch
from megadetector_tpu_torch.models import yolov5, yolov8
from megadetector_tpu_torch.models.convert_weights import save_checkpoint

import torch_port_data as data
from test_torch_bf16 import _distance

ARCH = 'yolov8n'
IMAGE_SIZE = 128
METADATA = {'arch': ARCH, 'model_type': 'ultralytics', 'num_classes': 3,
            'class_names': ['animal', 'person', 'vehicle'],
            'image_size': IMAGE_SIZE}


def _close(got, ref):
    """The float32 forward bar: rtol 1e-4, atol 1e-4 * max|ref|."""

    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def _model(params, dtype=torch.float32):
    return yolov8.YoloV8(yolov8.YoloV8Config(ARCH, 3)).load_params(
        params).set_compute_dtype(dtype).eval()


@pytest.mark.parametrize('arch', ['yolov8n', 'yolov8s', 'yolov8l'])
def test_config_matches_jax(arch):
    ours = yolov8.YoloV8Config(arch, num_classes=3)
    ref = jax_yolov8.YoloV8Config(arch, num_classes=3)
    assert ours.layers == ref.layers
    assert ours.save_indices == ref.save_indices
    assert (ours.head_c2, ours.head_c3, ours.strides, ours.max_stride,
            ours.reg_max) == (ref.head_c2, ref.head_c3, ref.strides,
                              ref.max_stride, ref.reg_max)
    with torch.device('meta'):
        model = yolov8.YoloV8(ours)
    assert yolov8.activated_conv_count(ours) == sum(
        1 for m in model.modules() if type(m) is yolov5.Conv and m.act)


def test_init_params_match_jax():
    ours = yolov8.init_params(yolov8.YoloV8Config(ARCH, 3), seed=3)
    ref = jax_yolov8.init_params(jax_yolov8.YoloV8Config(ARCH, 3), seed=3)
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_ours, flat_ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


@pytest.mark.parametrize('shortcut', [True, False])
def test_c2f_matches_jax(shortcut):
    rng = np.random.RandomState(1)
    c_in, c_out, n = 24, 32, 2
    node = {'cv1': jax_yolov8._conv_slot(rng, c_in, c_out, 1),
            'cv2': jax_yolov8._conv_slot(rng, (2 + n) * (c_out // 2),
                                         c_out, 1)}
    for j in range(n):
        node['m{}'.format(j)] = {
            'cv1': jax_yolov8._conv_slot(rng, c_out // 2, c_out // 2, 3),
            'cv2': jax_yolov8._conv_slot(rng, c_out // 2, c_out // 2, 3)}
    x = rng.uniform(-1, 1, (2, 12, 16, c_in)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_yolov8._c2f, static_argnums=(2, 3))(
        node, x, n, shortcut))

    module = yolov8.C2f(c_in, c_out, n, shortcut)
    holder = torch.nn.Module()
    holder.layers = torch.nn.ModuleDict({'c2f': module})
    yolov5.load_conv_params(holder, {'c2f': node})
    with torch.inference_mode():
        got = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), ref)


def test_dfl_decode_matches_jax():
    rng = np.random.RandomState(2)
    box = rng.normal(0, 3, (2, 6, 10, 4 * 16)).astype(np.float32)
    cls = rng.normal(0, 3, (2, 6, 10, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(
        jax_yolov8._decode_level_v8, stride=16.0, reg_max=16,
        out_dtype=jnp.float32))(box, cls))
    got = yolov8.decode_level_v8(torch.from_numpy(box),
                                 torch.from_numpy(cls), 16.0, 16).numpy()
    assert got.shape == ref.shape == (2, 60, 8)
    assert np.array_equal(got[..., 4], np.ones((2, 60), np.float32))
    # Boxes to 1e-4 px + 1e-6 relative, scores to 1e-6 (torch's and XLA's
    # float32 exp and sigmoid differ by an ulp)
    np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(got[..., 5:], ref[..., 5:], rtol=0,
                               atol=1e-6)


@pytest.fixture(scope='module')
def forward_refs():
    """(params, uint8 batch, JAX bf16 and float32 decoded outputs and raw
    heads) for yolov8n on a 96x128 batch of 2: one jitted program per
    dtype, the decode the JAX apply's own tail on its raw heads."""

    config = jax_yolov8.YoloV8Config(ARCH, num_classes=3)
    params = jax_yolov8.init_params(config, seed=0)
    u8 = np.random.RandomState(0).randint(0, 256, (2, 96, 128, 3),
                                          dtype=np.uint8)
    out = {}
    for name, dtype in (('f32', jnp.float32), ('bf16', jnp.bfloat16)):

        def heads_and_decoded(p, x, dtype=dtype):
            heads = jax_yolov8.apply(config, p, x, dtype=dtype, decode=False)
            return heads, jnp.concatenate([
                jax_yolov8._decode_level_v8(box, cls, float(stride),
                                            config.reg_max, jnp.float32)
                for (box, cls), stride in zip(heads, config.strides)], axis=1)

        x = jnp.asarray(u8).astype(dtype) / dtype(255.0)
        heads, decoded = jax.jit(heads_and_decoded)(params, x)
        out[name] = np.asarray(decoded)
        out[name + '_heads'] = [(np.asarray(b.astype(jnp.float32)),
                                 np.asarray(c.astype(jnp.float32)), b.dtype,
                                 c.dtype) for b, c in heads]
    return params, u8, out


def test_forward_float32_matches_jax(forward_refs):
    params, u8, ref = forward_refs
    model = _model(params)
    with torch.inference_mode():
        got = model(torch.from_numpy(u8))
        heads = model(torch.from_numpy(u8), decode=False)
    assert got.dtype == torch.float32 and got.shape == (2, 252, 8)
    _close(got.numpy(), ref['f32'])
    for (box, cls), (rbox, rcls, _, _) in zip(heads, ref['f32_heads']):
        _close(box.numpy(), rbox)
        _close(cls.numpy(), rcls)


def test_bf16_forward_matches_jax(forward_refs, monkeypatch):
    params, u8, ref = forward_refs
    model = _model(params, torch.bfloat16)
    calls = []
    silu = yolov5.silu_bf16
    monkeypatch.setattr(yolov5, 'silu_bf16',
                        lambda *a, **k: calls.append(1) or silu(*a, **k))

    def no_stem(*args, **kwargs):
        raise AssertionError('yolov8 must not run the fused 6x6 stem')

    monkeypatch.setattr(yolov5.l0_fused, 'l0_fused', no_stem)
    with torch.inference_mode():
        got = model(torch.from_numpy(u8))
        assert len(calls) == yolov8.activated_conv_count(model.config)
        heads = model(torch.from_numpy(u8), decode=False)
    assert got.dtype == torch.float32
    for (box, cls), (_, _, box_dtype, cls_dtype) in zip(
            heads, ref['bf16_heads']):
        assert str(box.dtype).split('.')[-1] == str(box_dtype) == \
            'bfloat16'
        assert str(cls.dtype).split('.')[-1] == str(cls_dtype)
    own = np.abs(ref['bf16'] - ref['f32'])
    err = np.abs(got.numpy() - ref['bf16'])
    for cols in (slice(0, 4), slice(5, None)):
        assert err[..., cols].max() <= own[..., cols].max() and \
            err[..., cols].mean() <= own[..., cols].mean(), (
                cols, err[..., cols].max(), own[..., cols].max())


def test_convert_ultralytics_state_dict_matches_jax():
    from torch_yolo8_ref import make_torch_v8

    config = jax_yolov8.YoloV8Config(ARCH, num_classes=3)
    state = {k: v.detach().numpy()
             for k, v in make_torch_v8(config, seed=1).state_dict().items()}
    ref = jax_yolov8.convert_ultralytics_state_dict(state, config)
    ours = yolov8.convert_ultralytics_state_dict(
        state, yolov8.YoloV8Config(ARCH, num_classes=3))
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_ours, flat_ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_yolov8')
    folder = root / 'images'
    folder.mkdir()
    for i, img in enumerate(data.images()):
        Image.fromarray(img).save(str(folder / 'im{:02d}.png'.format(i)))
    model = str(root / 'md_v1000.0.0-test.npz')
    save_checkpoint(yolov8.init_params(yolov8.YoloV8Config(ARCH, 3),
                                       seed=0), model, METADATA)
    return root, str(folder), model


def _compare_with_jax(checkpoint, tag, options):
    root, folder, model = checkpoint
    ours = run_detector_batch.load_and_run_detector_batch(
        model, folder, batch_size=4, quiet=True, device='cpu',
        detector_options=dict(options))
    ref = jax_batch.load_and_run_detector_batch(
        model, folder, batch_size=4, quiet=True, loader_workers=1,
        detector_options=dict(options, force_cpu=True, use_mesh='false'))
    ours_out = run_detector_batch.write_results_to_file(
        ours, str(root / 'ours_{}.json'.format(tag)),
        relative_path_base=folder, detector_file=model)
    ref_out = jax_batch.write_results_to_file(
        ref, str(root / 'ref_{}.json'.format(tag)),
        relative_path_base=folder, detector_file=model)
    counts = [len(im['detections']) for im in ours_out['images']]
    assert all(0 < n < 300 for n in counts), counts
    assert counts == [len(im['detections']) for im in ref_out['images']]
    result = md_tests.compare_results(ref_out, ours_out,
                                      data.golden_options())
    assert result['n_images_compared'] == len(data.SIZES)
    assert result['errors'] == [], result['errors'][:5]


@pytest.mark.parametrize('preprocess_mode', ['host', 'device'])
def test_detector_matches_jax_driver(checkpoint, preprocess_mode):
    _compare_with_jax(checkpoint, preprocess_mode,
                      {'preprocess_mode': preprocess_mode})
    _, _, model = checkpoint
    detector = run_detector.load_detector(model, device='cpu')
    assert isinstance(detector.model, yolov8.YoloV8)
    assert detector.letterbox_stride == 32
    assert detector.default_image_size == IMAGE_SIZE
    assert detector._fused_decode is False


def _four_images():
    """The four 240x320 images (one 96x128 canvas) and their ids."""

    images = data.images()[:4]
    return images, ['im{:02d}.png'.format(i) for i in range(len(images))]


def test_augment_matches_jax(checkpoint):
    _, _, model = checkpoint
    images, ids = _four_images()
    results = [{'images': detector.generate_detections_one_batch(
        images, ids, 0.005, augment=True)} for detector in (
            TPUDetector(model, {'force_cpu': True}),
            run_detector.load_detector(model, device='cpu'))]
    assert all(0 < len(r['detections']) < 300 for r in results[1]['images'])
    result = md_tests.compare_results(*results, data.golden_options())
    assert result['n_images_compared'] == len(images)
    assert result['errors'] == [], result['errors'][:5]


def test_bf16_detector_matches_jax_bf16(checkpoint):
    _, _, model = checkpoint
    images, ids = _four_images()

    def run(detector):
        return detector.generate_detections_one_batch(images, ids, 0.005)

    jax32 = run(TPUDetector(model, {'force_cpu': True}))
    jax16 = run(TPUDetector(model, {'force_cpu': True,
                                    'dtype': 'bfloat16'}))
    port = run_detector.load_detector(model, device='cpu',
                                      detector_options={'dtype': 'bf16'})
    assert port.model.layers['l0'].weight.dtype == torch.bfloat16
    ours = run(port)
    own = _distance(jax16, jax32)
    got = _distance(jax16, ours)
    assert sum(len(r['detections']) for r in ours) > 50
    assert got[0] <= own[0] + 1 and got[1] <= own[1] and \
        got[2] <= 1.25 * own[2], (got, own)


def test_int8_nodes_are_refused():
    params = yolov8.init_params(yolov8.YoloV8Config(ARCH, 3), seed=0)
    node = params['l1']
    params['l1'] = {'w_q': np.zeros(node['w'].shape, np.int8),
                    'w_scale': np.ones(node['b'].shape, np.float32),
                    'b': node['b']}
    with pytest.raises(ValueError, match='yolov5'):
        _model(params)


def test_pytorch_detector_shim_matches_jax(forward_refs, tmp_path):
    """nms() on the decoded yolov8n output as the JAX shim's (list of
    [n, 6] arrays), PTDetector is the port's detector, and the metadata
    functions write and read what JAX's do."""

    from megadetector_tpu.detection import pytorch_detector as jax_shim
    from megadetector_tpu_torch.detection import pytorch_detector
    from megadetector_tpu_torch.models.detector import TorchDetector

    _, _, ref = forward_refs
    assert pytorch_detector.PTDetector is TorchDetector
    for conf_thres in (0.05, 0.25):
        got = pytorch_detector.nms(ref['f32'], conf_thres, device='cpu')
        want = jax_shim.nms(ref['f32'], conf_thres)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.shape[0] > 0
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4)
    torch_pred = torch.tensor(ref['f32'])
    assert all(np.array_equal(a, b) for a, b in zip(
        pytorch_detector.nms(torch_pred), pytorch_detector.nms(
            ref['f32'], device='cpu')))

    metadata = {'model_version_string': 'v1000.0.0-test', 'x': 1}
    written = []
    for module, name in ((pytorch_detector, 'ours'), (jax_shim, 'ref')):
        npz = str(tmp_path / '{}.npz'.format(name))
        np.savez(npz, a=np.zeros(1))
        module.add_metadata_to_megadetector_model_file(npz, None, metadata)
        pt = str(tmp_path / '{}.pt'.format(name))
        torch.save({'w': torch.zeros(1)}, pt)
        out = str(tmp_path / '{}_meta.pt'.format(name))
        module.add_metadata_to_megadetector_model_file(pt, out, metadata)
        written.append([module.read_metadata_from_megadetector_model_file(f)
                        for f in (npz, out, pt)])
    assert written[0] == written[1]
    assert written[0][0]['x'] == written[0][1]['x'] == 1
    assert written[0][2] is None
