"""
The detector options and the load_detector signature that the port
shares with the JAX package, held to the JAX detector on the CPU:

- arch overrides the checkpoint metadata's architecture;
- fused_decode picks the selection path as the JAX detector does (default
  on outside the strict modes, either way on request);
- batch_axis is taken with a mesh that has the axis and refused
  (ValueError) without a mesh or naming another axis;
  preprocess_only=true builds a detector without weights whose
  preprocess_image is the full detector's;
- load_detector(model_file, force_cpu=False, detector_options=None,
  verbose=False), with device keyword-only;
- use_mesh, the JAX driver's option: both CLIs given
  --detector_options use_mesh=false write the same JSON, and the detector
  takes it as a no-op (one card);
- is_gpu_available(detector_file=None), called both ways;
- quantize_checkpoint(input_path, output_path, calibration_folder=None,
  calibration_image_size=None, n_calibration_images=8, verbose=False,
  mode='chain'), JAX's positional order, with calibration_images and
  device keyword-only: JAX's keyword and positional call forms write the
  same file, which holds JAX's int8 weights and (within calibration's
  float noise) its scales; mode='static' positional; other modes raise;
- JAX's signatures elsewhere: rfdetr.apply and detr.apply with dtype=None
  (the input's dtype), quantize_params_chain's keep_float_first in third
  place, num_params in every detector family, and ops/boxes'
  compute_stride_target_shape, clip_coords and xywh2xyxy.

Each parity case runs the port's and the JAX package's
load_and_run_detector_batch on the same yolov5n .npz and image folder and
compares them under md_tests.compare_results at the golden tolerances, as
tests/test_torch_detector.py does.
"""

import json
import sys

import numpy as np
import pytest
import torch

from PIL import Image

from megadetector_tpu.detection import run_detector as jax_run_detector
from megadetector_tpu.detection import run_detector_batch as jax_batch
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector, \
    run_detector_batch
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models.detector import TorchDetector

import torch_port_data as data

BATCH = 4


@pytest.fixture(scope='module')
def option_inputs(tmp_path_factory):
    """(root, image folder, yolov5n model, the same weights under metadata
    that names yolov5s)."""

    root = tmp_path_factory.mktemp('torch_options')
    images = data.images()
    folder = root / 'images'
    folder.mkdir()
    for i, img in enumerate(images):
        Image.fromarray(img).save(str(folder / 'im{:02d}.png'.format(i)))
    params = data.sharpened_params(images)
    model = str(root / 'md_v5a.0.0_test.npz')
    save_checkpoint(params, model, data.METADATA)
    mislabeled = str(root / 'md_mislabeled.npz')
    save_checkpoint(params, mislabeled, dict(data.METADATA, arch='yolov5s'))
    return root, str(folder), model, mislabeled


def _assert_matches_jax(root, folder, model, options, tag):
    ours = run_detector_batch.load_and_run_detector_batch(
        model, folder, batch_size=BATCH, quiet=True, device='cpu',
        detector_options=options)
    # use_mesh off: the test session's 8 virtual CPU devices would
    # otherwise round the JAX package's batch up to 8
    ref = jax_batch.load_and_run_detector_batch(
        model, folder, batch_size=BATCH, quiet=True, loader_workers=1,
        detector_options=dict(options, force_cpu=True, use_mesh='false'))
    ours_out = run_detector_batch.write_results_to_file(
        ours, str(root / 'ours_{}.json'.format(tag)),
        relative_path_base=folder, detector_file=model)
    ref_out = jax_batch.write_results_to_file(
        ref, str(root / 'ref_{}.json'.format(tag)),
        relative_path_base=folder, detector_file=model)
    counts = [len(im['detections']) for im in ours_out['images']]
    assert all(0 < n < 300 for n in counts), counts
    result = md_tests.compare_results(ref_out, ours_out,
                                      data.golden_options())
    assert result['n_images_compared'] == len(data.SIZES)
    assert result['errors'] == [], result['errors'][:5]


@pytest.mark.parametrize('mode,fused', [('classic', 'false'),
                                        ('classic-strict', 'true')])
def test_fused_decode_matches_jax(option_inputs, mode, fused):
    """fused_decode against the mode's default: false outside the strict
    modes runs the decoded forward and batched_nms, true in classic-strict
    the fused selection; the JAX detector does the same."""

    root, folder, model, _ = option_inputs
    options = {'compatibility_mode': mode, 'fused_decode': fused}
    detector = run_detector.load_detector(model, device='cpu',
                                          detector_options=options)
    assert detector._fused_decode == (fused == 'true')
    default = run_detector.load_detector(model, device='cpu',
                                         detector_options={
                                             'compatibility_mode': mode})
    assert default._fused_decode == (mode == 'classic')
    _assert_matches_jax(root, folder, model, options,
                        'fused_{}_{}'.format(mode, fused))


def test_arch_override_matches_jax(option_inputs):
    """arch replaces the metadata's architecture: weights saved under a
    wrong arch load and detect as the JAX detector does with the same
    override; without it the port refuses the weights."""

    root, folder, _, mislabeled = option_inputs
    detector = run_detector.load_detector(
        mislabeled, device='cpu', detector_options={'arch': 'yolov5n'})
    assert detector.config.arch == 'yolov5n'
    with pytest.raises(RuntimeError):
        run_detector.load_detector(mislabeled, device='cpu')
    _assert_matches_jax(root, folder, mislabeled, {'arch': 'yolov5n'},
                        'arch')


@pytest.mark.parametrize('options', [{'batch_axis': 'data'},
                                     {'batch_axis': 'model', 'mesh': 2}])
def test_unported_multicard_and_loader_options_are_refused(option_inputs,
                                                           options):
    """batch_axis names the mesh's axis: refused without a mesh and when
    the mesh has no such axis; taken with one that has it (the JAX
    detector's default axis is 'data')."""

    from megadetector_tpu_torch.parallel.mesh import make_data_mesh
    _, _, model, _ = option_inputs
    options = dict(options)
    if 'mesh' in options:
        options['mesh'] = make_data_mesh(devices=['cpu'] * options['mesh'])
    with pytest.raises(ValueError, match='batch_axis'):
        run_detector.load_detector(model, device='cpu',
                                   detector_options=options)
    mesh = make_data_mesh(devices=['cpu'] * 2)
    detector = run_detector.load_detector(
        model, device='cpu', detector_options={
            'batch_axis': mesh.axis_names[0], 'mesh': mesh})
    assert detector.batch_axis == 'data' and detector.mesh is mesh


@pytest.mark.parametrize('mode', ['classic', 'modern'])
def test_preprocess_only_loads_no_weights_and_preprocesses_alike(
        option_inputs, mode):
    """preprocess_only=true (the loader pool's detector): no weights are
    read and no device is taken, inference raises, and preprocess_image
    gives the full detector's dicts, array for array. Its stride is the
    JAX detector's fixed 64, so the full detector is a P6 model
    (MDv5a's family: yolov5n6 here)."""

    root, _, _, _ = option_inputs
    model = str(root / 'md_n6.npz')
    config = yolov5.YoloV5Config('yolov5n6', num_classes=3)
    save_checkpoint(yolov5.init_params(config, seed=0), model,
                    dict(data.METADATA, arch='yolov5n6'))
    options = {'compatibility_mode': mode, 'image_size': data.IMAGE_SIZE}
    full = run_detector.load_detector(model, device='cpu',
                                      detector_options=options)
    only = TorchDetector('/no/such/weights.npz', dict(
        options, preprocess_only='true'))
    assert only.device is None and not hasattr(only, 'model')
    assert only.letterbox_stride == full.letterbox_stride == 64
    for i, img in enumerate(data.images()):
        a = only.preprocess_image(img, image_id=str(i))
        b = full.preprocess_image(img, image_id=str(i))
        assert sorted(a) == sorted(b)
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert np.array_equal(a[key], b[key]), key
            else:
                assert a[key] == b[key], key
    with pytest.raises(RuntimeError, match='preprocess_only'):
        only.generate_detections_one_image(data.images()[0])


def test_preprocess_only_false_is_the_default(option_inputs):
    _, _, model, _ = option_inputs
    img = data.images()[4]
    base = run_detector.load_detector(model, device='cpu')
    same = run_detector.load_detector(
        model, device='cpu', detector_options={'preprocess_only': 'false'})
    assert same.generate_detections_one_image(img, 'a', 0.005) == \
        base.generate_detections_one_image(img, 'a', 0.005)


@pytest.mark.parametrize('call', ['positional', 'keyword'])
def test_load_detector_force_cpu(option_inputs, call):
    """force_cpu is load_detector's second argument, as in the JAX
    package: load_detector(m, True) and load_detector(m, force_cpu=True)
    both load on the CPU."""

    _, _, model, _ = option_inputs
    if call == 'positional':
        detector = run_detector.load_detector(model, True)
    else:
        detector = run_detector.load_detector(model, force_cpu=True)
    assert detector.device == torch.device('cpu')
    assert next(detector.model.parameters()).device.type == 'cpu'
    r = detector.generate_detections_one_image(data.images()[0], 'a', 0.005)
    assert r['file'] == 'a' and np.isfinite(
        [d['conf'] for d in r['detections']]).all()


def test_load_detector_device_is_keyword_only(option_inputs):
    """device cannot be passed by position (the JAX signature's fourth
    argument is verbose), and contradicting force_cpu raises."""

    _, _, model, _ = option_inputs
    with pytest.raises(TypeError):
        run_detector.load_detector(model, False, None, False, 'cpu')
    with pytest.raises(ValueError, match='force_cpu'):
        run_detector.load_detector(model, True, device='cuda')
    detector = run_detector.load_detector(model, True, device='cpu')
    assert detector.device == torch.device('cpu')


@pytest.mark.parametrize('value', ['false', 'true'])
def test_use_mesh_clis_write_the_same_json(option_inputs, tmp_path,
                                           monkeypatch, value):
    """--detector_options use_mesh=<value> through the port's CLI and the
    JAX package's: the port's driver pops it as the JAX driver does (it
    used to reach the detector and raise), and both write the same
    JSON."""

    root, folder, model, _ = option_inputs
    ours_file = str(tmp_path / 'ours.json')
    ref_file = str(tmp_path / 'ref.json')
    common = ['--output_relative_filenames', '--batch_size', str(BATCH),
              '--detector_options', 'use_mesh=' + value]
    run_detector_batch.main([model, folder, ours_file, '--device', 'cpu'] +
                            common)
    # the JAX driver shards over the session's virtual CPU devices with
    # use_mesh=true, which rounds its batch up: compare at false there
    monkeypatch.setattr(sys, 'argv', ['x', model, folder, ref_file] +
                        common[:-1] + ['use_mesh=false', 'force_cpu=true'])
    jax_batch.main()
    with open(ours_file) as f:
        ours = json.load(f)
    with open(ref_file) as f:
        ref = json.load(f)
    assert ours['info']['format_version'] == ref['info']['format_version']
    result = md_tests.compare_results(ref, ours, data.golden_options())
    assert result['n_images_compared'] == len(data.SIZES)
    assert result['errors'] == [], result['errors'][:5]


def test_detector_takes_use_mesh_as_a_no_op(option_inputs):
    _, _, model, _ = option_inputs
    img = data.images()[0]
    base = run_detector.load_detector(model, device='cpu')
    for value in ('false', 'true', True):
        detector = run_detector.load_detector(
            model, device='cpu', detector_options={'use_mesh': value})
        assert detector.generate_detections_one_image(img, 'a', 0.005) == \
            base.generate_detections_one_image(img, 'a', 0.005)


def test_is_gpu_available_takes_the_jax_arguments(option_inputs):
    """is_gpu_available() and is_gpu_available(model_file), as in the JAX
    package (detector_file is ignored): both say whether torch sees a
    card."""

    _, _, model, _ = option_inputs
    want = torch.cuda.is_available()
    assert run_detector.is_gpu_available() is want
    assert run_detector.is_gpu_available(model) is want
    assert run_detector.is_gpu_available(detector_file=model) is want
    jax_run_detector.is_gpu_available(model)


#%% quantize_checkpoint's JAX signature (mode) and the other signatures


@pytest.fixture(scope='module')
def float_yolov5n(tmp_path_factory):
    """(root, a yolov5n float checkpoint at 64 px, JAX's int8-chain file
    of it)."""

    from megadetector_tpu.models.convert_weights import \
        quantize_checkpoint as jax_quantize_checkpoint

    root = tmp_path_factory.mktemp('torch_quantize_forms')
    cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
    f_path = str(root / 'float.npz')
    save_checkpoint(yolov5.init_params(cfg, seed=0), f_path, {
        'arch': 'yolov5n', 'model_type': 'yolov5', 'num_classes': 3,
        'image_size': 64, 'anchors': cfg.anchors.tolist()})
    jax_path = str(root / 'chain_jax.npz')
    jax_quantize_checkpoint(f_path, jax_path, calibration_image_size=64,
                            mode='chain')
    return root, f_path, jax_path


def _written(path):
    from megadetector_tpu_torch.models.convert_weights import (
        flatten_params, load_checkpoint)

    params, metadata = load_checkpoint(path)
    return flatten_params(params), metadata


def test_quantize_checkpoint_takes_the_jax_call_forms(float_yolov5n):
    """JAX's call forms of quantize_checkpoint (validate_weights passes
    mode='chain'; a positional mode is the seventh argument) write the
    same file as the default call and as JAX's quantize_checkpoint: its
    int8 weights, w_scale and biases bit for bit once JAX's folded l0-l3
    are unfolded, its scales within calibration's float noise (as
    tests/test_torch_int8.py holds them)."""

    from megadetector_tpu.models.convert_weights import \
        load_checkpoint as jax_load_checkpoint
    from megadetector_tpu_torch.models.convert_weights import (
        flatten_params, quantize_checkpoint, unfold_early_params)

    root, f_path, jax_path = float_yolov5n
    forms = {
        'keyword': lambda out: quantize_checkpoint(
            f_path, out, calibration_image_size=64, mode='chain',
            device='cpu'),
        'positional': lambda out: quantize_checkpoint(
            f_path, out, None, 64, 8, False, 'chain', device='cpu'),
        'default': lambda out: quantize_checkpoint(
            f_path, out, calibration_image_size=64, device='cpu')}
    written = {}
    for name, call in forms.items():
        out = str(root / '{}.npz'.format(name))
        assert call(out) == out
        written[name] = _written(out)
    ours, metadata = written['default']
    assert metadata['quantization'] == 'int8-chain'
    for name in ('keyword', 'positional'):
        assert written[name][1] == metadata
        assert sorted(written[name][0]) == sorted(ours)
        for k, v in ours.items():
            assert written[name][0][k].tobytes() == v.tobytes(), (name, k)

    cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
    ref = flatten_params(unfold_early_params(
        jax_load_checkpoint(jax_path)[0], cfg))
    assert sorted(ref) == sorted(ours)
    rel = []
    for k, v in ours.items():
        if k.endswith(('x_scale', 'y_scale')):
            rel.append(abs(float(v) / float(ref[k]) - 1.0))
            assert rel[-1] <= 5e-2, k
        else:
            assert v.dtype == ref[k].dtype and v.tobytes() == \
                ref[k].tobytes(), k
    assert len(rel) > 20 and np.median(rel) <= 1e-2


def test_quantize_checkpoint_mode_static_and_unknown_modes(float_yolov5n):
    from megadetector_tpu_torch.models.convert_weights import \
        quantize_checkpoint

    root, f_path, _ = float_yolov5n
    out = str(root / 'static.npz')
    quantize_checkpoint(f_path, out, None, 64, 8, False, 'static',
                        device='cpu')
    params, metadata = _written(out)
    assert metadata['quantization'] == 'int8-static'
    assert any(k.endswith('x_scale') for k in params)
    assert not any(k.endswith('y_scale') for k in params)
    for mode in ('dynamic', 'Chain', None):
        with pytest.raises(ValueError, match='mode'):
            quantize_checkpoint(f_path, str(root / 'x.npz'), mode=mode,
                                device='cpu')
    with pytest.raises(TypeError):
        # calibration_images and device are keyword-only
        quantize_checkpoint(f_path, out, None, 64, 8, False, 'chain', None,
                            'cpu')


def _default(fn, name):
    import inspect

    return inspect.signature(fn).parameters[name].default


@pytest.mark.parametrize('family', ['rfdetr', 'detr'])
def test_apply_dtype_defaults_to_the_input_dtype(family):
    import importlib

    jax_module = importlib.import_module('megadetector_tpu.models.' + family)
    ours = importlib.import_module('megadetector_tpu_torch.models.' + family)
    assert _default(ours.apply, 'dtype') is None
    assert _default(jax_module.apply, 'dtype') is None
    if family == 'rfdetr':
        config = ours.RFDetrConfig('rfdetr_test', image_size=112)
        net = ours.RFDetr(config)
        shape = (1, 112, 112, 3)
    else:
        config = ours.DetrConfig('detr_tiny', image_size=64)
        net = ours.Detr(config)
        shape = (1, 64, 64, 3)
    net.load_params(ours.init_params(config, seed=0)).eval()
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 1, shape).astype(np.float32))
    with torch.inference_mode():
        implicit = ours.apply(config, net.params, x)
        explicit = ours.apply(config, net.params, x, torch.float32)
    assert implicit.dtype == torch.float32
    assert torch.equal(implicit, explicit)


def test_quantize_params_chain_takes_jax_positional_order():
    from megadetector_tpu.ops import quantization as jax_q
    from megadetector_tpu_torch.models.convert_weights import flatten_params
    from megadetector_tpu_torch.ops import quantization as q

    params = yolov5.init_params(yolov5.YoloV5Config('yolov5n', 3), seed=2)
    assert _default(q.quantize_params_chain, 'keep_float_first') is True
    for args in ((('l24',), True, ('l0',)), (('l24',), False, ('l0', 'l1'))):
        ours = flatten_params(q.quantize_params_chain(params, *args))
        ref = flatten_params(jax_q.quantize_params_chain(params, *args))
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].tobytes() == ref[k].tobytes(), (args, k)


@pytest.mark.parametrize('family', ['yolov5', 'yolov8', 'rfdetr', 'detr'])
def test_num_params_matches_jax(family):
    import importlib

    jax_module = importlib.import_module('megadetector_tpu.models.' + family)
    ours = importlib.import_module('megadetector_tpu_torch.models.' + family)
    config = {'yolov5': lambda m: m.YoloV5Config('yolov5n', 3),
              'yolov8': lambda m: m.YoloV8Config('yolov8n', 3),
              'rfdetr': lambda m: m.RFDetrConfig('rfdetr_test'),
              'detr': lambda m: m.DetrConfig('detr_tiny')}[family]
    params = jax_module.init_params(config(jax_module), seed=0)
    trees = [params]
    if family == 'yolov5':
        # a static tree: its float32 x_scale leaves count, as in JAX
        from megadetector_tpu.ops import quantization as jax_q
        static = jax_q.quantize_params(params)
        x = np.random.RandomState(0).uniform(0, 1, (1, 64, 64, 3)).astype(
            np.float32)
        jax_q.calibrate_activation_scales(jax_module.apply,
                                          config(jax_module), static, x)
        trees.append(static)
    for tree in trees:
        assert ours.num_params(tree) == jax_module.num_params(tree) > 0


def test_compute_stride_target_shape_matches_jax():
    from megadetector_tpu.ops import boxes as jax_boxes
    from megadetector_tpu_torch.ops import boxes

    for shape in ((480, 640, 3), (1080, 1920), (3000, 4000), (640, 480),
                  (100, 1000)):
        for size in (640, 1280):
            for stride in (32, 64):
                for pad in (0.0, 0.5):
                    a = boxes.compute_stride_target_shape(shape, size,
                                                          stride, pad)
                    b = jax_boxes.compute_stride_target_shape(shape, size,
                                                              stride, pad)
                    assert a.dtype == b.dtype and np.array_equal(a, b)


def _xywh(seed):
    return np.random.RandomState(seed).uniform(-50, 700, (64, 4)).astype(
        np.float32)


def test_xywh2xyxy_matches_jax():
    from megadetector_tpu.ops import boxes as jax_boxes
    from megadetector_tpu_torch.ops import boxes

    a, b = boxes.xywh2xyxy(_xywh(0)), jax_boxes.xywh2xyxy(_xywh(0))
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_clip_coords_matches_jax():
    from megadetector_tpu.ops import boxes as jax_boxes
    from megadetector_tpu_torch.ops import boxes

    for dtype in (np.float32, np.float64):
        got, want = _xywh(1).astype(dtype), _xywh(1).astype(dtype)
        assert boxes.clip_coords(got, (480, 640)) is got
        jax_boxes.clip_coords(want, (480, 640))
        assert np.array_equal(got, want) and got.max() <= 640
