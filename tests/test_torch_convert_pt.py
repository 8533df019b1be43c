"""
Reference .pt checkpoints in the port, on the CPU, against the JAX
package's converter in the same process: a yolov5n and a P6 (yolov5s6)
.pt built by tests/torch_yolo_ref.make_torch_model, also pickled under a
module that cannot be imported at load time (the stub unpickler's path).

- extract_torch_state_dict: the same keys, arrays and extras;
- convert_megadetector_checkpoint: a bit-identical .npz (HWIO, BN folded)
  and the same metadata;
- load_detector on the .pt: the detections of the converted .npz, cached
  under the name the JAX load_detector computes;
- the CLI with --quantize --device cpu: the port's quantize_checkpoint;
- the other families: an ultralytics (YOLOv8-style) .pt from
  tests/torch_yolo8_ref.make_torch_v8 (importable and stubbed) and an
  RF-DETR .pt from tests/torch_rfdetr_ref.make_torch_rfdetr give an .npz
  and metadata bit-identical to the JAX converter's; load_detector on
  each .pt detects as its converted .npz does (the RF-DETR preset inferred
  from the state dict, where the JAX converter assumes rfdetr_base); the
  CLI's --quantize and quantize_checkpoint refuse both, as JAX's does;
- get_detector_version_from_model_file as in the JAX registry.
"""

import json
import os
import sys
import types
import zipfile

import numpy as np
import pytest
import torch

import torch_yolo8_ref
import torch_yolo_ref
from megadetector_tpu.detection import run_detector as jax_run_detector
from megadetector_tpu.models import convert_weights as jax_convert
from megadetector_tpu.models import registry as jax_registry
from megadetector_tpu.models.rfdetr import RFDetrConfig as JaxRFDetrConfig
from megadetector_tpu.models.yolov8 import YoloV8Config as JaxYoloV8Config
from megadetector_tpu.models.yolov5 import YoloV5Config as JaxYoloV5Config
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.models import convert_weights
from megadetector_tpu_torch.models import registry, rfdetr, yolov8

import torch_port_data as data

_REF_CLASSES = (torch_yolo_ref.Conv, torch_yolo_ref.Bottleneck,
                torch_yolo_ref.C3, torch_yolo_ref.SPPF, torch_yolo_ref.Concat,
                torch_yolo_ref.Detect, torch_yolo_ref.TorchYolo)


_V8_CLASSES = (torch_yolo8_ref.Conv, torch_yolo8_ref.Bottleneck,
               torch_yolo8_ref.C2f, torch_yolo8_ref.SPPF,
               torch_yolo8_ref.DFL, torch_yolo8_ref.Detect,
               torch_yolo8_ref.TorchYoloV8)


def _save_pt(model, path, importable, classes=_REF_CLASSES):
    """torch.save({'model': model}); unless [importable], every class of
    [classes] (one test module's) is pickled under a module that is gone
    at load time."""

    if importable:
        torch.save({'model': model}, path)
        return
    home = classes[0].__module__
    fake = types.ModuleType('md_unimportable_models')
    for cls in classes:
        setattr(fake, cls.__name__, cls)
        cls.__module__ = fake.__name__
    sys.modules[fake.__name__] = fake
    try:
        torch.save({'model': model}, path)
    finally:
        for cls in classes:
            cls.__module__ = home
        del sys.modules[fake.__name__]


@pytest.fixture(scope='module', params=[
    ('yolov5n', True), ('yolov5n', False), ('yolov5s6', True),
    ('yolov5s6', False)], ids=lambda p: '{}-{}'.format(
        p[0], 'importable' if p[1] else 'stubbed'))
def pt_file(request, tmp_path_factory):
    arch, importable = request.param
    model = torch_yolo_ref.make_torch_model(
        JaxYoloV5Config(arch, num_classes=3), seed=1)
    model.names = ['animal', 'person', 'vehicle']
    path = str(tmp_path_factory.mktemp('pt') / 'md_v5a.0.0_{}.pt'.format(
        arch))
    _save_pt(model, path, importable)
    return path, arch, importable


def test_extract_torch_state_dict_matches_jax(pt_file):
    path, _, importable = pt_file
    ours, ours_extras = convert_weights.extract_torch_state_dict(path)
    ref, ref_extras = jax_convert.extract_torch_state_dict(path)
    assert sorted(ours) == sorted(ref)
    assert 'model.0.conv.weight' in ours
    for key in ref:
        assert ours[key].dtype == ref[key].dtype
        assert np.array_equal(ours[key], ref[key]), key
    assert ours_extras == ref_extras
    assert ours_extras['names'] == ['animal', 'person', 'vehicle']
    if not importable:
        with pytest.raises(ModuleNotFoundError):
            torch.load(path, weights_only=False)


def test_converted_npz_is_bit_identical_to_jax(pt_file, tmp_path):
    path, arch, _ = pt_file
    ours = convert_weights.convert_megadetector_checkpoint(
        path, str(tmp_path / 'ours.npz'), arch=arch)
    ref = jax_convert.convert_megadetector_checkpoint(
        path, str(tmp_path / 'ref.npz'), arch=arch)
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype == np.float32
            assert a[key].shape == b[key].shape
            assert a[key].tobytes() == b[key].tobytes(), key
    with open(str(tmp_path / 'ours.metadata.json')) as f:
        ours_meta = json.load(f)
    with open(str(tmp_path / 'ref.metadata.json')) as f:
        ref_meta = json.load(f)
    assert ours_meta == ref_meta
    assert ours_meta['model_version_string'] == 'v5a.0.1'
    assert len(ours_meta['strides']) == (4 if arch.endswith('6') else 3)


def test_fuse_conv_bn_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(8, 4, 3, 3).astype(np.float32)
    bn = [rng.uniform(0.5, 1.5, 8).astype(np.float32) for _ in range(4)]
    ours = convert_weights.fuse_conv_bn(w, *bn)
    ref = jax_convert.fuse_conv_bn(w, *bn)
    for a, b in zip(ours, ref):
        assert a.tobytes() == b.tobytes()
    assert np.array_equal(convert_weights._oihw_to_hwio(ours[0]),
                          jax_convert._oihw_to_hwio(ref[0]))


def test_load_detector_on_pt_matches_its_npz(tmp_path, monkeypatch):
    """load_detector('x.pt') converts once into the model folder, under
    the name the JAX load_detector gives it, and detects as the
    converted .npz does."""

    images = data.images()[3:5]
    # Both load_detectors convert a .pt as its version's architecture:
    # yolov5l6 for MDv5a
    config = JaxYoloV5Config('yolov5l6', num_classes=3)
    model = torch_yolo_ref.make_torch_model(config, seed=2)
    model.names = ['animal', 'person', 'vehicle']
    pt = str(tmp_path / 'md_v5a.0.0_test.pt')
    _save_pt(model, pt, importable=False)
    folder = tmp_path / 'models'
    monkeypatch.setenv('MD_MODEL_FOLDER', str(folder))
    options = {'image_size': 256}

    port = run_detector.load_detector(pt, device='cpu',
                                      detector_options=options)
    cached = sorted(os.listdir(str(folder)))
    npz = [f for f in cached if f.endswith('.npz')]
    assert len(npz) == 1 and npz[0].startswith('md_v5a.0.1_')
    # Loaded again: the cached file, no second conversion
    run_detector.load_detector(pt, device='cpu', detector_options=options)
    # The JAX load_detector computes the same name: it finds the file
    jax_run_detector.load_detector(pt, force_cpu=True,
                                   detector_options=options)
    assert sorted(os.listdir(str(folder))) == cached

    npz_path = str(tmp_path / 'converted.npz')
    jax_convert.convert_megadetector_checkpoint(pt, npz_path)
    from_npz = run_detector.load_detector(npz_path, device='cpu',
                                          detector_options=options)
    ids = ['im{}'.format(i) for i in range(len(images))]
    got = port.generate_detections_one_batch(images, ids, 0.005)
    want = from_npz.generate_detections_one_batch(images, ids, 0.005)
    assert got == want
    assert sum(len(r['detections']) for r in got) > 0


def test_cli_quantize_matches_quantize_checkpoint(tmp_path, capsys):
    config = JaxYoloV5Config('yolov5n', num_classes=3)
    model = torch_yolo_ref.make_torch_model(config, seed=3)
    pt = str(tmp_path / 'cli_model.pt')
    _save_pt(model, pt, importable=True)
    out = str(tmp_path / 'cli_model.npz')
    calib = tmp_path / 'calib'
    calib.mkdir()
    from PIL import Image
    for i, img in enumerate(data.images()[:2]):
        Image.fromarray(img).save(str(calib / 'c{}.jpg'.format(i)))

    convert_weights.main([pt, out, '--arch', 'yolov5n',
                          '--model_version', 'v5a.0.1', '--quantize',
                          '--calibration_folder', str(calib),
                          '--device', 'cpu'])
    printed = capsys.readouterr().out.split()
    q_out = str(tmp_path / 'cli_model.int8.npz')
    assert printed[-2:] == [out, q_out]

    ref = str(tmp_path / 'ref.npz')
    jax_convert.convert_megadetector_checkpoint(
        pt, ref, arch='yolov5n', model_version='v5a.0.1')
    with np.load(out) as a, np.load(ref) as b:
        assert all(a[k].tobytes() == b[k].tobytes() for k in b.files)
    q_ref = str(tmp_path / 'q_ref.npz')
    convert_weights.quantize_checkpoint(out, q_ref,
                                        calibration_folder=str(calib),
                                        device='cpu')
    with np.load(q_out) as a, np.load(q_ref) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(a[k].dtype == np.int8 for k in a.files)
        for key in b.files:
            assert a[key].tobytes() == b[key].tobytes(), key


@pytest.fixture(scope='module')
def rfdetr_pt(tmp_path_factory):
    from torch_rfdetr_ref import make_torch_rfdetr

    config = JaxRFDetrConfig('rfdetr_test', num_classes=3, image_size=112)
    path = str(tmp_path_factory.mktemp('rfdetr') / 'sorrel_rfdetr.pt')
    torch.save({'model': make_torch_rfdetr(config, seed=4),
                'model_config': {'resolution': 112, 'num_classes': 3}},
               path)
    return path


@pytest.fixture(scope='module', params=[True, False],
                ids=['importable', 'stubbed'])
def ultralytics_pt(request, tmp_path_factory):
    model = torch_yolo8_ref.make_torch_v8(
        JaxYoloV8Config('yolov8n', num_classes=3), seed=5)
    model.names = ['animal', 'person', 'vehicle']
    path = str(tmp_path_factory.mktemp('v8') / 'md_v1000.0.0-spruce.pt')
    _save_pt(model, path, request.param, classes=_V8_CLASSES)
    return path


def _assert_same_files(ours, ref):
    """Two converted .npz files and their metadata, bit for bit."""

    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype == np.float32
            assert a[key].shape == b[key].shape
            assert a[key].tobytes() == b[key].tobytes(), key
    metas = []
    for path in (ours, ref):
        with open(os.path.splitext(path)[0] + '.metadata.json') as f:
            metas.append(json.load(f))
    assert metas[0] == metas[1]
    return metas[0]


def test_ultralytics_pt_converts_as_jax(ultralytics_pt, tmp_path):
    ours = convert_weights.convert_megadetector_checkpoint(
        ultralytics_pt, str(tmp_path / 'ours.npz'))
    ref = jax_convert.convert_megadetector_checkpoint(
        ultralytics_pt, str(tmp_path / 'ref.npz'))
    meta = _assert_same_files(ours, ref)
    # The arch from the stem width (16 channels: yolov8n)
    assert (meta['model_type'], meta['arch'], meta['num_classes'],
            meta['model_version_string'], meta['strides']) == (
                'ultralytics', 'yolov8n', 3, 'v1000.0.0-spruce', [8, 16, 32])


@pytest.mark.parametrize('arch', [None, 'rfdetr_test'])
def test_rfdetr_pt_converts_as_jax(rfdetr_pt, tmp_path, arch):
    """With the arch given, JAX's files bit for bit; without, the port
    infers rfdetr_test from the state dict and JAX (assuming rfdetr_base)
    cannot convert it."""

    ours = convert_weights.convert_megadetector_checkpoint(
        rfdetr_pt, str(tmp_path / 'ours.npz'), arch=arch)
    if arch is None:
        with pytest.raises(KeyError):
            jax_convert.convert_megadetector_checkpoint(
                rfdetr_pt, str(tmp_path / 'ref.npz'))
    ref = jax_convert.convert_megadetector_checkpoint(
        rfdetr_pt, str(tmp_path / 'ref.npz'), arch='rfdetr_test')
    meta = _assert_same_files(ours, ref)
    assert (meta['model_type'], meta['arch'], meta['image_size'],
            meta['num_classes']) == ('rfdetr', 'rfdetr_test', 112, 3)


@pytest.mark.parametrize('arch', sorted(rfdetr.PRESETS))
def test_rfdetr_arch_inferred_from_widths(arch):
    """Each preset's widths and depths identify it (shapes only, no
    arrays)."""

    c = rfdetr.RFDetrConfig(arch, 3)
    enc = 'backbone.0.encoder.'
    state = {enc + 'embeddings.patch_embeddings.projection.weight':
             np.empty((c.vit_dim, 3, 0, 0)),
             'transformer.enc_output.weight':
             np.empty((c.hidden_dim, 0))}
    for i in range(c.vit_depth):
        state[enc + 'encoder.layer.{}.norm1.weight'.format(i)] = None
    for i in range(c.dec_layers):
        state['transformer.decoder.layers.{}.norm1.weight'.format(i)] = None
    assert convert_weights.infer_rfdetr_arch(state) == arch
    assert convert_weights.infer_rfdetr_arch({}) == 'rfdetr_base'


@pytest.mark.parametrize('family', ['ultralytics', 'rfdetr'])
def test_load_detector_on_other_families_pt_matches_npz(
        family, ultralytics_pt, rfdetr_pt, tmp_path, monkeypatch):
    pt, network, size, arch = {
        'ultralytics': (ultralytics_pt, yolov8.YoloV8, 128, None),
        'rfdetr': (rfdetr_pt, rfdetr.RFDetr, 112, 'rfdetr_test')}[family]
    monkeypatch.setenv('MD_MODEL_FOLDER', str(tmp_path / 'models'))
    options = {'image_size': size}
    port = run_detector.load_detector(pt, device='cpu',
                                      detector_options=options)
    assert isinstance(port.model, network)
    assert len([f for f in os.listdir(str(tmp_path / 'models'))
                if f.endswith('.npz')]) == 1
    npz = str(tmp_path / 'converted.npz')
    jax_convert.convert_megadetector_checkpoint(pt, npz, arch=arch)
    from_npz = run_detector.load_detector(npz, device='cpu',
                                          detector_options=options)
    images = data.images()[3:5]
    ids = ['im{}'.format(i) for i in range(len(images))]
    got = port.generate_detections_one_batch(images, ids, 0.005)
    assert got == from_npz.generate_detections_one_batch(images, ids, 0.005)
    assert sum(len(r['detections']) for r in got) > 0


@pytest.mark.parametrize('family', ['ultralytics', 'rfdetr'])
def test_quantize_refuses_other_families(family, ultralytics_pt, rfdetr_pt,
                                         tmp_path):
    pt = {'ultralytics': ultralytics_pt, 'rfdetr': rfdetr_pt}[family]
    out = str(tmp_path / 'model.npz')
    with pytest.raises(ValueError, match='yolov5'):
        convert_weights.main([pt, out, '--quantize', '--device', 'cpu'])
    assert os.path.isfile(out)
    assert not os.path.exists(str(tmp_path / 'model.int8.npz'))
    for quantize in (convert_weights.quantize_checkpoint,
                     jax_convert.quantize_checkpoint):
        with pytest.raises(ValueError, match='yolov5'):
            quantize(out, str(tmp_path / 'q.npz'))
    assert not os.path.exists(str(tmp_path / 'q.npz'))


def test_version_from_model_file_matches_jax(tmp_path):
    npz = str(tmp_path / 'custom.npz')
    with open(str(tmp_path / 'custom.metadata.json'), 'w') as f:
        json.dump({'model_version_string': 'v5b.0.1'}, f)
    np.savez(npz, a=np.zeros(1))
    embedded = str(tmp_path / 'renamed.pt')
    with zipfile.ZipFile(embedded, 'w') as zf:
        zf.writestr('archive/megadetector_info.json',
                    json.dumps({'model_version_string': 'v5a.0.1'}))
    folder = tmp_path / 'md_v5a.0.0_dir'
    folder.mkdir()
    cases = [npz, embedded, str(folder), str(tmp_path / 'md_v5b.0.0.pt'),
             str(tmp_path / 'nothing_known.pt')]
    for path in cases:
        assert registry.get_detector_version_from_model_file(path) == \
            jax_registry.get_detector_version_from_model_file(path), path
        assert registry.read_metadata_from_model_file(path) == \
            jax_registry.read_metadata_from_model_file(path), path
    assert registry.get_detector_version_from_model_file(npz) == 'v5b.0.1'
    assert registry.get_detector_version_from_model_file(embedded) == \
        'v5a.0.1'
