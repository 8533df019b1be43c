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
- RF-DETR and YOLOv8 (ultralytics) checkpoints refused, never
  half-converted;
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

import torch_yolo_ref
from megadetector_tpu.detection import run_detector as jax_run_detector
from megadetector_tpu.models import convert_weights as jax_convert
from megadetector_tpu.models import registry as jax_registry
from megadetector_tpu.models.yolov5 import YoloV5Config as JaxYoloV5Config
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.models import convert_weights
from megadetector_tpu_torch.models import registry

import torch_port_data as data

_REF_CLASSES = (torch_yolo_ref.Conv, torch_yolo_ref.Bottleneck,
                torch_yolo_ref.C3, torch_yolo_ref.SPPF, torch_yolo_ref.Concat,
                torch_yolo_ref.Detect, torch_yolo_ref.TorchYolo)


def _save_pt(model, path, importable):
    """torch.save({'model': model}); unless [importable], every class of
    torch_yolo_ref is pickled under a module that is gone at load time."""

    if importable:
        torch.save({'model': model}, path)
        return
    fake = types.ModuleType('md_unimportable_models')
    for cls in _REF_CLASSES:
        setattr(fake, cls.__name__, cls)
        cls.__module__ = fake.__name__
    sys.modules[fake.__name__] = fake
    try:
        torch.save({'model': model}, path)
    finally:
        for cls in _REF_CLASSES:
            cls.__module__ = torch_yolo_ref.__name__
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
    from megadetector_tpu.models import rfdetr
    from torch_rfdetr_ref import make_torch_rfdetr

    config = rfdetr.RFDetrConfig('rfdetr_test', num_classes=3,
                                 image_size=112)
    path = str(tmp_path_factory.mktemp('rfdetr') / 'sorrel_rfdetr.pt')
    torch.save({'model': make_torch_rfdetr(config, seed=4),
                'model_config': {'resolution': 112, 'num_classes': 3}},
               path)
    return path


def test_rfdetr_checkpoint_is_refused(rfdetr_pt, tmp_path, monkeypatch):
    out = str(tmp_path / 'never.npz')
    with pytest.raises(NotImplementedError, match='queue A item 6'):
        convert_weights.convert_megadetector_checkpoint(rfdetr_pt, out)
    assert not os.path.exists(out)
    # load_detector converts a .pt first: refused there too
    monkeypatch.setenv('MD_MODEL_FOLDER', str(tmp_path / 'models'))
    with pytest.raises(NotImplementedError, match='queue A item 6'):
        run_detector.load_detector(rfdetr_pt, device='cpu')
    assert not any(f.endswith('.npz')
                   for f in os.listdir(str(tmp_path / 'models')))


def test_ultralytics_state_dict_is_refused(tmp_path):
    path = str(tmp_path / 'md_v1000.0.0-spruce.pt')
    torch.save({'model.22.dfl.conv.weight': torch.zeros(1, 16, 1, 1),
                'model.0.conv.weight': torch.zeros(16, 3, 3, 3)}, path)
    with pytest.raises(NotImplementedError, match='queue A item 6'):
        convert_weights.convert_megadetector_checkpoint(
            path, str(tmp_path / 'never.npz'))
    assert not os.path.exists(str(tmp_path / 'never.npz'))


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
