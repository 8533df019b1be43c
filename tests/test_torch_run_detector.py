"""
The port's single-image driver (detection/run_detector.py) and its
rendering (visualization/visualization_utils.py), on the CPU, against the
JAX package in the same process:

- load_and_run_detector on the same yolov5n .npz (torch_port_data's
  sharpened parameters) and images: results at the golden tolerances,
  failure records for unreadable images, every rendered file equal pixel
  for pixel to the JAX package's rendering of the same detections on the
  same image, output-name collisions;
- render_detection_bounding_boxes and what it calls, on the same
  detections: thresholds (float and per category), expansion,
  classifications, labels at the top edge, right-aligned text;
- get_typical_confidence_threshold_from_results on each metadata case,
  estimate_md_images_per_second (no TPU row in the port's table), the
  constants and re-exports, the CLI;
- a kernel, CUDA or programming fault in inference propagates; a data
  error becomes an 'inference failure' record; device None means CUDA.
"""

import json
import os

import numpy as np
import pytest
import torch

from PIL import Image

from megadetector_tpu.detection import run_detector as jax_run_detector
from megadetector_tpu.utils import md_tests
from megadetector_tpu.visualization import visualization_utils as jax_vis
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.ops._build import KernelError
from megadetector_tpu_torch.visualization import visualization_utils as vis

import torch_port_data as data

IMAGE_SIZE = 256


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """(root, model, [image paths]): two PNGs, one JPEG, and a file that
    is not an image."""

    root = tmp_path_factory.mktemp('run_detector')
    images = data.images()
    model = str(root / 'md_v5a.0.0_test.npz')
    save_checkpoint(data.sharpened_params(images), model, data.METADATA)
    folder = root / 'images'
    folder.mkdir()
    files = []
    for i, ext in ((0, 'png'), (4, 'png'), (2, 'jpg')):
        name = str(folder / 'im{}.{}'.format(i, ext))
        Image.fromarray(images[i]).save(name)
        files.append(name)
    broken = str(folder / 'broken.jpg')
    with open(broken, 'wb') as f:
        f.write(b'not an image')
    files.append(broken)
    return root, model, files


def _jax_rendering(result, image_file, **kwargs):
    image = jax_vis.load_image(image_file)
    jax_vis.render_detection_bounding_boxes(
        result['detections'], image,
        label_map=jax_run_detector.DEFAULT_DETECTOR_LABEL_MAP, **kwargs)
    return np.asarray(image)


def test_load_and_run_detector_matches_jax(inputs, tmp_path):
    root, model, files = inputs
    ours = run_detector.load_and_run_detector(
        model, files, str(tmp_path / 'ours'), device='cpu')
    ref = jax_run_detector.load_and_run_detector(
        model, files, str(tmp_path / 'ref'),
        detector_options={'force_cpu': 'true'})
    assert [r['file'] for r in ours] == files
    assert ours[-1] == ref[-1] == {'file': files[-1], 'detections': None,
                                   'failure': 'image access failure'}
    counts = [len(r['detections']) for r in ours[:-1]]
    assert all(0 < n < 300 for n in counts), counts
    result = md_tests.compare_results({'images': ref}, {'images': ours},
                                      data.golden_options())
    assert result['n_images_compared'] == 3
    assert result['errors'] == [], result['errors'][:5]
    # Every rendered file: the JAX package's rendering of the port's
    # detections, saved the same way
    assert sorted(os.listdir(str(tmp_path / 'ours'))) == sorted(
        os.listdir(str(tmp_path / 'ref'))) == [
        'im0_detections.jpg', 'im2_detections.jpg', 'im4_detections.jpg']
    for r, image_file in zip(ours[:-1], files):
        name = os.path.splitext(os.path.basename(image_file))[0]
        want = str(tmp_path / (name + '_want.jpg'))
        Image.fromarray(_jax_rendering(
            r, image_file,
            confidence_threshold=run_detector.
            DEFAULT_RENDERING_CONFIDENCE_THRESHOLD,
            thickness=4, expansion=0, label_font_size=16)).save(want)
        got = np.asarray(Image.open(
            str(tmp_path / 'ours' / (name + '_detections.jpg'))))
        assert np.array_equal(got, np.asarray(Image.open(want))), name


def test_output_name_collisions_match_jax(inputs, tmp_path, monkeypatch):
    """Three images named alike in three folders (and one upper-case
    twin): the second and later get 0000_, 0001_, ... prefixes, as in the
    JAX package. The detector is stubbed: names do not depend on it."""

    root, model, files = inputs
    names = []
    for sub in ('a', 'b', 'c'):
        os.makedirs(str(tmp_path / sub), exist_ok=True)
        names.append(str(tmp_path / sub / 'x.png'))
        Image.fromarray(data.images()[0]).save(names[-1])
    names.append(str(tmp_path / 'a' / 'X.PNG'))
    Image.fromarray(data.images()[1]).save(names[-1])

    class Stub:
        def generate_detections_one_image(self, image, image_id, **kwargs):
            return {'file': image_id, 'detections': [
                {'category': '1', 'conf': 0.9, 'bbox': [0.1, 0.2, 0.3,
                                                        0.4]}]}

    monkeypatch.setattr(run_detector, 'load_detector',
                        lambda *a, **k: Stub())
    monkeypatch.setattr(jax_run_detector, 'load_detector',
                        lambda *a, **k: Stub())
    run_detector.load_and_run_detector(model, names, str(tmp_path / 'ours'))
    jax_run_detector.load_and_run_detector(model, names,
                                           str(tmp_path / 'ref'))
    listing = sorted(os.listdir(str(tmp_path / 'ours')))
    assert listing == sorted(os.listdir(str(tmp_path / 'ref'))) == [
        '0000_x_detections.jpg', '0001_x_detections.jpg',
        '0002_x_detections.jpg', 'x_detections.jpg']
    for name in listing:
        with open(str(tmp_path / 'ours' / name), 'rb') as a, \
                open(str(tmp_path / 'ref' / name), 'rb') as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize('fault', [
    KernelError('conv_int8 launch failed: an illegal memory access'),
    RuntimeError('CUDA error: an illegal memory access was encountered'),
    torch.cuda.OutOfMemoryError('CUDA out of memory'),
    AttributeError('a bug')])
def test_inference_faults_propagate(inputs, tmp_path, monkeypatch, fault):
    """A kernel, CUDA or memory fault in the device program (and, under
    pytest, a programming error) propagates through the detector and
    load_and_run_detector: it never becomes an 'inference failure'
    record."""

    root, model, files = inputs
    detector = run_detector.load_detector(model, device='cpu')

    def fail(*args, **kwargs):
        raise fault

    monkeypatch.setattr(detector, '_run_batch', fail)
    monkeypatch.setattr(run_detector, 'load_detector',
                        lambda *a, **k: detector)
    with pytest.raises(type(fault)):
        run_detector.load_and_run_detector(model, files[:1],
                                           str(tmp_path / 'out'))


def test_data_errors_become_failure_records(inputs, tmp_path, monkeypatch):
    """An error of an image's data is contained, in the detector's batch
    and in load_and_run_detector, as the JAX package does; the next image
    still runs."""

    root, model, files = inputs
    detector = run_detector.load_detector(model, device='cpu')
    real = detector.generate_detections_one_image
    calls = []

    def fail_once(*args, **kwargs):
        calls.append(args[1])
        if len(calls) == 1:
            raise ValueError('a bad image')
        return real(*args, **kwargs)

    monkeypatch.setattr(detector, 'generate_detections_one_image',
                        fail_once)
    monkeypatch.setattr(run_detector, 'load_detector',
                        lambda *a, **k: detector)
    results = run_detector.load_and_run_detector(model, files[:2],
                                                 str(tmp_path / 'out'))
    assert results[0] == {'file': files[0], 'detections': None,
                          'failure': 'inference failure'}
    assert len(results[1]['detections']) > 0
    assert os.listdir(str(tmp_path / 'out')) == ['im4_detections.jpg']

    def contained(*args, **kwargs):
        raise ValueError('a bad batch')

    monkeypatch.setattr(detector, '_run_batch', contained)
    assert real(data.images()[0], 'a') == {
        'file': 'a', 'detections': None, 'failure': 'inference failure'}


def test_device_none_means_cuda(inputs, tmp_path):
    root, model, files = inputs
    if torch.cuda.is_available():
        pytest.skip('a card is present: device None runs on it')
    with pytest.raises(RuntimeError, match='CUDA'):
        run_detector.load_and_run_detector(model, files[:1],
                                           str(tmp_path / 'out'))


def test_cli_matches_jax(inputs, tmp_path, monkeypatch, capsys):
    """main() of both packages on a folder, the port with --device cpu:
    the same rendered files; --image_file renders next to the image."""

    root, model, files = inputs
    folder = os.path.dirname(files[0])
    ours = run_detector.main([model, '--image_dir', folder, '--output_dir',
                              str(tmp_path / 'ours'), '--threshold', '0.3',
                              '--box_thickness', '2', '--device', 'cpu'])
    monkeypatch.setattr('sys.argv', [
        'run_detector', model, '--image_dir', folder, '--output_dir',
        str(tmp_path / 'ref'), '--threshold', '0.3', '--box_thickness',
        '2', '--detector_options', 'force_cpu=true'])
    jax_run_detector.main()
    assert len(ours) == 4
    assert sorted(os.listdir(str(tmp_path / 'ours'))) == sorted(
        os.listdir(str(tmp_path / 'ref')))
    single = str(tmp_path / 'single.png')
    Image.fromarray(data.images()[5]).save(single)
    run_detector.main([model, '--image_file', single, '--device', 'cpu'])
    assert os.path.isfile(str(tmp_path / 'single_detections.jpg'))
    with pytest.raises(SystemExit):
        run_detector.main([])
    assert 'usage' in capsys.readouterr().out


#%% Rendering


def _detections(rng, n=12):
    out = []
    for i in range(n):
        x, y = rng.uniform(0.0, 0.7, 2)
        w, h = rng.uniform(0.05, 0.3, 2)
        out.append({'category': str(1 + i % 3),
                    'conf': float(rng.uniform(0.05, 1.0)),
                    'bbox': [float(x), float(y), float(w), float(h)]})
    # a box at the top edge: its label goes below it
    out.append({'category': '1', 'conf': 0.95,
                'bbox': [0.3, 0.0, 0.2, 0.2]})
    return out


@pytest.mark.parametrize('case', ['default', 'per_category', 'expanded',
                                  'classified', 'unlabelled'])
def test_render_detection_bounding_boxes_matches_jax(case):
    rng = np.random.RandomState(len(case))
    detections = _detections(rng)
    kwargs = {}
    if case == 'per_category':
        kwargs['confidence_threshold'] = {'1': 0.5, '2': 0.1,
                                          'default': 0.3}
    elif case == 'expanded':
        kwargs.update(expansion=6, thickness=2, label_font_size=22)
    elif case == 'classified':
        for i, d in enumerate(detections):
            d['classifications'] = [['3', 0.8], ['7', 0.45], ['1', 0.2],
                                    ['5', None], ['2', 0.9]][:1 + i % 5]
        kwargs.update(classification_label_map={'3': 'deer', '7': 'fox'},
                      classification_confidence_threshold=0.4)
    elif case == 'unlabelled':
        kwargs['label_map'] = {}
    images = [Image.fromarray(data.images()[i]) for i in (0, 0)]
    vis.render_detection_bounding_boxes(detections, images[0], **kwargs)
    jax_vis.render_detection_bounding_boxes(detections, images[1], **kwargs)
    got, want = np.asarray(images[0]), np.asarray(images[1])
    assert np.array_equal(got, want)
    assert not np.array_equal(got, data.images()[0])


@pytest.mark.parametrize('kwargs', [
    {'clss': None}, {'clss': '2', 'textalign': 1},
    {'clss': 5, 'use_normalized_coordinates': False},
    {'clss': '1', 'display_str_list': ['a: 10%', 'b: 20%']}])
def test_draw_bounding_box_on_image_matches_jax(kwargs):
    kwargs = dict(kwargs)
    coords = (0.2, 0.1, 0.7, 0.6)
    if kwargs.get('use_normalized_coordinates') is False:
        coords = (40, 30, 200, 250)
    kwargs.setdefault('display_str_list', ['animal: 87%'])
    images = [Image.fromarray(data.images()[1]) for _ in range(2)]
    vis.draw_bounding_box_on_image(images[0], *coords, **kwargs)
    jax_vis.draw_bounding_box_on_image(images[1], *coords, **kwargs)
    assert np.array_equal(np.asarray(images[0]), np.asarray(images[1]))


def test_rendering_constants_and_text_size_match_jax():
    assert vis.DEFAULT_COLORS == jax_vis.DEFAULT_COLORS
    assert vis.DEFAULT_BOX_THICKNESS == jax_vis.DEFAULT_BOX_THICKNESS
    assert vis.DEFAULT_LABEL_FONT_SIZE == jax_vis.DEFAULT_LABEL_FONT_SIZE
    assert vis.DEFAULT_DETECTOR_LABEL_MAP == \
        jax_vis.DEFAULT_DETECTOR_LABEL_MAP
    for size in (10, 16, 31):
        ours, ref = vis._get_font(size), jax_vis._get_font(size)
        for s in ('animal: 87%', 'x', 'vehicle: 100%'):
            assert vis.get_text_size(ours, s) == \
                jax_vis.get_text_size(ref, s)


#%% Helpers


def test_constants_and_reexports_match_jax():
    for name in ('DEFAULT_BOX_THICKNESS', 'DEFAULT_BOX_EXPANSION',
                 'DEFAULT_LABEL_FONT_SIZE', 'DETECTION_FILENAME_INSERT',
                 'DEFAULT_RENDERING_CONFIDENCE_THRESHOLD',
                 'DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD', 'CONF_DIGITS',
                 'COORD_DIGITS', 'FAILURE_INFER', 'FAILURE_IMAGE_OPEN',
                 'DEFAULT_DETECTOR_LABEL_MAP', 'known_models',
                 'model_string_to_model_version'):
        assert getattr(run_detector, name) == \
            getattr(jax_run_detector, name), name
    for fn in ('get_detector_metadata_from_version_string',
               'get_detector_version_from_filename'):
        for arg in ('v5a.0.0', 'md_v5b.0.0.pt', 'md_v4.1.0.pb', 'mdv1000',
                    'unknown'):
            assert getattr(run_detector, fn)(arg) == \
                getattr(jax_run_detector, fn)(arg), (fn, arg)


@pytest.mark.parametrize('case', ['metadata', 'no_detector', 'v5b', 'v4',
                                  'unknown', 'file'])
def test_typical_confidence_threshold_matches_jax(case, tmp_path):
    info = {'format_version': '1.6'}
    if case == 'metadata':
        info.update(detector='md_v5a.0.0.pt', detector_metadata={
            'typical_detection_threshold': 0.37})
    elif case == 'v5b':
        info['detector'] = 'md_v5b.0.0.pt'
    elif case == 'v4':
        info['detector'] = 'md_v4.1.0.pb'
    elif case in ('unknown', 'file'):
        info['detector'] = 'my_detector.npz'
    results = {'info': info, 'images': []}
    if case == 'file':
        path = str(tmp_path / 'results.json')
        with open(path, 'w') as f:
            json.dump(results, f)
        results = path
    ours = run_detector.get_typical_confidence_threshold_from_results(
        results)
    ref = jax_run_detector.get_typical_confidence_threshold_from_results(
        results)
    assert ours == ref
    assert ours == {'metadata': 0.37, 'v4': 0.8}.get(case, 0.2)


@pytest.mark.parametrize('device_name', ['NVIDIA GeForce RTX 4090',
                                         'NVIDIA GeForce RTX 3050 Laptop',
                                         'Quadro P2000',
                                         'NVIDIA H100 80GB HBM3',
                                         'TPU v5 lite'])
@pytest.mark.parametrize('model_file', ['md_v5a.0.0.pt', 'md_v4.1.0.pb',
                                        'md_v1000.0.0-redwood.pt',
                                        'custom.npz'])
def test_estimate_md_images_per_second(device_name, model_file):
    """The reference's GPU rows as in the JAX package; no H100 row is
    published and the port states no TPU number: both give None."""

    ours = run_detector.estimate_md_images_per_second(model_file,
                                                      device_name)
    ref = jax_run_detector.estimate_md_images_per_second(model_file,
                                                         device_name)
    if 'H100' in device_name or 'TPU' in device_name:
        assert ours is None
    else:
        assert ours == ref
    if not torch.cuda.is_available():
        assert run_detector.estimate_md_images_per_second(model_file) is None
