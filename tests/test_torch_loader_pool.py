"""
The port's batch driver loader pool, on the CPU, against the JAX package's
in the same process:

- the loader worker (detection/_loader_worker.py) gives the info dicts of
  TorchDetector.preprocess_image and of the JAX worker, array for array,
  for host and device preprocessing, classic and modern modes, auto and
  square canvases, and imports no torch, jax or JAX-package module;
- on the stub model (tests/stub_model, its torch twin in
  test_torch_stored_goldens) the port writes the JAX driver's JSON in every
  loader mode (thread 1 and 3, process 2, native thread, native process),
  with a failure, EXIF, timestamps and image size;
- a loader or a process pool that fails mid-run marks the images it never
  delivered as failures and the run returns;
- the port's CLI writes the JAX CLI's file in each loader mode;
  --overwrite_handling, the other new CLI flags and the images/sec line;
- the signature is JAX's plus the keyword-only device;
- preprocess_image under loader threads: the max_canvases guard admits no
  extra canvas, and a square re-letterbox leaves a loader's canvas alone;
- preprocess_only=true builds a detector that preprocesses only.
"""

import inspect
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from megadetector_tpu.detection import _loader_worker as jax_worker
from megadetector_tpu.detection import run_detector_batch as jax_batch
from megadetector_tpu.models.detector import TPUDetector
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch import native
from megadetector_tpu_torch.detection import _loader_worker
from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.models import detector as detector_module
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models.detector import TorchDetector

import torch_port_data as data
from stub_model import make_stub_detector
from test_reference_golden import IMAGE_SIZE, _structured_images
from test_torch_native_jpeg import jax_native_library
from test_torch_stored_goldens import TorchStub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(256, 256), (192, 320), (330, 190), (200, 260), (260, 200),
         (256, 192), (300, 300)]
# Above the stub's one candidate per cell; a value no other test uses, so
# the JAX stub stays out of the JAX package's program cache of real models
TOPK = 643
DATETIME = '2021:06:07 08:09:10'

MODES = {
    'thread1': dict(loader_workers=1),
    'thread3': dict(loader_workers=3),
    'process2': dict(loader_workers=2, loader_pool_type='process'),
    'native_thread': dict(loader_workers=2, use_native_loader=True),
    'native_process': dict(loader_workers=2, loader_pool_type='process',
                           use_native_loader=True),
}
FLAGS = {
    'size': dict(include_image_size=True),
    'exif': dict(include_image_size=True, include_image_timestamp=True,
                 include_exif_data=True),
}


def _exif_bytes(orientation=None):
    exif = Image.Exif()
    exif[306] = DATETIME  # DateTime, IFD0
    exif[271] = 'TestCam'
    if orientation is not None:
        exif[274] = orientation
    exif.get_ifd(0x8769)[36867] = DATETIME  # DateTimeOriginal
    return exif.tobytes()


@pytest.fixture(scope='module')
def folder_inputs(tmp_path_factory):
    """A stub checkpoint and a folder: JPEGs of the structured images (one
    with EXIF, one EXIF-rotated, one mirrored), a grayscale JPEG, a PNG
    and a file that is no image."""

    root = tmp_path_factory.mktemp('loader_pool')
    path = str(root / 'stub.npz')
    save_checkpoint(yolov5.init_params(
        yolov5.YoloV5Config('yolov5n', num_classes=3), seed=0), path, {
        'arch': 'yolov5n', 'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'],
        'image_size': IMAGE_SIZE})
    folder = root / 'images'
    folder.mkdir()
    images = _structured_images(SIZES)
    for i, img in enumerate(images[:4]):
        kwargs = {'quality': 92}
        if i == 1:
            kwargs['exif'] = _exif_bytes()
        Image.fromarray(img).save(str(folder / 'img_{:02d}.jpg'.format(i)),
                                  **kwargs)
    Image.fromarray(images[4]).save(str(folder / 'rotated.jpg'),
                                    quality=92, exif=_exif_bytes(6))
    Image.fromarray(images[5]).save(str(folder / 'mirrored.jpg'),
                                    quality=92, exif=_exif_bytes(2))
    Image.fromarray(images[6][..., 1]).save(str(folder / 'gray.jpg'),
                                            quality=92)
    Image.fromarray(images[0]).save(str(folder / 'lossless.png'))
    with open(str(folder / 'broken.jpg'), 'wb') as f:
        f.write(b'not a jpeg at all')
    return path, str(folder)


def _port_stub(path, canvas_mode='square'):
    detector = TorchDetector(path, {'canvas_mode': canvas_mode,
                                    'pre_nms_topk': TOPK}, device='cpu')
    detector.model = TorchStub()
    detector._fused_decode = False
    return detector


def _jax_stub(path, canvas_mode='square'):
    return make_stub_detector(path, {'canvas_mode': canvas_mode,
                                     'pre_nms_topk': TOPK,
                                     'force_cpu': 'true'})


def _written(write, results, out_file, folder):
    out = write(results, out_file, relative_path_base=folder)
    out = json.loads(json.dumps(out, default=str))
    out['info'].pop('detection_completion_time')
    return out


def _assert_same_json(got, want):
    """Everything but the detections equal; the detections at the stored
    goldens' tolerances (the stub's torch and JAX forwards differ in the
    last bits)."""

    assert [im['file'] for im in got['images']] == \
        [im['file'] for im in want['images']]
    options = data.golden_options()
    for a, b in zip(got['images'], want['images']):
        assert {k: v for k, v in a.items() if k != 'detections'} == \
            {k: v for k, v in b.items() if k != 'detections'}, a['file']
        if b['detections'] is None:
            assert a['detections'] is None
            continue
        assert len(a['detections']) == len(b['detections']) > 0
        result = md_tests.compare_detection_lists(
            b['detections'], a['detections'], options=options,
            image_id=a['file'])
        assert result['errors'] == [], result['errors']
    assert {k: v for k, v in got.items() if k != 'images'} == \
        {k: v for k, v in want.items() if k != 'images'}


_REFERENCE = {}


def _reference(driver, make_detector, path, folder, tmp_path, canvas_mode,
               native_loader, flags):
    """A driver's JSON for the folder on one loader thread (native or
    PIL), cached per setting."""

    key = (driver.__name__, make_detector.__name__, canvas_mode,
           native_loader, flags)
    if key not in _REFERENCE:
        if native_loader:
            jax_native_library()
        results = driver.load_and_run_detector_batch(
            make_detector(path, canvas_mode), folder, batch_size=2,
            quiet=True, loader_workers=1, use_native_loader=native_loader,
            **FLAGS[flags])
        _REFERENCE[key] = _written(driver.write_results_to_file, results,
                                   str(tmp_path / 'ref.json'), folder)
    return _REFERENCE[key]


def _run_port(make_detector, path, folder, tmp_path, canvas_mode, kwargs):
    results = run_detector_batch.load_and_run_detector_batch(
        make_detector(path, canvas_mode), folder, batch_size=2, quiet=True,
        **kwargs)
    return _written(run_detector_batch.write_results_to_file, results,
                    str(tmp_path / 'port.json'), folder)


@pytest.mark.parametrize('flags', sorted(FLAGS))
@pytest.mark.parametrize('mode', sorted(MODES))
def test_every_loader_mode_writes_the_jax_json(folder_inputs, tmp_path,
                                               mode, flags):
    """The port's driver, in each loader mode, writes the JAX driver's
    JSON exactly when both drive the JAX stub detector (the port's driver
    takes any detector object), and the JSON of its own serial run with
    the port's stub detector; that one is held to the JAX driver's at the
    goldens' tolerances."""

    path, folder = folder_inputs
    # EXIF reads through PIL: both drivers then load on threads without
    # the native loader
    native_loader = MODES[mode].get('use_native_loader', False) and \
        flags == 'size'
    kwargs = dict(MODES[mode], **FLAGS[flags])
    want = _reference(jax_batch, _jax_stub, path, folder, tmp_path,
                      'square', native_loader, flags)
    assert _run_port(_jax_stub, path, folder, tmp_path, 'square',
                     kwargs) == want

    run_detector_batch.native_fallbacks = 0
    got = _run_port(_port_stub, path, folder, tmp_path, 'square', kwargs)
    # The native loader hands the mirrored JPEG and the broken file to PIL
    assert run_detector_batch.native_fallbacks == \
        (2 if native_loader else 0)
    assert got == _reference(run_detector_batch, _port_stub, path, folder,
                             tmp_path, 'square', native_loader, flags)

    by_file = {im['file']: im for im in got['images']}
    assert by_file['broken.jpg']['failure'] == 'image access failure'
    # EXIF orientation 6: stored 260 high and 200 wide, turned 90 degrees
    assert (by_file['rotated.jpg']['height'],
            by_file['rotated.jpg']['width']) == (200, 260)
    if flags == 'exif':
        assert by_file['img_01.jpg']['datetime'] == DATETIME
        assert by_file['img_01.jpg']['exif_metadata']['Make'] == 'TestCam'
        assert 'datetime' not in by_file['img_00.jpg']
    else:
        assert all('exif_metadata' not in im for im in got['images'])


def test_port_stub_json_matches_jax_within_golden_tolerances(
        folder_inputs, tmp_path):
    """The port's detector and driver against the JAX package's, on the
    lossless PNG and the images whose stub boxes sit clear of a pixel
    rounding boundary; img_03.jpg's stub box edge lies within float32
    ulps of one (ROADMAP C: a 1 px difference, 0.0039)."""

    path, folder = folder_inputs
    got = _reference(run_detector_batch, _port_stub, path, folder,
                     tmp_path, 'square', False, 'exif')
    want = _reference(jax_batch, _jax_stub, path, folder, tmp_path,
                      'square', False, 'exif')
    keep = [i for i, im in enumerate(want['images'])
            if im['file'] != 'img_03.jpg']
    _assert_same_json(dict(got, images=[got['images'][i] for i in keep]),
                      dict(want, images=[want['images'][i] for i in keep]))


@pytest.mark.parametrize('mode', ['native_thread', 'process2'])
def test_auto_canvases_write_the_jax_json(folder_inputs, tmp_path, mode):
    """auto canvases: the native loader takes each rectangle from the
    JPEG header and its EXIF orientation, the process workers from their
    own guard."""

    path, folder = folder_inputs
    kwargs = dict(MODES[mode], include_image_size=True)
    native_loader = mode == 'native_thread'
    assert _run_port(_jax_stub, path, folder, tmp_path, 'auto', kwargs) == \
        _reference(jax_batch, _jax_stub, path, folder, tmp_path, 'auto',
                   native_loader, 'size')
    assert _run_port(_port_stub, path, folder, tmp_path, 'auto', kwargs) == \
        _reference(run_detector_batch, _port_stub, path, folder, tmp_path,
                   'auto', native_loader, 'size')


def test_timestamp_alone_reads_the_exif(folder_inputs, tmp_path):
    """--include_image_timestamp without --include_exif_data: the port
    reads the EXIF for it; the JAX driver reads EXIF only for
    include_exif_data, so its flag alone adds nothing (ROADMAP, known
    faults in the JAX reference)."""

    path, folder = folder_inputs
    results = run_detector_batch.load_and_run_detector_batch(
        _port_stub(path), folder, batch_size=2, quiet=True,
        include_image_timestamp=True)
    by_file = {os.path.basename(r['file']): r for r in results}
    assert by_file['img_01.jpg']['datetime'] == DATETIME
    assert by_file['rotated.jpg']['datetime'] == DATETIME
    assert all('exif_metadata' not in r for r in results)
    assert 'datetime' not in by_file['img_00.jpg']
    ref = jax_batch.load_and_run_detector_batch(
        _jax_stub(path), folder, batch_size=2, quiet=True, loader_workers=1,
        include_image_timestamp=True)
    assert all('datetime' not in r for r in ref)


def test_get_image_datetime_matches_jax(folder_inputs):
    _, folder = folder_inputs
    for name in sorted(os.listdir(folder)):
        f = os.path.join(folder, name)
        ours = run_detector_batch.get_image_datetime(f)
        assert ours == jax_batch.get_image_datetime(f)
        assert ours == (DATETIME if name in ('img_01.jpg', 'rotated.jpg',
                                             'mirrored.jpg') else None)


def _worker_args(image_size, stride, mode, preprocess_mode, canvas_mode,
                 native_loader=False, max_staging_side=None):
    return (image_size, stride, mode, preprocess_mode, max_staging_side,
            native_loader, canvas_mode, 16)


def _assert_infos_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize('canvas_mode', ['auto', 'square'])
@pytest.mark.parametrize('compat', ['classic', 'modern'])
@pytest.mark.parametrize('preprocess_mode', ['host', 'device'])
def test_worker_infos_equal_preprocess_image_and_jax(folder_inputs,
                                                     preprocess_mode,
                                                     compat, canvas_mode):
    """The worker's dicts against the port detector's preprocess_image
    (on the same decoded pixels) and the JAX worker's. Device mode stages
    the image in the classic modes only, as preprocess_image does; there
    the JAX worker is held to it in the classic mode."""

    path, folder = folder_inputs
    detector = TorchDetector(path, {
        'canvas_mode': canvas_mode, 'compatibility_mode': compat,
        'preprocess_mode': preprocess_mode, 'max_staging_side': 288,
        'preprocess_only': 'true', 'image_size': IMAGE_SIZE})
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image
    for name in sorted(os.listdir(folder)):
        f = os.path.join(folder, name)
        args = _worker_args(IMAGE_SIZE, 64, compat, preprocess_mode,
                            canvas_mode, max_staging_side=288)
        im_file, info, fell_back = _loader_worker.load_and_letterbox(
            (f,) + args)
        assert im_file == f and not fell_back
        _, ref = jax_worker.load_and_letterbox((f,) + args)
        if name == 'broken.jpg':
            assert info == ref == 'image access failure'
            continue
        want = detector.preprocess_image(np.asarray(load_image(f)),
                                         image_id=f)
        _assert_infos_equal(info, want)
        if preprocess_mode == 'host' or compat == 'classic':
            _assert_infos_equal(info, ref)
        else:
            # The JAX worker stages the image in the modern mode too
            assert ref['img_processed'] is None
            assert info['img_processed'] is not None


@pytest.mark.parametrize('canvas_mode', ['auto', 'square'])
@pytest.mark.parametrize('preprocess_mode', ['host', 'device'])
def test_native_worker_infos_equal_jax(folder_inputs, preprocess_mode,
                                       canvas_mode):
    """The native loader's dicts (the letterboxed canvas in host mode, the
    DCT-scaled decode in device mode) equal the JAX native worker's bit
    for bit; the geometry equals the PIL path's."""

    jax_native_library()
    path, folder = folder_inputs
    for name in sorted(os.listdir(folder)):
        f = os.path.join(folder, name)
        args = _worker_args(IMAGE_SIZE, 64, 'classic', preprocess_mode,
                            canvas_mode, native_loader=True)
        _, info, fell_back = _loader_worker.load_and_letterbox((f,) + args)
        _, ref = jax_worker.load_and_letterbox((f,) + args)
        assert fell_back == (name in ('broken.jpg', 'mirrored.jpg'))
        if isinstance(ref, str):
            assert info == ref
            continue
        _assert_infos_equal(info, ref)
        if preprocess_mode == 'host' and not fell_back and \
                name.endswith('.jpg'):
            _, pil, _ = _loader_worker.load_and_letterbox(
                (f,) + args[:5] + (False,) + args[6:])
            assert info['target_shape'] == pil['target_shape']
            assert info['scaling_shape'] == pil['scaling_shape']
            assert np.allclose(info['letterbox_ratio'],
                               pil['letterbox_ratio'])
            assert info['letterbox_pad'] == pil['letterbox_pad']


def test_device_mode_native_boxes_map_back(folder_inputs, tmp_path):
    """preprocess_mode=device with the native loader: the DCT-scaled
    image's scaling_shape maps the boxes back, as in the JAX detector
    (a 4x image decodes at 1/4 scale and lands where the small one does).
    """

    path, folder = folder_inputs
    images = tmp_path / 'big'
    images.mkdir()
    img = _structured_images([(200, 260)])[0]
    big = np.repeat(np.repeat(img, 4, axis=0), 4, axis=1)
    Image.fromarray(big).save(str(images / 'big.jpg'), quality=95)
    options = {'canvas_mode': 'auto', 'pre_nms_topk': TOPK,
               'preprocess_mode': 'device'}
    detector = TorchDetector(path, options, device='cpu')
    detector.model = TorchStub()
    detector._fused_decode = False
    ours = run_detector_batch.load_and_run_detector_batch(
        detector, str(images), batch_size=2, quiet=True,
        use_native_loader=True, loader_workers=1)
    jax_native_library()
    ref = jax_batch.load_and_run_detector_batch(
        make_stub_detector(path, dict(options, force_cpu='true')),
        str(images), batch_size=2, quiet=True, loader_workers=1,
        use_native_loader=True)
    folder_out = str(images)
    _assert_same_json(
        _written(run_detector_batch.write_results_to_file, ours,
                 str(tmp_path / 'a.json'), folder_out),
        _written(jax_batch.write_results_to_file, ref,
                 str(tmp_path / 'b.json'), folder_out))
    assert len(ours[0]['detections']) > 0


def test_worker_module_imports_no_torch_jax_or_jax_package():
    code = ('import sys, json\n'
            'import megadetector_tpu_torch.detection._loader_worker\n'
            'import megadetector_tpu_torch.native\n'
            'print(json.dumps(sorted(m for m in sys.modules if m in '
            '("torch", "jax", "megadetector_tpu") or m.startswith(('
            '"torch.", "jax.", "megadetector_tpu.")))))')
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_a_loader_that_raises_fails_its_undelivered_images(
        folder_inputs, monkeypatch, capsys):
    path, folder = folder_inputs
    real = run_detector_batch._load_and_preprocess
    calls = []

    def fail_third(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError('loader crashed')
        return real(*args, **kwargs)

    monkeypatch.setattr(run_detector_batch, '_load_and_preprocess',
                        fail_third)
    results = run_detector_batch.load_and_run_detector_batch(
        _port_stub(path), folder, batch_size=2, quiet=True,
        loader_workers=1)
    assert 'Loader worker failure: loader crashed' in capsys.readouterr().out
    files = sorted(os.listdir(folder))
    assert [os.path.basename(r['file']) for r in results] == files
    # One worker: the first two images ran, the rest failed
    assert all(r['detections'] is not None for r in results[:2]
               if r['file'][-10:] != 'broken.jpg')
    assert [r.get('failure') for r in results[2:]] == \
        ['image access failure'] * (len(files) - 2)


@pytest.mark.parametrize('workers,depth', [(3, 1), (4, 2), (8, 64)])
def test_batches_do_not_depend_on_loader_timing(folder_inputs, monkeypatch,
                                                workers, depth):
    """Loaders that finish in a scrambled order: the consumer still takes
    the images in input order, so every batch holds the serial run's
    images, even with a look-ahead of one image."""

    path, folder = folder_inputs
    real = run_detector_batch._load_and_preprocess
    delays = np.random.RandomState(workers).uniform(0, 0.03, 64)

    def scrambled(detector, item, **kwargs):
        time.sleep(delays[sorted(os.listdir(folder)).index(
            os.path.basename(item))])
        return real(detector, item, **kwargs)

    def batches(**kwargs):
        detector = _port_stub(path)
        seen = []
        run = detector.generate_detections_one_batch

        def spy(infos, ids, **kw):
            seen.append([os.path.basename(i) for i in ids])
            return run(infos, ids, **kw)

        detector.generate_detections_one_batch = spy
        results = run_detector_batch.load_and_run_detector_batch(
            detector, folder, batch_size=2, quiet=True, **kwargs)
        return seen, results

    serial = batches(loader_workers=1)
    monkeypatch.setattr(run_detector_batch, '_load_and_preprocess',
                        scrambled)
    assert batches(loader_workers=workers, queue_depth=depth) == serial


class _Unpicklable(str):
    def __reduce__(self):
        raise TypeError('cannot pickle this compatibility mode')


def test_a_failed_process_pool_fails_its_images(folder_inputs, capsys):
    path, folder = folder_inputs
    detector = _port_stub(path)
    detector.compatibility_mode = _Unpicklable('classic')
    results = run_detector_batch.load_and_run_detector_batch(
        detector, folder, batch_size=2, quiet=True, loader_workers=2,
        loader_pool_type='process')
    assert 'Loader pool failure' in capsys.readouterr().out
    assert len(results) == len(os.listdir(folder))
    assert all(r['failure'] == 'image access failure' for r in results)


def test_pairs_load_on_threads_in_process_mode(folder_inputs, capsys):
    path, _ = folder_inputs
    pairs = [('a', _structured_images([(200, 260)])[0])]
    results = run_detector_batch.load_and_run_detector_batch(
        _port_stub(path), pairs, batch_size=2, quiet=True,
        loader_pool_type='process', loader_workers=2)
    assert 'switching loader_pool_type to thread' in capsys.readouterr().out
    assert results[0]['file'] == 'a' and len(results[0]['detections']) > 0


def test_signature_is_jax_plus_keyword_device():
    ours = inspect.signature(run_detector_batch.load_and_run_detector_batch)
    ref = inspect.signature(jax_batch.load_and_run_detector_batch)
    params = list(ours.parameters.values())
    assert [(p.name, p.default, p.kind) for p in params[:-1]] == \
        [(p.name, p.default, p.kind) for p in ref.parameters.values()]
    assert params[-1].name == 'device' and params[-1].default is None
    assert params[-1].kind == inspect.Parameter.KEYWORD_ONLY


def test_positional_call_reaches_n_cores_not_quiet(folder_inputs, capsys,
                                                   tmp_path):
    """A positional call written against the JAX package: n_cores and
    use_image_queue take their places, and quiet stays quiet."""

    path, folder = folder_inputs
    checkpoint = str(tmp_path / 'ckpt.json')
    run_detector_batch.load_and_run_detector_batch(
        _port_stub(path), folder, checkpoint, None, 4, None, 4, True, True)
    assert 'Wrote checkpoint' not in capsys.readouterr().out
    assert os.path.isfile(checkpoint)


def _cli(path, folder, out_file, *extra):
    run_detector_batch.main([path, folder, out_file,
                             '--output_relative_filenames',
                             '--batch_size', '2', '--device', 'cpu',
                             '--image_size', str(IMAGE_SIZE)] + list(extra))


@pytest.mark.parametrize('handling', ['overwrite', 'skip', 'error'])
def test_overwrite_handling_as_in_jax(folder_inputs, tmp_path, capsys,
                                      monkeypatch, handling):
    path, folder = folder_inputs
    out_file = str(tmp_path / 'out.json')
    with open(out_file, 'w') as f:
        f.write('{"old": true}')
    if handling == 'error':
        with pytest.raises(ValueError, match='exists'):
            _cli(path, folder, out_file, '--overwrite_handling', handling)
        monkeypatch.setattr(sys, 'argv', ['x', path, folder, out_file,
                                          '--overwrite_handling', handling])
        with pytest.raises(ValueError, match='exists'):
            jax_batch.main()
    elif handling == 'skip':
        _cli(path, folder, out_file, '--overwrite_handling', handling)
        monkeypatch.setattr(sys, 'argv', ['x', path, folder, out_file,
                                          '--overwrite_handling', handling])
        jax_batch.main()
        printed = capsys.readouterr().out
        assert printed.count('Output file {} exists, skipping'.format(
            out_file)) == 2
    else:
        _cli(path, folder, out_file, '--overwrite_handling', handling,
             '--quiet')
        assert 'images/sec' in capsys.readouterr().out
    with open(out_file) as f:
        written = json.load(f)
    assert (written == {'old': True}) == (handling != 'overwrite')


@pytest.mark.parametrize('mode', [
    ['--loader_workers', '3'],
    ['--loader_pool_type', 'process', '--ncores', '2'],
    ['--use_native_loader', '--loader_workers', '2']])
def test_cli_writes_the_jax_clis_json(folder_inputs, tmp_path, monkeypatch,
                                      mode):
    """Both CLIs on the folder with the same flags, each driving the JAX
    stub detector (their load_detector replaced): the same file."""

    path, folder = folder_inputs
    jax_native_library()
    monkeypatch.setattr(run_detector_batch, 'load_detector',
                        lambda *args, **kwargs: _jax_stub(path))
    monkeypatch.setattr(jax_batch, 'load_detector',
                        lambda *args, **kwargs: _jax_stub(path))
    flags = ['--output_relative_filenames', '--batch_size', '2',
             '--include_image_size', '--quiet'] + mode
    outputs = []
    for name, main in (('port', run_detector_batch.main),
                       ('jax', jax_batch.main)):
        out_file = str(tmp_path / '{}.json'.format(name))
        extra = ['--detector_options', 'use_mesh=false'] \
            if name == 'jax' else []
        monkeypatch.setattr(sys, 'argv', ['x', path, folder, out_file] +
                            flags + extra)
        main()
        with open(out_file) as f:
            out = json.load(f)
        out['info'].pop('detection_completion_time')
        outputs.append(out)
    assert outputs[0] == outputs[1]
    assert any(im.get('failure') for im in outputs[0]['images'])


def test_cli_loader_flags(folder_inputs, tmp_path, capsys, monkeypatch):
    """--ncores sets the loader workers (over --loader_workers), the
    pool, native and EXIF flags reach the driver, the compatibility flags
    are taken, and the run ends with the images/sec line."""

    path, folder = folder_inputs
    seen = {}
    real = run_detector_batch.load_and_run_detector_batch

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(run_detector_batch, 'load_and_run_detector_batch',
                        spy)
    _cli(path, folder, str(tmp_path / 'out.json'), '--ncores', '3',
         '--loader_workers', '5', '--loader_pool_type', 'thread',
         '--use_native_loader', '--use_image_queue',
         '--preprocess_on_image_queue', '--include_image_timestamp',
         '--include_exif_data', '--quiet')
    assert seen['loader_workers'] == 3
    assert seen['loader_pool_type'] == 'thread'
    assert seen['use_native_loader'] and seen['include_exif_data'] and \
        seen['include_image_timestamp']
    printed = capsys.readouterr().out
    n = len(os.listdir(folder))
    assert 'Finished inference for {} images in'.format(n) in printed
    assert 'images/sec)' in printed
    with open(str(tmp_path / 'out.json')) as f:
        written = json.load(f)
    dated = [im for im in written['images'] if 'datetime' in im]
    assert sorted(im['file'] for im in dated) == \
        ['img_01.jpg', 'mirrored.jpg', 'rotated.jpg']


def test_missing_native_toolchain_raises(folder_inputs, monkeypatch,
                                         tmp_path):
    """use_native_loader without libjpeg's header raises an error naming
    it, from the driver, before any image loads."""

    path, folder = folder_inputs
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(native, 'toolchain_problem',
                        lambda: 'jpeglib.h not found (libjpeg development '
                                'headers)')
    with pytest.raises(native.NativeLoaderError, match='jpeglib.h'):
        run_detector_batch.load_and_run_detector_batch(
            _port_stub(path), folder, batch_size=2, quiet=True,
            use_native_loader=True)


def _shapes(n):
    """n images whose auto canvases all differ at IMAGE_SIZE."""

    out, seen = [], set()
    for w in range(64, 2048, 8):
        t = detector_module.box_ops.auto_target_shape((256, w), IMAGE_SIZE)
        if t not in seen and t != (IMAGE_SIZE, IMAGE_SIZE):
            seen.add(t)
            out.append(np.full((256, w, 3), 100, np.uint8))
        if len(out) == n:
            return out
    raise AssertionError('too few distinct canvases')


class _GatedSet(set):
    """A set whose length, once read, is returned only when [n] threads
    have read it (or a second has passed): without a lock around the
    guard's check and add, every thread sees the set before any adds to
    it."""

    def __init__(self, n):
        super().__init__()
        self.gate = threading.Barrier(n)

    def __len__(self):
        n = super().__len__()
        try:
            self.gate.wait(timeout=1)
        except threading.BrokenBarrierError:
            pass
        return n


def test_threads_never_admit_more_than_max_canvases():
    detector = TorchDetector(None, {'canvas_mode': 'auto',
                                    'max_canvases': 2,
                                    'preprocess_only': 'true',
                                    'image_size': IMAGE_SIZE})
    detector._auto_canvases = _GatedSet(8)
    images = _shapes(6)
    outputs = []

    def loader(k):
        for img in images[k % 6:] + images[:k % 6]:
            outputs.append(tuple(detector.preprocess_image(
                img)['target_shape']))

    threads = [threading.Thread(target=loader, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    admitted = set(detector._auto_canvases)
    assert len(admitted) == 2
    assert set(outputs) == admitted | {(IMAGE_SIZE, IMAGE_SIZE)}


def test_square_reletterbox_leaves_a_loaders_canvas_alone(monkeypatch):
    detector = TorchDetector(None, {'canvas_mode': 'auto',
                                    'preprocess_only': 'true',
                                    'image_size': IMAGE_SIZE})
    in_square, loader_done = threading.Event(), threading.Event()
    real = detector_module.box_ops.letterbox

    def letterbox(im, *args, **kwargs):
        if not kwargs.get('auto', True) and \
                threading.current_thread() is threading.main_thread():
            # The square re-letterbox waits here until the loader ran
            in_square.set()
            loader_done.wait(timeout=10)
        return real(im, *args, **kwargs)

    monkeypatch.setattr(detector_module.box_ops, 'letterbox', letterbox)
    wide = np.full((128, 256, 3), 90, np.uint8)
    info = detector.preprocess_image(wide, image_id='a')
    assert tuple(info['target_shape']) == (128, 256)
    got = {}

    def loader():
        in_square.wait(timeout=10)
        got['info'] = detector.preprocess_image(wide, image_id='b')
        loader_done.set()

    t = threading.Thread(target=loader)
    t.start()
    square = detector.repreprocess_on_square_canvas(info)
    t.join(timeout=30)
    assert not t.is_alive()
    assert in_square.is_set() and loader_done.is_set()
    assert tuple(square['target_shape']) == (IMAGE_SIZE, IMAGE_SIZE)
    assert tuple(got['info']['target_shape']) == (128, 256)
    assert detector.canvas_mode == 'auto'


def test_preprocess_only_detector(folder_inputs):
    """No weights (the path is not read), no device; the JAX detector's
    defaults; inference raises."""

    detector = TorchDetector('/no/such/checkpoint.npz',
                             {'preprocess_only': 'true'})
    assert detector.device is None and not hasattr(detector, 'model')
    ref = TPUDetector('/no/such/checkpoint.npz',
                      {'preprocess_only': 'true', 'force_cpu': 'true'})
    assert (detector.default_image_size, detector.letterbox_stride) == \
        (ref.default_image_size, ref.letterbox_stride) == (1280, 64)
    img = _structured_images([(300, 400)])[0]
    _assert_infos_equal(detector.preprocess_image(img, 'a'),
                        ref.preprocess_image(img, 'a'))
    with pytest.raises(RuntimeError, match='preprocess_only'):
        detector.generate_detections_one_batch([img])
