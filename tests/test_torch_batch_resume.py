"""
Checkpoint and resume in the port's run_detector_batch, on the CPU,
against the JAX package's in the same process:

- write_checkpoint / load_checkpoint write and read the JAX package's
  files ({'checkpoint': [...]}, the '_tmp' backup);
- a run interrupted after some batches and resumed from its checkpoint
  writes the JSON of an unbroken run, and of the JAX package's, on the stub
  model (tests/stub_model, its torch twin in test_torch_stored_goldens);
- the CLI's --resume_from_checkpoint (a file and 'auto'),
  --previous_results_file, --checkpoint_frequency / --checkpoint_path and
  --allow_checkpoint_overwrite;
- augment reaching the detector, from the API and from --augment.
"""

import inspect
import json
import os

import pytest
from PIL import Image

from megadetector_tpu.detection import run_detector_batch as jax_batch
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models.detector import TorchDetector

import torch_port_data as data
from stub_model import make_stub_detector
from test_reference_golden import IMAGE_SIZE, _structured_images
from test_torch_stored_goldens import TorchStub

SIZES = [(256, 256), (192, 320), (330, 190), (200, 260), (260, 200),
         (256, 192), (300, 300)]


@pytest.fixture(scope='module')
def stub_inputs(tmp_path_factory):
    """A stub checkpoint and a folder of lossless images (PNG, so both
    packages decode the same pixels)."""

    root = tmp_path_factory.mktemp('resume')
    path = str(root / 'stub.npz')
    save_checkpoint(yolov5.init_params(
        yolov5.YoloV5Config('yolov5n', num_classes=3), seed=0), path, {
        'arch': 'yolov5n', 'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'],
        'image_size': IMAGE_SIZE})
    folder = root / 'images'
    folder.mkdir()
    files = []
    for i, img in enumerate(_structured_images(SIZES)):
        name = str(folder / 'img_{:02d}.png'.format(i))
        Image.fromarray(img).save(name)
        files.append(name)
    return path, str(folder), files


def _port_stub(path):
    detector = TorchDetector(path, {'canvas_mode': 'square',
                                    'pre_nms_topk': 640}, device='cpu')
    detector.model = TorchStub()
    detector._fused_decode = False
    detector._tta_nl = 1
    return detector


def _written(results, out_file, folder):
    out = run_detector_batch.write_results_to_file(
        results, out_file, relative_path_base=folder)
    out['info'].pop('detection_completion_time')
    return out


def test_checkpoint_files_match_jax(tmp_path):
    results = [{'file': 'a.jpg', 'detections': [
        {'category': '1', 'conf': 0.5, 'bbox': [0.1, 0.2, 0.3, 0.4]}]},
        None, {'file': 'b.jpg', 'detections': None,
               'failure': 'image access failure'}]
    ours, ref = str(tmp_path / 'ours.json'), str(tmp_path / 'ref.json')
    for _ in range(2):
        run_detector_batch.write_checkpoint(ours, results)
        jax_batch.write_checkpoint(ref, results)
        with open(ours, 'rb') as a, open(ref, 'rb') as b:
            assert a.read() == b.read()
    # The second write backed the first up and removed the backup
    assert sorted(os.listdir(str(tmp_path))) == ['ours.json', 'ref.json']
    assert run_detector_batch.load_checkpoint(ours) == \
        jax_batch.load_checkpoint(ref) == [results[0], results[2]]
    with open(str(tmp_path / 'bad.json'), 'w') as f:
        json.dump({'images': []}, f)
    with pytest.raises(ValueError, match='checkpoint'):
        run_detector_batch.load_checkpoint(str(tmp_path / 'bad.json'))


def test_signature_takes_the_jax_order():
    ours = inspect.signature(run_detector_batch.load_and_run_detector_batch)
    ref = list(inspect.signature(
        jax_batch.load_and_run_detector_batch).parameters)
    shared = [p for p in ours.parameters if p in ref]
    assert shared == [p for p in ref if p in shared]
    assert len(shared) == len(ours.parameters) - 1
    assert ours.parameters['device'].kind == inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize('augment', [False, True])
def test_interrupted_run_resumes_to_the_unbroken_json(stub_inputs, tmp_path,
                                                      augment):
    path, folder, files = stub_inputs
    unbroken = run_detector_batch.load_and_run_detector_batch(
        _port_stub(path), files, batch_size=2, quiet=True, augment=augment)

    checkpoint = str(tmp_path / 'md_checkpoint_test.json')
    detector = _port_stub(path)
    real = detector.generate_detections_one_batch
    calls = []

    def fail_on_third_batch(*args, **kwargs):
        calls.append(kwargs.get('augment'))
        if len(calls) == 3:
            raise KeyboardInterrupt('interrupted')
        return real(*args, **kwargs)

    detector.generate_detections_one_batch = fail_on_third_batch
    with pytest.raises(KeyboardInterrupt):
        run_detector_batch.load_and_run_detector_batch(
            detector, files, checkpoint_path=checkpoint,
            checkpoint_frequency=2, batch_size=2, quiet=True,
            augment=augment)
    assert calls == [augment] * 3
    restored = run_detector_batch.load_checkpoint(checkpoint)
    assert [r['file'] for r in restored] == files[:4]

    resumed = run_detector_batch.load_and_run_detector_batch(
        _port_stub(path), files, checkpoint_path=checkpoint,
        checkpoint_frequency=2, results=restored, batch_size=2,
        quiet=True, augment=augment)
    assert resumed is restored and len(resumed) == len(files)
    # The final checkpoint holds every result
    assert len(run_detector_batch.load_checkpoint(checkpoint)) == len(files)

    ref = jax_batch.load_and_run_detector_batch(
        make_stub_detector(path, {'canvas_mode': 'square',
                                  'pre_nms_topk': 640}),
        files, batch_size=2, quiet=True, loader_workers=1, augment=augment)
    got = _written(resumed, str(tmp_path / 'resumed.json'), folder)
    assert got == _written(unbroken, str(tmp_path / 'unbroken.json'),
                           folder)
    want = _written(ref, str(tmp_path / 'jax.json'), folder)
    assert [im['file'] for im in got['images']] == \
        [im['file'] for im in want['images']]
    # The JAX package's run at the stored goldens' tolerances
    options = data.golden_options()
    for a, b in zip(got['images'], want['images']):
        assert len(a['detections']) == len(b['detections']) > 0
        result = md_tests.compare_detection_lists(
            b['detections'], a['detections'], options=options,
            image_id=a['file'])
        assert result['errors'] == [], result['errors']


@pytest.fixture(scope='module')
def cli_inputs(tmp_path_factory):
    """A small yolov5n checkpoint with separated detections and a folder
    of PNG images for the CLI (which loads its model from the file)."""

    root = tmp_path_factory.mktemp('resume_cli')
    images = data.images()
    model = str(root / 'md_v5a.0.0_test.npz')
    save_checkpoint(data.sharpened_params(images), model, data.METADATA)
    folder = root / 'images'
    folder.mkdir()
    for i, img in enumerate(images):
        Image.fromarray(img).save(str(folder / 'im_{}.png'.format(i)))
    return model, str(folder)


def _cli(model, folder, out_file, *extra):
    run_detector_batch.main([model, folder, out_file,
                             '--output_relative_filenames',
                             '--batch_size', '2', '--device', 'cpu'] +
                            list(extra))
    with open(out_file) as f:
        out = json.load(f)
    out['info'].pop('detection_completion_time')
    return out


def test_cli_resume_from_checkpoint_file_and_auto(cli_inputs, tmp_path,
                                                  capsys):
    model, folder = cli_inputs
    unbroken = _cli(model, folder, str(tmp_path / 'unbroken.json'))
    files = sorted(os.path.join(folder, f) for f in os.listdir(folder))

    for mode in ('file', 'auto'):
        out_dir = tmp_path / mode
        out_dir.mkdir()
        # A checkpoint of the first three images, as an interrupted run
        # leaves it
        partial = run_detector_batch.load_and_run_detector_batch(
            model, files[:3], batch_size=2, quiet=True, device='cpu')
        checkpoint = str(out_dir / 'md_checkpoint_20240101000000.json')
        run_detector_batch.write_checkpoint(checkpoint, partial)
        capsys.readouterr()
        resume = checkpoint if mode == 'file' else 'auto'
        got = _cli(model, folder, str(out_dir / 'out.json'),
                   '--resume_from_checkpoint', resume,
                   '--checkpoint_frequency', '2',
                   '--allow_checkpoint_overwrite')
        printed = capsys.readouterr().out
        assert 'Restored 3 results from checkpoint {}'.format(
            checkpoint) in printed
        assert 'Bypassing 3 already-processed images' in printed
        assert got == unbroken
        # The run checkpointed to a new timestamped file (frequency given,
        # no --checkpoint_path), deleted on success with its backup; the
        # file it resumed from stays
        assert sorted(os.listdir(str(out_dir))) == [
            os.path.basename(checkpoint), 'out.json']

    (tmp_path / 'empty').mkdir()
    with pytest.raises(ValueError, match='auto'):
        _cli(model, folder, str(tmp_path / 'empty' / 'out.json'),
             '--resume_from_checkpoint', 'auto')


def test_cli_checkpoint_path_is_written_during_the_run(cli_inputs, tmp_path,
                                                       monkeypatch):
    model, folder = cli_inputs
    checkpoint = str(tmp_path / 'ckpt.json')
    seen = []
    real = run_detector_batch.write_checkpoint

    def spy(path, results):
        seen.append((path, len([r for r in results if r is not None])))
        real(path, results)

    monkeypatch.setattr(run_detector_batch, 'write_checkpoint', spy)
    _cli(model, folder, str(tmp_path / 'out.json'),
         '--checkpoint_frequency', '3', '--checkpoint_path', checkpoint)
    n = len(os.listdir(folder))
    assert [p for p, _ in seen] == [checkpoint] * len(seen)
    counts = [c for _, c in seen]
    assert counts == [4, n]
    assert not os.path.exists(checkpoint)


def test_cli_previous_results_file(cli_inputs, tmp_path, capsys):
    model, folder = cli_inputs
    unbroken = _cli(model, folder, str(tmp_path / 'unbroken.json'))
    previous = dict(unbroken, images=[im for im in unbroken['images']
                                      if im['file'] in ('im_0.png',
                                                        'im_5.png')])
    prev_file = str(tmp_path / 'previous.json')
    with open(prev_file, 'w') as f:
        json.dump(previous, f)
    capsys.readouterr()
    got = _cli(model, folder, str(tmp_path / 'out.json'),
               '--previous_results_file', prev_file)
    printed = capsys.readouterr().out
    assert 'Merged 2 previous results' in printed
    assert 'Bypassing 2 already-processed images' in printed
    assert got == unbroken


def test_cli_augment_reaches_the_detector(cli_inputs, tmp_path,
                                          monkeypatch):
    model, folder = cli_inputs
    flags = []
    real = TorchDetector.run_program

    def spy(self, batch, conf, iou, augment=False):
        flags.append(augment)
        return real(self, batch, conf, iou, augment=augment)

    monkeypatch.setattr(TorchDetector, 'run_program', spy)
    got = _cli(model, folder, str(tmp_path / 'aug.json'), '--augment')
    assert flags and all(flags)
    files = sorted(os.path.join(folder, f) for f in os.listdir(folder))
    want = run_detector_batch.write_results_to_file(
        run_detector_batch.load_and_run_detector_batch(
            model, files, batch_size=2, quiet=True, augment=True,
            device='cpu'),
        str(tmp_path / 'api.json'), relative_path_base=folder)
    want['info'].pop('detection_completion_time')
    want['info'] = got['info']
    assert got == json.loads(json.dumps(want))
    plain = _cli(model, folder, str(tmp_path / 'plain.json'))
    assert flags.count(False) > 0 and plain != got
