"""
The port's tiled inference (detection/run_tiled_inference.py), on the CPU,
against the JAX package in the same process:

- get_patch_boundaries identical over a grid of image, tile and stride
  sizes (the reference's width-15 / stride-10 example, float and tuple
  strides, the zero-stride and too-large-tile assertions);
- patch names, patch extraction and the written tile JPEGs;
- in_place_nms identical on seeded random detections;
- run_tiled_inference on the same yolov5n .npz (torch_port_data's
  sharpened parameters) and images (one tile-sized, one larger, one
  smaller than a tile, one unreadable): the JSON at the golden tolerances,
  with use_mesh=false, with a checkpoint and a resume, with save_tiles;
- the CLI; device None means CUDA; a kernel fault propagates.
"""

import json
import os

import numpy as np
import pytest
import torch

from PIL import Image

from megadetector_tpu.detection import run_detector_batch as jax_batch
from megadetector_tpu.detection import run_tiled_inference as jax_tiled
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.detection import run_detector_batch
from megadetector_tpu_torch.detection import run_tiled_inference as tiled
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.ops._build import KernelError

import torch_port_data as data

TILE = 128


#%% Geometry


@pytest.mark.parametrize('image_size', [(15, 10), (128, 128), (256, 128),
                                        (300, 200), (1280, 1280),
                                        (4000, 3000), (1921, 1081),
                                        (2048, 1536)])
@pytest.mark.parametrize('patch_size', [(128, 128), (96, 64), (320, 240),
                                        (1280, 1280)])
@pytest.mark.parametrize('stride', [None, 0.5, 0.25, 0.9, (10, 10),
                                    (37, 23)])
def test_patch_boundaries_match_jax(image_size, patch_size, stride):
    if patch_size[0] > image_size[0] or patch_size[1] > image_size[1]:
        for fn in (tiled.get_patch_boundaries,
                   jax_tiled.get_patch_boundaries):
            with pytest.raises(AssertionError, match='exceeds'):
                fn(image_size, patch_size, stride)
        return
    ours = tiled.get_patch_boundaries(image_size, patch_size, stride)
    assert ours == jax_tiled.get_patch_boundaries(image_size, patch_size,
                                                  stride)
    assert ours[-1] == [image_size[0] - patch_size[0],
                        image_size[1] - patch_size[1]]


def test_patch_boundaries_reference_example_and_zero_stride():
    assert tiled.get_patch_boundaries((15, 10), (10, 10),
                                      patch_stride=(10, 10)) == [[0, 0],
                                                                 [5, 0]]
    # MDv5a's default tiling of a 12 MP frame: 6 x 4 tiles
    positions = tiled.get_patch_boundaries((4000, 3000), (1280, 1280))
    assert len(positions) == 24
    assert sorted({x for x, _ in positions}) == [0, 640, 1280, 1920, 2560,
                                                 2720]
    assert sorted({y for _, y in positions}) == [0, 640, 1280, 1720]
    for stride in (0.0, 0.001, (0, 10)):
        for fn in (tiled.get_patch_boundaries,
                   jax_tiled.get_patch_boundaries):
            with pytest.raises(AssertionError, match='stride'):
                fn((512, 512), (128, 128), patch_stride=stride)


def test_patch_names_and_extraction_match_jax(tmp_path):
    im = data.images()[0]
    for args in (('a.jpg', 10, 20), ('x/y/b.png', 0, 12345)):
        assert tiled.patch_info_to_patch_name(*args) == \
            jax_tiled.patch_info_to_patch_name(*args)
    for source in (im, Image.fromarray(im)):
        ours = tiled.extract_patch_from_image(
            source, (64, 32), (128, 96), patch_folder=str(tmp_path / 'o'),
            image_name='sub/dir/im.jpg')
        ref = jax_tiled.extract_patch_from_image(
            source, (64, 32), (128, 96), patch_folder=str(tmp_path / 'r'),
            image_name='sub/dir/im.jpg')
        assert np.array_equal(ours.pop('patch'), ref.pop('patch'))
        assert os.path.basename(ours.pop('patch_fn')) == \
            os.path.basename(ref.pop('patch_fn')) == \
            'sub~dir~im.jpg_0064_0032.jpg'
        assert ours == ref
    with open(str(tmp_path / 'o' / 'sub~dir~im.jpg_0064_0032.jpg'),
              'rb') as a, open(str(tmp_path / 'r' /
                                   'sub~dir~im.jpg_0064_0032.jpg'),
                               'rb') as b:
        assert a.read() == b.read()


#%% Cross-tile NMS


def _random_results(seed, n_images=4):
    rng = np.random.RandomState(seed)
    images = []
    for i in range(n_images):
        n = rng.randint(0, 60)
        detections = []
        for _ in range(n):
            x, y = rng.uniform(0, 0.8, 2)
            w, h = rng.uniform(0.01, 0.25, 2)
            if rng.rand() < 0.3 and detections:
                # a near duplicate of an earlier box, as overlapping tiles
                # make them
                base = detections[rng.randint(len(detections))]['bbox']
                x, y, w, h = np.asarray(base) + rng.uniform(-0.01, 0.01, 4)
            detections.append({
                'category': str(rng.randint(1, 4)),
                'conf': round(float(rng.uniform(0.005, 1.0)), 3),
                'bbox': [round(float(v), 4) for v in (x, y, w, h)]})
        images.append({'file': 'im{}.jpg'.format(i),
                       'detections': detections})
    images.append({'file': 'failed.jpg', 'detections': None,
                   'failure': 'image access failure'})
    return images


@pytest.mark.parametrize('seed', range(6))
@pytest.mark.parametrize('iou', [0.45, 0.2, 0.7])
def test_in_place_nms_matches_jax(seed, iou):
    ours, ref = _random_results(seed), _random_results(seed)
    tiled.in_place_nms({'images': ours}, iou_thres=iou)
    jax_tiled.in_place_nms({'images': ref}, iou_thres=iou)
    assert ours == ref
    # a list of image dicts works too
    again = _random_results(seed)
    tiled.in_place_nms(again, iou_thres=iou)
    assert again == ours
    before = sum(len(im['detections'] or [])
                 for im in _random_results(seed))
    assert sum(len(im['detections'] or []) for im in ours) <= before


#%% run_tiled_inference


@pytest.fixture(scope='module')
def tiled_inputs(tmp_path_factory):
    """(root, model, image folder): 'tile' is exactly a tile, 'big' makes
    4 x 3 tiles, 'small' is smaller than a tile on one side, and 'broken'
    is not an image."""

    root = tmp_path_factory.mktemp('tiled')
    images = data.images()
    model = str(root / 'md_v5a.0.0_test.npz')
    save_checkpoint(data.sharpened_params(images), model, data.METADATA)
    folder = root / 'images'
    (folder / 'sub').mkdir(parents=True)
    Image.fromarray(images[0][:TILE, :TILE]).save(str(folder / 'tile.png'))
    Image.fromarray(images[1][:200, :300]).save(str(folder / 'big.png'))
    Image.fromarray(images[5][:, :TILE - 8]).save(
        str(folder / 'sub' / 'small.png'))
    with open(str(folder / 'broken.jpg'), 'wb') as f:
        f.write(b'not an image')
    return root, model, str(folder)


def _ours(model, folder, tmp_path, name, **kwargs):
    kwargs.setdefault('device', 'cpu')
    return tiled.run_tiled_inference(
        model, folder, str(tmp_path / 'tiles_ours'),
        str(tmp_path / (name + '.json')), tile_size_x=TILE,
        tile_size_y=TILE, batch_size=4, image_size=TILE, **kwargs)


def _ref(model, folder, tmp_path, name, **kwargs):
    options = dict(kwargs.pop('detector_options', None) or {},
                   force_cpu='true')
    return jax_tiled.run_tiled_inference(
        model, folder, str(tmp_path / 'tiles_ref'),
        str(tmp_path / (name + '.json')), tile_size_x=TILE,
        tile_size_y=TILE, batch_size=4, image_size=TILE,
        detector_options=options, **kwargs)


def _assert_same_json(ours, ref, n_compared=3):
    for out in (ours, ref):
        out['info'].pop('detection_completion_time', None)
    assert [im['file'] for im in ours['images']] == \
        [im['file'] for im in ref['images']]
    result = md_tests.compare_results(ref, ours, data.golden_options())
    assert result['n_images_compared'] == n_compared
    assert result['errors'] == [], result['errors'][:5]
    for a, b in zip(ours['images'], ref['images']):
        assert {k: v for k, v in a.items() if k != 'detections'} == \
            {k: v for k, v in b.items() if k != 'detections'}
        for det in a['detections'] or []:
            x, y, w, h = det['bbox']
            assert -0.001 <= x and x + w <= 1.001
            assert -0.001 <= y and y + h <= 1.001


@pytest.fixture(scope='module')
def reference_run(tiled_inputs, tmp_path_factory):
    root, model, folder = tiled_inputs
    tmp = tmp_path_factory.mktemp('tiled_ref')
    return _ref(model, folder, tmp, 'ref',
                detector_options={'use_mesh': 'false'})


@pytest.mark.parametrize('options', [None, {'use_mesh': 'false'}])
def test_run_tiled_inference_matches_jax(tiled_inputs, reference_run,
                                         tmp_path, options):
    root, model, folder = tiled_inputs
    ours = _ours(model, folder, tmp_path, 'ours', detector_options=options)
    assert [im['file'] for im in ours['images']] == [
        'big.png', 'broken.jpg', 'sub/small.png', 'tile.png']
    broken = ours['images'][1]
    assert broken['detections'] is None
    assert broken['failure'] == 'Patch generation error'
    counts = [len(im['detections']) for im in ours['images']
              if im['detections'] is not None]
    assert all(n > 0 for n in counts), counts
    _assert_same_json(ours, json.loads(json.dumps(reference_run)))


def test_remap_and_dedup_of_a_batch(tiled_inputs):
    """The driver's output for one image equals what generate_detections_
    one_batch gives on its tiles, remapped through pixels (rounded after
    the remap) and deduplicated across tiles."""

    root, model, folder = tiled_inputs
    detector = run_detector.load_detector(model, device='cpu')
    im = np.asarray(Image.open(os.path.join(folder, 'big.png')))
    infos = tiled.image_patches(im, (TILE, TILE))
    assert len(infos) == 12
    batch = detector.generate_detections_one_batch(
        [p['patch'] for p in infos], ['t'] * 12, 0.005, image_size=TILE)
    detections = []
    for info, r in zip(infos, batch):
        detections.extend(tiled.remap_patch_detections(info, r, 300, 200))
    want = [{'file': 'big.png', 'detections': detections}]
    jax_tiled.in_place_nms(want)
    out = tiled.run_tiled_inference(
        detector, folder, None, os.path.join(str(root), 'one.json'),
        tile_size_x=TILE, tile_size_y=TILE, image_list=['big.png'],
        image_size=TILE)
    written = run_detector_batch.write_results_to_file(
        want, os.path.join(str(root), 'want.json'))
    assert out['images'] == written['images']


def test_checkpoint_resume_matches_an_unbroken_run(tiled_inputs,
                                                   reference_run, tmp_path,
                                                   monkeypatch):
    """A run interrupted at its third image leaves a checkpoint of the
    first (written in the JAX package's format, which it reads back; the
    unreadable second, as in the JAX package, is not counted towards a
    checkpoint); the resumed run skips it, writes the unbroken run's JSON,
    and removes the checkpoint."""

    root, model, folder = tiled_inputs
    checkpoint = str(tmp_path / 'tiled_checkpoint.json')
    detector = run_detector.load_detector(model, device='cpu')
    real = detector.generate_detections_one_batch
    calls = []

    def interrupt_third_image(images, ids, **kwargs):
        calls.append(ids[0])
        if ids[0].startswith('sub/small.png'):
            raise KeyboardInterrupt('interrupted')
        return real(images, ids, **kwargs)

    monkeypatch.setattr(detector, 'generate_detections_one_batch',
                        interrupt_third_image)
    with pytest.raises(KeyboardInterrupt):
        _ours(detector, folder, tmp_path, 'broken_run',
              checkpoint_path=checkpoint, checkpoint_frequency=1)
    saved = jax_batch.load_checkpoint(checkpoint)
    assert [im['file'] for im in saved] == ['big.png']
    assert calls == ['big.png__0', 'big.png__4', 'big.png__8',
                     'sub/small.png__0']
    monkeypatch.setattr(detector, 'generate_detections_one_batch', real)
    calls.clear()
    resumed = _ours(detector, folder, tmp_path, 'resumed',
                    checkpoint_path=checkpoint, checkpoint_frequency=1,
                    detector_options={'use_mesh': 'false'})
    assert not os.path.isfile(checkpoint)
    assert [im['file'] for im in resumed['images']] == [
        'big.png', 'broken.jpg', 'sub/small.png', 'tile.png']
    _assert_same_json(resumed, json.loads(json.dumps(reference_run)))


def test_jax_checkpoint_resumes_in_the_port(tiled_inputs, reference_run,
                                            tmp_path):
    """A checkpoint the JAX package wrote (one finished image) resumes in
    the port: that image is taken as written."""

    root, model, folder = tiled_inputs
    checkpoint = str(tmp_path / 'ckpt.json')
    first = dict(reference_run['images'][0])
    jax_batch.write_checkpoint(checkpoint, [first])
    ours = _ours(model, folder, tmp_path, 'ours', checkpoint_path=checkpoint,
                 checkpoint_frequency=1)
    assert ours['images'][0] == first
    _assert_same_json(ours, json.loads(json.dumps(reference_run)))


def test_save_tiles_match_jax(tiled_inputs, tmp_path):
    """save_tiles writes each tile as the JAX package does (same names and
    bytes); remove_tiles=False keeps them, True removes the folder."""

    root, model, folder = tiled_inputs
    image_list = ['big.png', 'sub/small.png']
    _ours(model, folder, tmp_path, 'ours', save_tiles=True,
          remove_tiles=False, image_list=image_list)
    _ref(model, folder, tmp_path, 'ref', save_tiles=True, remove_tiles=False,
         image_list=image_list)
    names = sorted(os.listdir(str(tmp_path / 'tiles_ours')))
    assert names == sorted(os.listdir(str(tmp_path / 'tiles_ref')))
    assert len(names) == 12 and names[0] == 'big.png_0000_0000.jpg'
    for name in names:
        with open(str(tmp_path / 'tiles_ours' / name), 'rb') as a, \
                open(str(tmp_path / 'tiles_ref' / name), 'rb') as b:
            assert a.read() == b.read(), name
    _ours(model, folder, tmp_path, 'again', save_tiles=True,
          image_list=image_list)
    assert not os.path.exists(str(tmp_path / 'tiles_ours'))


def test_cli_matches_jax(tiled_inputs, reference_run, tmp_path,
                         monkeypatch):
    root, model, folder = tiled_inputs
    args = [model, folder, str(tmp_path / 'tiles'),
            str(tmp_path / 'cli.json'), '--tile_size_x', str(TILE),
            '--tile_size_y', str(TILE), '--batch_size', '3',
            '--image_size', str(TILE), '--tile_overlap', '0.5',
            '--detector_options', 'use_mesh=false']
    ours = tiled.main(args + ['--device', 'cpu'])
    monkeypatch.setattr('sys.argv', ['run_tiled_inference'] + args[:3] + [
        str(tmp_path / 'cli_ref.json')] + args[4:] + ['force_cpu=true'])
    jax_tiled.main()
    with open(str(tmp_path / 'cli_ref.json')) as f:
        ref = json.load(f)
    _assert_same_json(ours, ref)
    _assert_same_json(json.loads(json.dumps(ours)),
                      json.loads(json.dumps(reference_run)))


def test_device_none_means_cuda_and_faults_propagate(tiled_inputs, tmp_path,
                                                     monkeypatch):
    root, model, folder = tiled_inputs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            _ours(model, folder, tmp_path, 'none', device=None)
    detector = run_detector.load_detector(model, device='cpu')

    def fail(*args, **kwargs):
        raise KernelError('nms launch failed')

    monkeypatch.setattr(detector, '_run_batch', fail)
    with pytest.raises(KernelError):
        _ours(detector, folder, tmp_path, 'fault')
