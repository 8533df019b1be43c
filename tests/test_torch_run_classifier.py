"""
The classifier toolchain of the port (megadetector_tpu_torch/
classification/: crop_detections, run_classifier, detect_and_crop)
against the JAX package's on the CPU: the same crop files, byte for byte,
from the same detections; run_classifier's merged JSON (classification
ids equal, confidences within 1e-4) and CSV; detect_and_crop with
torch_port_data's yolov5n detector (detections at the golden tolerances,
the same crop names), its cache reuse and the host-only helpers.
"""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from megadetector_tpu.classification import crop_detections as jcrop
from megadetector_tpu.classification import detect_and_crop as jdac
from megadetector_tpu.classification import run_classifier as jrc
from megadetector_tpu.models import efficientnet as jeff
from megadetector_tpu.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.classification import crop_detections as tcrop
from megadetector_tpu_torch.classification import detect_and_crop as tdac
from megadetector_tpu_torch.classification import run_classifier as trc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_data as data  # noqa: E402


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """Images, a detections file over them, the detector and a
    classifier."""

    root = tmp_path_factory.mktemp('toolchain')
    images = root / 'images'
    (images / 'sub').mkdir(parents=True)
    imgs = data.images()
    files = []
    for i, img in enumerate(imgs):
        name = ('sub/im{}.jpg' if i % 2 else 'im{}.jpg').format(i)
        Image.fromarray(img).save(str(images / name), quality=95)
        files.append(name)
    rng = np.random.RandomState(5)
    detections = {'info': {'detector': 'md_v5a.0.0.pt',
                           'format_version': '1.4'},
                  'detection_categories': {'1': 'animal', '2': 'person'},
                  'images': []}
    for name in files:
        dets = []
        for _ in range(rng.randint(0, 5)):
            x, y = rng.uniform(0, 0.8, 2)
            w, h = rng.uniform(0.02, 0.5, 2)
            dets.append({'category': str(rng.randint(1, 3)),
                         'conf': round(float(rng.uniform(0.3, 1.0)), 3),
                         'bbox': [round(float(v), 4) for v in
                                  (x, y, min(w, 1 - x), min(h, 1 - y))]})
        detections['images'].append({'file': name, 'detections': dets})
    detections['images'].append({'file': 'missing.jpg', 'detections': [
        {'category': '1', 'conf': 0.9, 'bbox': [0.1, 0.1, 0.2, 0.2]}]})
    det_path = str(root / 'detections.json')
    with open(det_path, 'w') as f:
        json.dump(detections, f)
    cfg = jeff.EfficientNetConfig('efficientnetv2_test', num_classes=4)
    params = jeff.init_params(cfg, seed=2)
    clf = str(root / 'classifier.npz')
    save_checkpoint(params, clf, {
        'arch': 'efficientnetv2_test', 'num_classes': 4,
        'class_names': ['deer', 'fox', 'cow', 'other'], 'image_size': 64})
    detector = str(root / 'detector.npz')
    save_checkpoint(data.sharpened_params(imgs), detector, data.METADATA)
    return {'root': root, 'images': str(images), 'detections': det_path,
            'classifier': clf, 'detector': detector}


def _tree(folder):
    out = {}
    for root, _, files in os.walk(folder):
        for name in files:
            path = os.path.join(root, name)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, folder)] = f.read()
    return out


@pytest.mark.parametrize('square,threshold,threads', [
    (False, 0.5, 1), (True, 0.0, 3)])
def test_crop_detections_writes_jax_s_files(world, square, threshold,
                                            threads):
    out = {}
    for name, module in (('jax', jcrop), ('port', tcrop)):
        folder = str(world['root'] / 'crops_{}_{}_{}'.format(
            name, square, threads))
        n, failed = module.crop_detections(
            world['detections'], folder, world['images'],
            threshold=threshold, square_crops=square, threads=threads)
        out[name] = (n, sorted(failed), _tree(folder))
    assert out['port'][:2] == out['jax'][:2]
    assert out['port'][1] == ['missing.jpg'] and out['port'][0] > 5
    assert out['port'][2] == out['jax'][2]


def test_crop_helpers_as_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (50, 80, 3), dtype=np.uint8)
    for _ in range(100):
        box = list(rng.uniform(-0.2, 1.0, 4))
        for square in (False, True):
            a = jcrop.crop_image_array(img, box, square)
            b = tcrop.crop_image_array(img, box, square)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    for name in ('a/b.jpg', 'x.png'):
        for idx, version in ((3, '5a.0.0'), (120, None)):
            crop = tcrop.crop_filename(name, idx, version)
            assert crop == jcrop.crop_filename(name, idx, version)
            assert tcrop.parse_crop_filename(crop) == \
                jcrop.parse_crop_filename(crop) == (name, idx)
    assert tcrop.parse_crop_filename('plain.jpg') is None
    for info in ({'detector': 'md_v5a.0.0.pt'}, {'detector': 'x.npz'}, {}):
        assert tcrop.detector_version_from_results({'info': info}) == \
            jcrop.detector_version_from_results({'info': info})


def test_run_classifier_matches_jax(world):
    crops = str(world['root'] / 'crops_for_classifier')
    tcrop.crop_detections(world['detections'], crops, world['images'],
                          threshold=0.0)
    merged = {}
    for name, module, kwargs in (('jax', jrc, {}),
                                 ('port', trc, {'device': 'cpu'})):
        out = str(world['root'] / 'merged_{}.json'.format(name))
        csv = str(world['root'] / 'merged_{}.csv'.format(name))
        merged[name] = module.run_classifier(
            world['detections'], crops, world['classifier'],
            output_json_path=out, output_csv_path=csv, batch_size=3,
            top_k=3, threshold=0.01, **kwargs)
        with open(csv) as f:
            merged[name + '_csv'] = [line.split(',') for line in f]
    got, want = merged['port'], merged['jax']
    assert got['classification_categories'] == \
        want['classification_categories']
    n = 0
    for im, ref in zip(got['images'], want['images']):
        for d, r in zip(im['detections'], ref['detections']):
            assert ('classifications' in d) == ('classifications' in r)
            if 'classifications' in d:
                n += 1
                assert [c[0] for c in d['classifications']] == \
                    [c[0] for c in r['classifications']]
                np.testing.assert_allclose(
                    [c[1] for c in d['classifications']],
                    [c[1] for c in r['classifications']], atol=1e-4,
                    rtol=0)
    assert n > 5
    got_csv, want_csv = merged['port_csv'], merged['jax_csv']
    assert [r[0] for r in got_csv] == [r[0] for r in want_csv]
    np.testing.assert_allclose(
        np.array([r[1:] for r in got_csv[1:]], float),
        np.array([r[1:] for r in want_csv[1:]], float), atol=2e-6)
    # the CLI writes the same file
    out = str(world['root'] / 'merged_cli.json')
    trc.main([world['detections'], crops, world['classifier'], '--output',
              out, '--batch_size', '3', '--top_k', '3', '--threshold',
              '0.01', '--device', 'cpu'])
    with open(out) as f:
        cli = json.load(f)
    for d in (cli, got):
        d['info'].pop('classification_completion_time')
    assert cli == json.loads(json.dumps(got))


def test_create_loader_as_jax(world):
    crops = str(world['root'] / 'crops_for_loader')
    tcrop.crop_detections(world['detections'], crops, world['images'],
                          threshold=0.0)
    for detections in (None, world['detections']):
        got = list(trc.create_loader(crops, detections, 32, 4))
        want = list(jrc.create_loader(crops, detections, 32, 4))
        assert [f for _, f in got] == [f for _, f in want]
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_detect_and_crop_matches_jax(world):
    """At batch 8: the JAX driver rounds a batch up to a multiple of the
    test session's 8 virtual CPU devices (its mesh), and a batch's
    candidate escalation is shared by its images."""

    out = {}
    for name, module, kwargs in (('jax', jdac, {}),
                                 ('port', tdac, {'device': 'cpu'})):
        crops = str(world['root'] / 'dac_{}'.format(name))
        det_json = str(world['root'] / 'dac_{}.json'.format(name))
        path, n, failed = module.detect_and_crop(
            world['detector'], world['images'], crops,
            detections_json_path=det_json, threshold=0.05,
            detector_version='5a.0.0', batch_size=8, **kwargs)
        with open(path) as f:
            out[name] = (json.load(f), n, failed, sorted(_tree(crops)))
    got, want = out['port'], out['jax']
    assert got[1:] == want[1:]
    assert got[1] > 0
    for im, ref in zip(got[0]['images'], want[0]['images']):
        assert im['file'] == ref['file']
        assert len(im['detections']) == len(ref['detections'])
        for d, r in zip(sorted(im['detections'], key=lambda d: d['bbox']),
                        sorted(ref['detections'], key=lambda d: d['bbox'])):
            assert d['category'] == r['category']
            assert abs(d['conf'] - r['conf']) <= 0.005
            assert np.abs(np.subtract(d['bbox'], r['bbox'])).max() <= 0.001
    # a second run reuses the detections file (the detection cache)
    path, n, _ = tdac.detect_and_crop(
        'no-such-model.npz', world['images'], str(world['root'] / 'again'),
        detections_json_path=str(world['root'] / 'dac_port.json'),
        threshold=0.05, detector_version='5a.0.0')
    assert n == got[1]


def test_detect_and_crop_host_helpers_as_jax(world, tmp_path):
    cache = tmp_path / 'cache'
    cache.mkdir()
    with open(world['detections']) as f:
        js = json.load(f)
    (cache / 'ds1.json').write_text(json.dumps(js))
    paths = ['ds1/' + im['file'] for im in js['images']] + \
        ['ds2/other.jpg', 'ds1/new.jpg']
    assert tdac.split_images_list_by_dataset(paths) == \
        jdac.split_images_list_by_dataset(paths)
    assert tdac.load_detection_cache(str(cache), ['ds1', 'ds2']) == \
        jdac.load_detection_cache(str(cache), ['ds1', 'ds2'])
    got = tdac.filter_detected_images(paths, str(cache))
    assert got == jdac.filter_detected_images(paths, str(cache))
    assert got[0] == ['ds2/other.jpg', 'ds1/new.jpg']
    # crops of the cached detections, from a <dataset>/<file> layout
    images = tmp_path / 'layout'
    (images / 'ds1').mkdir(parents=True)
    os.symlink(world['images'] + '/sub', str(images / 'ds1' / 'sub'))
    for im in js['images']:
        src = os.path.join(world['images'], im['file'])
        if os.path.isfile(src) and '/' not in im['file']:
            os.symlink(src, str(images / 'ds1' / im['file']))
    queried = {'ds1/' + im['file']: {} for im in js['images']}
    queried['ds1/im0.jpg'] = {'bbox': [[0.1, 0.1, 0.3, 0.3]]}
    results = {}
    for name, module in (('jax', jdac), ('port', tdac)):
        folder = tmp_path / 'dl_{}'.format(name)
        results[name] = module.download_and_crop(
            queried, got[1], got[2], '5a.0.0', str(folder), 0.5,
            square_crops=True, images_dir=str(images), threads=2)
        results[name + '_files'] = _tree(str(folder))
    assert results['port'] == results['jax']
    assert results['port_files'] == results['jax_files']
    assert results['port'][2] > 0
