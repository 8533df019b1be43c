"""
Classifier evaluation in the port, held to the JAX package on the CPU:

- classification/create_classification_dataset.py: on a world like
  tests/test_classifier_toolchain.py's (crops cut by the port's
  crop_detections from a detections file; 12 images, 2 labels, 6
  locations, one of them ground-truth boxes), classification_ds.csv,
  label_index.json and splits.json byte-identical to JAX's, at two seeds
  and split fractions; create_classification_csv's frame and log,
  create_splits_random and create_splits_smallest_label_first identical;
- classification/evaluate_model.py on an efficientnetv2_test checkpoint
  (the port's SpeciesClassifier on the CPU against JAX's): the written
  probabilities within 1e-5 (float32; JAX's default folded stem sums in
  another order), the same predictions, so identical confusion matrices
  and label statistics; given JAX's probabilities every file
  byte-identical to JAX's; the CLI; trace_model's torch.export program
(written, reused, and within the classifier float bar of JAX's
deserialized program).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from megadetector_tpu.classification import \
    create_classification_dataset as jax_ccd
from megadetector_tpu.classification import evaluate_model as jax_em
from megadetector_tpu.models import efficientnet as jax_effnet
from megadetector_tpu.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.classification import \
    create_classification_dataset as ccd
from megadetector_tpu_torch.classification import evaluate_model as em
from megadetector_tpu_torch.classification.crop_detections import \
    crop_detections
from megadetector_tpu_torch.utils import ct_utils

LABELS = ('cervid', 'ursid')


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """Images, detections, queried images (labels), the crops and a
    detector output cache for 12 images over 6 locations."""

    base = tmp_path_factory.mktemp('torch_clf_world')
    images_dir = base / 'images'
    rng = np.random.RandomState(0)
    queried, det_images = {}, []
    for i in range(12):
        loc = i % 6
        fn = 'camtrap/loc{}/im_{}.jpg'.format(loc, i)
        p = images_dir / fn
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (120, 160, 3),
                                    dtype=np.uint8)).save(str(p))
        info = {'dataset': 'camtrap', 'location': str(loc),
                'class': 'deer' if i % 3 else 'bear',
                'label': [LABELS[0] if i % 3 else LABELS[1]]}
        if i == 11:
            info['bbox'] = [[0.2, 0.2, 0.3, 0.3]]
        queried[fn] = info
        det_images.append({'file': fn, 'detections': [
            {'category': '1', 'conf': 0.95, 'bbox': [0.1, 0.1, 0.5, 0.6]},
            {'category': '1', 'conf': 0.85 - 0.01 * i,
             'bbox': [0.5, 0.3, 0.3, 0.4]},
            {'category': '2', 'conf': 0.9, 'bbox': [0.0, 0.5, 0.2, 0.2]},
            {'category': '1', 'conf': 0.3, 'bbox': [0.6, 0.2, 0.2, 0.2]}]})
    detections = {'images': det_images,
                  'detection_categories': {'1': 'animal', '2': 'person'},
                  'info': {'format_version': '1.6',
                           'detector': 'md_v5a.0.0.pt'}}
    det_path = str(base / 'detections.json')
    ct_utils.write_json(det_path, detections)
    queried_path = str(base / 'queried_images.json')
    ct_utils.write_json(queried_path, queried)
    crops_dir = str(base / 'crops')
    n_crops, failed = crop_detections(det_path, crops_dir, str(images_dir),
                                      threshold=0.5, square_crops=True,
                                      logdir=str(base))
    assert failed == [] and n_crops == 36
    # the ground-truth box's crop, under its name without a version
    gt = 'camtrap/loc5/im_11.jpg___crop00.jpg'
    shutil.copy(os.path.join(crops_dir,
                             'camtrap/loc5/im_11.jpg___crop00_mdv5a.0.0.jpg'),
                os.path.join(crops_dir, gt))
    cache = base / 'cache' / 'v5a.0.0'
    cache.mkdir(parents=True)
    # the cache names each dataset's images relative to the dataset
    ct_utils.write_json(str(cache / 'camtrap.json'), dict(
        detections, images=[dict(im, file=im['file'].split('/', 1)[1])
                            for im in det_images]))
    return {'base': base, 'detections': det_path, 'queried': queried_path,
            'crops': crops_dir, 'cache': str(base / 'cache')}


def _tree(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), 'rb') as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize('seed,fractions,threshold', [
    (0, (0.7, 0.15, 0.15), 0.0), (3, (0.5, 0.25, 0.25), 0.8)])
def test_dataset_files_identical_to_jax(world, tmp_path, seed, fractions,
                                        threshold):
    outs = []
    for name, module in (('ours', ccd), ('ref', jax_ccd)):
        folder = str(tmp_path / name)
        module.create_classification_dataset(
            world['queried'], world['crops'], folder,
            detections_json=world['detections'],
            confidence_threshold=threshold, split_fractions=fractions,
            seed=seed)
        outs.append(_tree(folder))
    assert sorted(outs[0]) == ['classification_ds.csv', 'label_index.json',
                               'splits.json']
    assert outs[0] == outs[1]
    rows = ccd.load_dataset_csv(str(tmp_path / 'ours' /
                                    'classification_ds.csv'))
    assert rows == jax_ccd.load_dataset_csv(str(tmp_path / 'ref' /
                                                'classification_ds.csv'))
    assert len(rows) >= 12


def test_classification_csv_and_splits_identical_to_jax(world):
    frames = [module.create_classification_csv(
        world['queried'], world['cache'], '5a.0.0', world['crops'], 0.5,
        min_locs=2, exclude_locs=[('camtrap', '4')])
        for module in (ccd, jax_ccd)]
    (df, log), (ref_df, ref_log) = frames
    assert log == ref_log
    assert df.equals(ref_df) and len(df) > 0
    for kwargs in ({'val_frac': 0.2, 'test_frac': 0.2},
                   {'val_frac': 0.3}):
        assert ccd.create_splits_random(
            df, n_iterations=200, seed=4, **kwargs) == \
            jax_ccd.create_splits_random(df, n_iterations=200, seed=4,
                                         **kwargs)
        assert ccd.create_splits_smallest_label_first(df, **kwargs) == \
            jax_ccd.create_splits_smallest_label_first(df, **kwargs)
    sizes = {('a', '1'): 3, ('b', '2'): 1, ('a', '3'): 2}
    assert ccd.sort_locs_by_size(dict(sizes), prioritize=['b']) == \
        jax_ccd.sort_locs_by_size(dict(sizes), prioritize=['b'])


@pytest.fixture(scope='module')
def evaluation(world, tmp_path_factory):
    """(dataset dir, classifier checkpoint, the port's and JAX's output
    dirs and returned rows)."""

    root = tmp_path_factory.mktemp('torch_evaluate')
    ds_dir = str(root / 'dataset')
    ccd.create_classification_dataset(
        world['queried'], world['crops'], ds_dir,
        detections_json=world['detections'], confidence_threshold=0.5,
        split_fractions=(0.5, 0.25, 0.25), seed=1)
    cfg = jax_effnet.EfficientNetConfig('efficientnetv2_test',
                                        num_classes=3)
    ckpt = str(root / 'classifier.npz')
    save_checkpoint(jax_effnet.init_params(cfg, seed=3), ckpt, {
        'arch': 'efficientnetv2_test', 'num_classes': 3,
        'class_names': ['other', 'ursid', 'cervid'], 'image_size': 64})
    out = {}
    for name, module, kwargs in (('ours', em, {'device': 'cpu'}),
                                 ('ref', jax_em, {})):
        folder = str(root / name)
        rows = module.evaluate_model(ckpt, ds_dir, world['crops'], folder,
                                     batch_size=4, **kwargs)
        out[name] = (folder, rows)
    return ds_dir, ckpt, out


def _outputs(path):
    with open(path) as f:
        header = f.readline().strip().split(',')
        rows = [line.strip().split(',') for line in f]
    return header, rows


def test_evaluate_model_matches_jax(evaluation):
    _, _, out = evaluation
    (ours_dir, ours_rows), (ref_dir, ref_rows) = out['ours'], out['ref']
    ours, ref = _tree(ours_dir), _tree(ref_dir)
    assert sorted(ours) == sorted(ref)
    outputs = [n for n in ours if n.startswith('outputs_')]
    assert len(outputs) >= 2
    for name in outputs:
        h, rows = _outputs(os.path.join(ours_dir, name))
        ref_h, ref_rows_csv = _outputs(os.path.join(ref_dir, name))
        assert h == ref_h == ['path', 'label', 'weight', 'cervid', 'ursid']
        assert [r[:3] for r in rows] == [r[:3] for r in ref_rows_csv]
        p = np.asarray([r[3:] for r in rows], np.float64)
        ref_p = np.asarray([r[3:] for r in ref_rows_csv], np.float64)
        assert np.abs(p - ref_p).max() <= 1e-5
        assert (p.argmax(1) == ref_p.argmax(1)).all()
    # the same predictions: the same confusion matrices and statistics
    with np.load(os.path.join(ours_dir, 'confusion_matrices.npz')) as a, \
            np.load(os.path.join(ref_dir, 'confusion_matrices.npz')) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k])
    assert ours['label_stats.csv'] == ref['label_stats.csv']
    assert len(ours_rows) == len(ref_rows)
    for a, b in zip(ours_rows, ref_rows):
        assert sorted(a) == sorted(b)
        for k in a:
            if k == 'split':
                assert a[k] == b[k]
            elif k.startswith('acc'):
                assert a[k] == b[k], k
            else:
                assert abs(a[k] - b[k]) <= 1e-5, k


def test_given_jax_probabilities_every_file_is_jax_s(evaluation, world,
                                                     tmp_path, monkeypatch):
    """The host code after the classifier: with JAX's _predict_rows in
    place of the port's, every file is byte-identical."""

    ds_dir, ckpt, out = evaluation
    monkeypatch.setattr(em, '_predict_rows', jax_em._predict_rows)
    from megadetector_tpu.models import classifier as jax_classifier
    monkeypatch.setattr(
        'megadetector_tpu_torch.models.classifier.SpeciesClassifier',
        lambda path, device=None: jax_classifier.SpeciesClassifier(path))
    folder = str(tmp_path / 'given')
    rows = em.evaluate_model(ckpt, ds_dir, world['crops'], folder,
                             batch_size=4, device='cpu')
    assert rows == out['ref'][1]
    assert _tree(folder) == _tree(out['ref'][0])


def test_trace_model_matches_the_jax_program(evaluation, tmp_path):
    """The port's traced classifier against JAX's deserialized program on
    the same checkpoint and input, within the classifier float bar
    (rtol 1e-4, atol 1e-4 * max|ref|)."""

    from jax import export as jax_export

    _, ckpt, _ = evaluation
    paths = []
    for name in ('ours', 'ref'):
        path = str(tmp_path / '{}.npz'.format(name))
        shutil.copyfile(ckpt, path)
        paths.append(path)
    ours = torch.export.load(em.trace_model('efficientnetv2_test', paths[0],
                                            3, 64, device='cpu'))
    with open(jax_em.trace_model('efficientnetv2_test', paths[1], 3, 64),
              'rb') as f:
        ref = jax_export.deserialize(bytearray(f.read()))
    x = np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32)
    got = ours.module()(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.call(x))
    assert got.shape == want.shape == (1, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_metric_helpers_match_jax():
    rng = np.random.RandomState(0)
    cm = rng.randint(0, 5, (4, 4))
    cm[2] = 0
    names = ['a', 'b', 'c', 'd']
    ours, ref = em.calc_per_label_stats(cm, names), \
        jax_em.calc_per_label_stats(cm, names)
    assert ours.equals(ref)
    probs = rng.dirichlet(np.ones(5), 30)
    labels = rng.randint(0, 5, 30)
    weights = rng.uniform(0.5, 2, 30)
    for k in (1, 3):
        assert em._topk_accuracy(probs, labels, weights, k) == \
            jax_em._topk_accuracy(probs, labels, weights, k)
    assert em.check_override({'x': 1}, 'x', None) == 1


def test_cli_and_trace_model(evaluation, world, tmp_path, capsys):
    ds_dir, ckpt, out = evaluation
    folder = str(tmp_path / 'cli')
    em.main([ckpt, ds_dir, '--cropped_images_dir', world['crops'],
             '--output_dir', folder, '--batch_size', '4', '--device',
             'cpu'])
    assert _tree(folder) == _tree(out['ours'][0])
    cli_ds = str(tmp_path / 'cli_ds')
    ccd.main([cli_ds, '--queried_images_json', world['queried'],
              '--cropped_images_dir', world['crops'], '--detections_json',
              world['detections'], '--val_frac', '0.25', '--test_frac',
              '0.25', '--seed', '1', '--confidence_threshold', '0.5'])
    assert _tree(cli_ds) == _tree(ds_dir)
    # trace_model writes <root>_compiled<ext> and its sidecar, and reuses
    # them for the same request on an unchanged checkpoint
    copy = str(tmp_path / 'traced.npz')
    shutil.copyfile(ckpt, copy)
    compiled = em.trace_model('efficientnetv2_test', copy, 3, 64,
                              device='cpu')
    assert compiled == str(tmp_path / 'traced_compiled.npz')
    with open(str(tmp_path / 'traced_compiled.trace.json')) as f:
        assert json.load(f) == {
            'model_name': 'efficientnetv2_test', 'num_classes': 3,
            'img_size': 64, 'ckpt_mtime': os.path.getmtime(copy),
            'platform': 'cpu'}
    stamp = os.path.getmtime(compiled)
    assert em.trace_model('efficientnetv2_test', copy, 3, 64,
                          device='cpu') == compiled
    assert os.path.getmtime(compiled) == stamp
    program = torch.export.load(compiled)
    assert tuple(program.module()(torch.zeros(1, 64, 64, 3)).shape) == (1, 3)
    capsys.readouterr()
    with open(os.path.join(ds_dir, 'label_index.json')) as f:
        assert sorted(json.load(f).values()) == sorted(LABELS)
