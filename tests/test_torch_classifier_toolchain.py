"""
The port's classifier-training chain as a whole against the JAX package's
(tests/test_classifier_toolchain.py test_full_toolchain_round_trip), on
the same world at 64 px: the label spec through csv_to_json and
json_validator's sampling, crops cut from a detections file, the dataset
CSV with location splits, one Adam step of efficientnetv2_s, the
evaluation, the review of mislabeled candidates and the merge into the
detections file. Every file up to the dataset is byte for byte JAX's; the
step's loss within rtol 1e-5; the evaluation's probabilities and the
merged classifications within the MD golden tolerance on confidences
(CONF_TOL, as tests/torch_port_data.py sets max_conf_error). The port
runs with device='cpu'.
"""

import csv
import json
import os
import re
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_cct_data as cd  # noqa: E402

ARCH = 'efficientnetv2_s'
SIZE = 64
CONF_TOL = 0.005
SPEC_CSV = ('output_label,type,content\n'
            'cervid,row,camtrap|deer\n'
            'ursid,row,camtrap|bear\n'
            'ursid,max_count,3\n'
            'ursid,prioritize,"[[\'camtrap\']]"\n')


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """test_full_toolchain_round_trip's world: 8 images of 2 classes over
    4 locations, two detections an image (one below the crop threshold),
    the local image source."""

    base = tmp_path_factory.mktemp('toolchain_world')
    images_dir = base / 'images'
    rng = np.random.RandomState(0)
    queried, det_images = {}, []
    for i in range(8):
        fn = 'camtrap/loc{}/im_{}.jpg'.format(i % 4, i)
        p = images_dir / fn
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (120, 160, 3),
                                    dtype=np.uint8)).save(str(p))
        queried[fn] = {'dataset': 'camtrap', 'location': str(i % 4),
                       'class': 'deer' if i % 2 == 0 else 'bear'}
        det_images.append({'file': fn, 'detections': [
            {'category': '1', 'conf': 0.95, 'bbox': [0.1, 0.1, 0.5, 0.6]},
            {'category': '1', 'conf': 0.3, 'bbox': [0.6, 0.2, 0.2, 0.2]}]})
    paths = {'images': str(images_dir),
             'detections': str(base / 'detections.json'),
             'source': str(base / 'image_source.json'),
             'spec_csv': str(base / 'spec.csv')}
    with open(paths['detections'], 'w') as f:
        json.dump({'images': det_images,
                   'detection_categories': {'1': 'animal'},
                   'info': {'format_version': '1.6',
                            'detector': 'md_v5a.0.0.pt'}}, f, indent=1)
    with open(paths['source'], 'w') as f:
        json.dump(queried, f, indent=1)
    with open(paths['spec_csv'], 'w') as f:
        f.write(SPEC_CSV)
    return paths


def _train_step_jax(label_names, images, labels, path):
    import jax
    import jax.numpy as jnp
    import optax

    from megadetector_tpu.models import efficientnet
    from megadetector_tpu.models.convert_weights import save_checkpoint
    from megadetector_tpu.training.train_classifier import make_train_step

    config = efficientnet.EfficientNetConfig(ARCH, len(label_names), SIZE)
    params = jax.tree_util.tree_map(jnp.asarray, efficientnet.init_params(
        config, seed=0, train_init=True))
    optimizer = optax.adam(1e-3)
    state = optimizer.init(params)
    params, _, metrics = jax.jit(make_train_step(config, optimizer))(
        params, state, images, labels)
    save_checkpoint(jax.tree_util.tree_map(np.asarray, params), path, {
        'arch': ARCH, 'num_classes': len(label_names),
        'class_names': label_names, 'image_size': SIZE})
    return float(metrics['loss'])


def _train_step_port(label_names, images, labels, path):
    import torch

    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.convert_weights import save_checkpoint
    from megadetector_tpu_torch.training import optim
    from megadetector_tpu_torch.training import train_classifier as tc

    config = efficientnet.EfficientNetConfig(ARCH, len(label_names), SIZE)
    model = tc.make_classifier(config, efficientnet.init_params(
        config, seed=0, train_init=True), 'cpu', torch.float32)
    optimizer = optim.Optimizer(model.parameters(), optim.adam(1e-3))
    metrics = tc.make_train_step(config, model, optimizer)(images, labels)
    save_checkpoint(model.export_params(), path, {
        'arch': ARCH, 'num_classes': len(label_names),
        'class_names': label_names, 'image_size': SIZE})
    return float(metrics['loss'])


def _unstamp(folder):
    """Log files under [folder] renamed without the time they were
    written (<name>_YYYYmmdd_HHMMSS.json -> <name>.json)."""

    for name in os.listdir(folder):
        plain = re.sub(r'_\d{8}_\d{6}(\.json)$', r'\1', name)
        if plain != name:
            os.rename(os.path.join(folder, name),
                      os.path.join(folder, plain))


def _chain(side, world, out):
    """The whole chain in one package ([side] 0: JAX, 1: the port) into
    [out]; returns {step: value} of what is compared."""

    import cv2

    package = ('megadetector_tpu', 'megadetector_tpu_torch')[side]

    def module(name):
        return __import__('{}.classification.{}'.format(package, name),
                          fromlist=[name])

    spec = module('csv_to_json').csv_to_jsondict(world['spec_csv'])
    spec = {k: module('csv_to_json').order_spec_dict(v)
            for k, v in spec.items()}
    spec_path = os.path.join(out, 'label_spec.json')
    with open(spec_path, 'w') as f:
        json.dump(spec, f)
    validator_dir = os.path.join(out, 'validator')
    queried = module('json_validator').run_validator(
        spec_path, world['source'], output_dir=validator_dir,
        images_dir=world['images'])
    _unstamp(validator_dir)

    crops_dir = os.path.join(out, 'crops')
    n_crops, failed = module('crop_detections').crop_detections(
        world['detections'], crops_dir, world['images'], threshold=0.8,
        square_crops=True, logdir=os.path.join(out, 'crop_log'))
    _unstamp(os.path.join(out, 'crop_log'))
    ccd = module('create_classification_dataset')
    ds_dir = os.path.join(out, 'dataset')
    ccd.create_classification_dataset(
        os.path.join(validator_dir, 'queried_images.json'), crops_dir,
        ds_dir, detections_json=world['detections'],
        detector_version='5a.0.0', confidence_threshold=0.8,
        split_fractions=(0.5, 0.25, 0.25))
    rows = ccd.load_dataset_csv(os.path.join(ds_dir,
                                             'classification_ds.csv'))
    with open(os.path.join(ds_dir, 'label_index.json')) as f:
        label_index = json.load(f)
    label_names = [label_index[str(i)] for i in range(len(label_index))]
    name_to_id = {n: i for i, n in enumerate(label_names)}
    images = np.stack([cv2.resize(np.asarray(Image.open(os.path.join(
        crops_dir, r['path'])).convert('RGB')), (SIZE, SIZE))
        for r in rows[:4]]).astype(np.uint8)
    labels = np.asarray([name_to_id[r['label']] for r in rows[:4]],
                        np.int32)

    ckpt = os.path.join(out, 'classifier.npz')
    loss = (_train_step_jax, _train_step_port)[side](
        label_names, images, labels, ckpt)

    eval_dir = os.path.join(out, 'eval')
    kwargs = {'device': 'cpu'} if side else {}
    module('evaluate_model').evaluate_model(ckpt, ds_dir, crops_dir,
                                            eval_dir, batch_size=4,
                                            **kwargs)
    outputs = sorted(f for f in os.listdir(eval_dir)
                     if f.startswith('outputs_'))
    candidates = module('identify_mislabeled_candidates') \
        .identify_mislabeled_candidates(
            os.path.join(eval_dir, outputs[0]), 'train',
            os.path.join(out, 'candidates'), margin=0.0)
    merged = module('merge_classification_detection_output') \
        .merge_classification_detection_output(
            os.path.join(eval_dir, outputs[0]), world['detections'],
            os.path.join(out, 'merged.json'),
            label_index_path=os.path.join(ds_dir, 'label_index.json'),
            classifier_name='test_classifier')
    return {'queried': queried, 'crops': (n_crops, failed), 'loss': loss,
            'outputs': outputs, 'merged': merged, 'eval_dir': eval_dir,
            'candidates': candidates}


@pytest.fixture(scope='module')
def chains(world, tmp_path_factory):
    root = tmp_path_factory.mktemp('toolchain')
    return cd.both(root, 'chain', lambda side, out: _chain(side, world,
                                                           out))


@pytest.mark.parametrize('folder', ['validator', 'crops', 'crop_log',
                                    'dataset'])
def test_files_identical_to_jax(chains, folder):
    (ours, got), (ref, want) = chains
    assert ours['queried'] == ref['queried'] and len(ours['queried']) == 7
    assert ours['crops'] == ref['crops'] == (8, [])
    cd.assert_same_tree(os.path.join(got, folder),
                        os.path.join(want, folder))


def test_train_step_loss_within_rtol(chains):
    (ours, _), (ref, _) = chains
    assert np.isfinite(ours['loss'])
    np.testing.assert_allclose(ours['loss'], ref['loss'], rtol=1e-5)


def _csv_rows(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


def test_evaluation_within_conf_tol(chains):
    (ours, got), (ref, want) = chains
    assert ours['outputs'] == ref['outputs'] and ours['outputs']
    for name in ours['outputs']:
        a = _csv_rows(os.path.join(ours['eval_dir'], name))
        b = _csv_rows(os.path.join(ref['eval_dir'], name))
        assert a[0] == b[0] and len(a) == len(b) > 1
        for row_a, row_b in zip(a[1:], b[1:]):
            assert row_a[:3] == row_b[:3]
            np.testing.assert_allclose(np.float64(row_a[3:]),
                                       np.float64(row_b[3:]), rtol=0,
                                       atol=CONF_TOL)


def test_merged_classifications_within_conf_tol(chains):
    (ours, got), (ref, want) = chains
    a, b = ours['merged'], ref['merged']
    assert a['classification_categories'] == b['classification_categories']
    assert [im['file'] for im in a['images']] == \
        [im['file'] for im in b['images']]
    n = 0
    for im_a, im_b in zip(a['images'], b['images']):
        for d_a, d_b in zip(im_a['detections'], im_b['detections']):
            assert ('classifications' in d_a) == ('classifications' in d_b)
            if 'classifications' not in d_a:
                continue
            n += 1
            # near-tied labels may swap places: compare by category
            got_c, want_c = dict(d_a['classifications']), \
                dict(d_b['classifications'])
            assert sorted(got_c) == sorted(want_c)
            for k in want_c:
                assert abs(got_c[k] - want_c[k]) <= CONF_TOL
    # one classified detection a row of the merged outputs CSV
    assert n == len(_csv_rows(os.path.join(ours['eval_dir'],
                                           ours['outputs'][0]))) - 1 > 0
    assert sorted(ours['candidates']) == sorted(ref['candidates'])
