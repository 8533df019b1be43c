"""
The port's data-parallel train steps on CPU meshes
(training/train_detector.make_sharded_detector_train_step,
training/train_classifier.make_sharded_train_step, the trainers' mesh and
classification/train_classifier's prep_device and run_epoch batch_multiple):

- within the port, each sharded step on 2 replicas against the unsharded
  step on the same batch: the loss within rtol 1e-6 at every step, the
  parameters after 3 Adam steps within rtol 1e-5 (with atol 1e-5 *
  max|ref| of each tensor: Adam's first steps move a parameter by about
  lr whatever its gradient's size, so a gradient that rounds differently
  near zero moves a parameter near zero by a relative amount far above
  any rtol; measured 1.2e-6 * max|ref| on this case); one replica gives
  the unsharded step's bits;
- a batch whose targets all lie in the first shard: the sharded step is
  the unsharded one, where each shard normalizing by its own positives
  and size is not;
- two sharded runs give the same bits;
- against the JAX package's sharded steps on its 8 virtual CPU devices
  (tests/conftest.py), the port on a mesh of 8 CPU replicas, at the
  bars of tests/test_torch_train.py against JAX (loss rtol 1e-5,
  parameters rtol 1e-4 with atol 1e-4 * max|ref|);
- prep_device and run_epoch(batch_multiple=...) against JAX's, train()
  with options.mesh and main() over prep_device's mesh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from megadetector_tpu.models import efficientnet as jax_eff
from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu.parallel import mesh as jax_mesh
from megadetector_tpu.training import train_classifier as jax_tc
from megadetector_tpu.training import train_detector as jax_td
from megadetector_tpu_torch.models import efficientnet, yolov5
from megadetector_tpu_torch.parallel.mesh import make_data_mesh
from megadetector_tpu_torch.training import optim
from megadetector_tpu_torch.training import train_classifier as tc
from megadetector_tpu_torch.training import train_detector as td

SIZE = 128


def _cpu_mesh(n):
    return make_data_mesh(devices=['cpu'] * n)


def _detector_targets(b, first_shard_only=False):
    """[b] images' targets: edges, the border, a shared cell, padded slots;
    with [first_shard_only] only the first half of the batch has any."""

    pool = [np.array([[0.5, 0.5, 0.3, 0.25], [0.25, 0.75, 0.1, 0.2],
                      [0.03, 0.97, 0.05, 0.05]]),
            np.array([[0.62, 0.41, 0.2, 0.3], [0.625, 0.405, 0.12, 0.1]]),
            np.array([[0.31, 0.52, 0.6, 0.5]]),
            np.array([[0.8, 0.2, 0.15, 0.1], [0.4, 0.6, 0.5, 0.05]])]
    boxes, classes = [], []
    for i in range(b):
        if first_shard_only and i >= b // 2:
            boxes.append(np.zeros((0, 4)))
            classes.append(np.zeros((0,), np.int32))
            continue
        bx = pool[i % len(pool)]
        boxes.append(bx)
        classes.append(np.arange(len(bx)) % 3)
    return td.pad_targets(boxes, classes, max_targets=4)


def _detector_case(b, seed=1, first_shard_only=False):
    cfg = jax_yolov5.YoloV5Config('yolov5n', num_classes=3)
    params = jax_yolov5.init_params(cfg, seed=0)
    images = np.random.RandomState(seed).randint(
        0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8)
    return cfg, params, images, _detector_targets(b, first_shard_only)


def _port_detector_step(params, mesh=None, dtype=torch.float32):
    cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
    model = yolov5.YoloV5(cfg).load_params(params)
    opt = optim.Optimizer(model.parameters(), optim.chain(
        optim.clip_by_global_norm(5.0), optim.adam(1e-3)))
    if mesh is None:
        return model, td.make_detector_train_step(cfg, model, opt, dtype)
    return model, td.make_sharded_detector_train_step(
        cfg, model, opt, mesh, compute_dtype=dtype)


def _leaves(tree):
    return [(jax.tree_util.keystr(k), np.asarray(v))
            for k, v in jax.tree_util.tree_leaves_with_path(tree)]


def _assert_params_close(ours, ref, rtol, atol_frac):
    ours = dict(_leaves(ours))
    for k, r in _leaves(ref):
        np.testing.assert_allclose(ours[k], r, rtol=rtol,
                                   atol=atol_frac * np.abs(r).max(),
                                   err_msg=k)


def _run_detector(params, images, targets, mesh, steps=3):
    model, step = _port_detector_step(params, mesh)
    metrics = [step(images, *targets) for _ in range(steps)]
    return metrics, model.export_params()


@pytest.fixture(scope='module')
def detector_runs():
    """The unsharded port step and the 2-replica step, 3 steps each."""

    cfg, params, images, targets = _detector_case(4)
    return (_run_detector(params, images, targets, None),
            _run_detector(params, images, targets, _cpu_mesh(2)))


def test_sharded_detector_step_matches_the_unsharded_step(detector_runs):
    (m_ref, p_ref), (m_ours, p_ours) = detector_runs
    for a, b in zip(m_ours, m_ref):
        for k in ('loss', 'box_loss', 'obj_loss', 'cls_loss'):
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-6,
                                       err_msg=k)
        assert float(a['n_positives']) == float(b['n_positives']) > 0
    _assert_params_close(p_ours, p_ref, 1e-5, 1e-5)


def test_sharded_detector_step_on_one_replica_is_the_unsharded_step(
        detector_runs):
    cfg, params, images, targets = _detector_case(4)
    (m_ref, p_ref), _ = detector_runs
    m_one, p_one = _run_detector(params, images, targets, _cpu_mesh(1))
    for a, b in zip(m_one, m_ref):
        assert all(float(a[k]) == float(b[k]) for k in a)
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(
        _leaves(p_one), _leaves(p_ref)))


def test_targets_in_one_shard_are_normalized_over_the_whole_batch():
    """All of the batch's targets lie in shard 0: each level's positives,
    the objectness mean and the loss's batch scale must still be the whole
    batch's. Shards that normalized by their own positives and size would
    give another loss (checked here too)."""

    cfg, params, images, targets = _detector_case(4, first_shard_only=True)
    m_ref, p_ref = _run_detector(params, images, targets, None, steps=2)
    m_ours, p_ours = _run_detector(params, images, targets, _cpu_mesh(2),
                                   steps=2)
    for a, b in zip(m_ours, m_ref):
        np.testing.assert_allclose(float(a['loss']), float(b['loss']),
                                   rtol=1e-6)
    _assert_params_close(p_ours, p_ref, 1e-5, 1e-5)

    # Per-shard normalization, for contrast: far from the whole batch's
    model = yolov5.YoloV5(yolov5.YoloV5Config('yolov5n', 3)).load_params(
        params).set_training(torch.float32)
    x = torch.from_numpy(images).float() / 255.0
    t = [torch.from_numpy(a) for a in targets]
    with torch.no_grad():
        per_shard = sum(float(td.detection_loss(
            model.config, model, x[i:i + 2], t[0][i:i + 2],
            t[1][i:i + 2].long(), t[2][i:i + 2])[0]) for i in (0, 2))
    assert abs(per_shard / float(m_ref[0]['loss']) - 1) > 1e-2


def test_sharded_steps_give_the_same_bits_every_run(detector_runs):
    cfg, params, images, targets = _detector_case(4)
    _, (m_first, p_first) = detector_runs
    m_again, p_again = _run_detector(params, images, targets, _cpu_mesh(2))
    for a, b in zip(m_again, m_first):
        assert all(float(a[k]) == float(b[k]) for k in a)
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(
        _leaves(p_again), _leaves(p_first)))
    first = _classifier_run(_cpu_mesh(2))
    again = _classifier_run(_cpu_mesh(2))
    assert [float(m['loss']) for m in first[0]] == \
        [float(m['loss']) for m in again[0]]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(
        _leaves(first[1]), _leaves(again[1])))


def test_sharded_steps_refuse_uneven_batches_and_other_axes():
    cfg, params, images, targets = _detector_case(3)
    _, step = _port_detector_step(params, _cpu_mesh(2))
    with pytest.raises(ValueError, match='equal'):
        step(images, *targets)
    with pytest.raises(ValueError, match='axis'):
        model = yolov5.YoloV5(yolov5.YoloV5Config('yolov5n', 3))
        td.make_sharded_detector_train_step(
            model.config, model, optim.Optimizer(model.parameters(),
                                                 optim.adam(1e-3)),
            _cpu_mesh(2), batch_axis='model')


@pytest.mark.parametrize('family', ['detector', 'classifier'])
def test_sharded_steps_refuse_a_model_off_the_first_device(family):
    """The optimizer steps the caller's model, so it must be the first
    replica: a model on another device than the mesh's first (the CPU
    under a 'meta' mesh here) would have its gradients summed onto a copy
    and be stepped with none."""

    mesh = make_data_mesh(devices=['meta', 'cpu'])
    if family == 'detector':
        model = yolov5.YoloV5(yolov5.YoloV5Config('yolov5n', 3))
        make = td.make_sharded_detector_train_step
    else:
        model = efficientnet.EfficientNet(efficientnet.EfficientNetConfig(
            'efficientnetv2_test', num_classes=4, image_size=32))
        make = tc.make_sharded_train_step
    optimizer = optim.Optimizer(model.parameters(), optim.adam(1e-3))
    with pytest.raises(ValueError, match="mesh's first device, meta"):
        make(model.config, model, optimizer, mesh)
    # On the first device it builds
    make(model.config, model, optimizer, _cpu_mesh(2))


def _classifier_case(b=8, seed=0):
    cfg = jax_eff.EfficientNetConfig('efficientnetv2_test', num_classes=4,
                                     image_size=32)
    params = jax_eff.init_params(cfg, seed=seed, train_init=False)
    rng = np.random.RandomState(seed + 10)
    images = rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, b).astype(np.int32)
    return cfg, params, images, labels


def _classifier_run(mesh, steps=3, b=8, dtype=torch.float32):
    _, params, images, labels = _classifier_case(b)
    cfg = efficientnet.EfficientNetConfig('efficientnetv2_test', 4, 32)
    model = tc.make_classifier(cfg, params, 'cpu', dtype)
    opt = optim.Optimizer(model.parameters(), optim.chain(
        optim.clip_by_global_norm(1.0), optim.adamw(1e-3, weight_decay=1e-5)))
    if mesh is None:
        step = tc.make_train_step(cfg, model, opt, 0.1, dtype)
    else:
        step = tc.make_sharded_train_step(cfg, model, opt, mesh,
                                          label_smoothing=0.1,
                                          compute_dtype=dtype)
    metrics = [step(images, labels) for _ in range(steps)]
    return metrics, model.export_params()


@pytest.mark.parametrize('n', [1, 2])
def test_sharded_classifier_step_matches_the_unsharded_step(n):
    m_ref, p_ref = _classifier_run(None)
    m_ours, p_ours = _classifier_run(_cpu_mesh(n))
    for a, b in zip(m_ours, m_ref):
        np.testing.assert_allclose(float(a['loss']), float(b['loss']),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(a['accuracy']),
                                   float(b['accuracy']), rtol=1e-6)
    _assert_params_close(p_ours, p_ref, 1e-5, 1e-5)
    if n == 1:
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(
            _leaves(p_ours), _leaves(p_ref)))


def test_sharded_detector_step_matches_jax_on_8_devices():
    cfg, params, images, targets = _detector_case(8)
    mesh = jax_mesh.make_data_mesh(8)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p_j)
    step_j = jax_td.make_sharded_detector_train_step(cfg, tx, mesh)
    model, step_t = _port_detector_step(params, _cpu_mesh(8))
    for _ in range(3):
        p_j, state, m_j = step_j(p_j, state, images, *targets)
        m_t = step_t(images, *targets)
        np.testing.assert_allclose(float(m_t['loss']), float(m_j['loss']),
                                   rtol=1e-5)
        assert float(m_t['n_positives']) == float(m_j['n_positives'])
    _assert_params_close(model.export_params(), p_j, 1e-4, 1e-4)


def test_sharded_classifier_step_matches_jax_on_8_devices():
    cfg, params, images, labels = _classifier_case(8)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-3, weight_decay=1e-5))
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p_j)
    step_j = jax_tc.make_sharded_train_step(
        cfg, tx, jax_mesh.make_data_mesh(8), label_smoothing=0.1)
    metrics, p_t = _classifier_run(_cpu_mesh(8))
    for m_t in metrics:
        p_j, state, m_j = step_j(p_j, state, images, labels)
        np.testing.assert_allclose(float(m_t['loss']), float(m_j['loss']),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m_t['accuracy']),
                                   float(m_j['accuracy']), rtol=1e-6)
    _assert_params_close(p_t, p_j, 1e-4, 1e-4)


def _crop_folder(root, n=8, size=40):
    from PIL import Image
    rng = np.random.RandomState(5)
    for i in range(n):
        label = ('bear', 'deer')[i % 2]
        (root / label).mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (size, size, 3),
                                    dtype=np.uint8)).save(
            str(root / label / '{}.png'.format(i)))
    return str(root)


def test_train_with_options_mesh_matches_train_without(tmp_path):
    folder = _crop_folder(tmp_path / 'crops')
    results = []
    for mesh in (None, _cpu_mesh(2)):
        options = tc.TrainingOptions()
        options.arch = 'efficientnetv2_test'
        options.image_size = 32
        options.batch_size = 4
        options.num_epochs = 2
        options.log_every = 1
        options.device = 'cpu'
        options.mesh = mesh
        model, history = tc.train(folder, str(tmp_path / 'c{}.npz'.format(
            0 if mesh is None else 2)), options)
        results.append((history, model.export_params()))
    (h_ref, p_ref), (h_ours, p_ours) = results
    assert [h['step'] for h in h_ours] == [h['step'] for h in h_ref] == \
        [1, 2, 3, 4]
    for a, b in zip(h_ours, h_ref):
        np.testing.assert_allclose(a['loss'], b['loss'], rtol=1e-6)
    # Four steps from train_init's zero head, whose biases are then a few
    # Adam steps of lr from 0: held at test_torch_train.py's bar against
    # JAX (measured 1.3e-4 relative, 4.7e-5 * max|ref| on the head's bias)
    _assert_params_close(p_ours, p_ref, 1e-4, 1e-4)
    assert tc.TrainingOptions().batch_axis == \
        jax_tc.TrainingOptions().batch_axis


@pytest.mark.parametrize('device_id', [None, 3])
def test_prep_device_matches_jax(monkeypatch, capsys, device_id):
    """With torch.cuda.device_count patched to 8, as JAX's 8 virtual
    devices: the same device choice, mesh size and first line printed; the
    second names the platform (cuda here, cpu for JAX's CPU devices)."""

    from megadetector_tpu.classification import train_classifier as jax_ctc
    from megadetector_tpu_torch.classification import train_classifier \
        as ctc
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 8)
    devices, mesh = ctc.prep_device(device_id)
    ours = capsys.readouterr().out.splitlines()
    jax_devices, jax_mesh_ = jax_ctc.prep_device(device_id)
    ref = capsys.readouterr().out.splitlines()
    assert [d.index for d in devices] == [d.id for d in jax_devices]
    assert all(d.type == 'cuda' for d in devices)
    assert (mesh is None) == (jax_mesh_ is None)
    if mesh is not None:
        assert mesh.devices.size == jax_mesh_.devices.size == 8
        assert mesh.axis_names == jax_mesh_.axis_names
    assert ours[:-1] == ref[:-1]
    assert ours[-1] == ref[-1].replace('(cpu)', '(cuda)')
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(RuntimeError):
        ctc.prep_device()


@pytest.mark.parametrize('batch_multiple', [None, 2, 4])
def test_run_epoch_batch_multiple_matches_jax(batch_multiple):
    from megadetector_tpu.classification import train_classifier as jax_ctc
    from megadetector_tpu_torch.classification import train_classifier \
        as ctc
    sizes = [4, 4, 3, 2, 6]

    def loader():
        for i, n in enumerate(sizes):
            yield (np.zeros((n, 2, 2, 3), np.float32),
                   np.arange(n) % 2, np.ones(n), ['f'] * n)

    seen_ours, seen_ref = [], []

    def step_ours(imgs, labels):
        seen_ours.append(len(labels))
        return {'loss': 0.1 * len(labels), 'accuracy': 0.5}

    def step_ref(params, opt_state, imgs, labels):
        seen_ref.append(len(labels))
        return params, opt_state, {'loss': 0.1 * len(labels),
                                   'accuracy': 0.5}

    ours = ctc.run_epoch(step_ours, loader, 2, train=True,
                         batch_multiple=batch_multiple)
    _, _, ref = jax_ctc.run_epoch(step_ref, None, None, loader, 2,
                                  train=True, batch_multiple=batch_multiple)
    assert seen_ours == seen_ref
    for k in ('loss', 'acc_top1'):
        assert ours[k].avg == ref[k].avg and ours[k].count == ref[k].count


def test_classification_main_trains_over_prep_devices_mesh(tmp_path,
                                                           monkeypatch):
    """main() with no device trains over prep_device's mesh (here a CPU
    mesh of 2 stood in for two cards) and writes what the single-device
    run writes within the sharded bar; a batch size the mesh does not
    divide falls back to one device, as in the JAX main."""

    import json
    from PIL import Image
    from megadetector_tpu_torch.classification import train_classifier \
        as ctc
    from megadetector_tpu_torch.models.convert_weights import load_checkpoint
    crops_dir = tmp_path / 'crops'
    rows = []
    rng = np.random.RandomState(0)
    for i in range(10):
        label = ('bear', 'deer')[i % 2]
        rel = 'ds1/img_{}.jpg'.format(i)
        p = crops_dir / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (40, 50, 3),
                                    dtype=np.uint8)).save(p)
        rows.append([rel, 'ds1', 'locA' if i < 8 else 'locB', label, '0.9',
                     label])
    ds_dir = tmp_path / 'dataset'
    ds_dir.mkdir()
    with open(ds_dir / 'classification_ds.csv', 'w') as f:
        f.write('path,dataset,location,dataset_class,confidence,label\n')
        for r in rows:
            f.write(','.join(r) + '\n')
    with open(ds_dir / 'label_index.json', 'w') as f:
        json.dump({'0': 'bear', '1': 'deer'}, f)
    with open(ds_dir / 'splits.json', 'w') as f:
        json.dump({'train': [['ds1', 'locA']], 'val': [['ds1', 'locB']],
                   'test': []}, f)

    def run(name, **kwargs):
        ctc.main(str(ds_dir), str(crops_dir), model_name='efficientnetv2_s',
                 epochs=1, img_size=32, lr=1e-3, seed=0,
                 logdir=str(tmp_path / name), **kwargs)
        return load_checkpoint(str(tmp_path / name / 'params.npz'))[0]

    ref = run('single', batch_size=4, device='cpu')
    calls = []

    def fake_prep_device(device_id=None):
        calls.append(device_id)
        mesh = _cpu_mesh(2)
        return mesh.device_list(), mesh

    monkeypatch.setattr(ctc, 'prep_device', fake_prep_device)
    ours = run('meshed', batch_size=4)
    assert calls == [None]
    # train_init's zero head: the first step's gradients below the head
    # are exactly 0 and the second's are rounding noise around the new
    # head, which Adam (eps 1e-8) turns into steps of a fraction of lr
    # whose sign is the noise's (the two steps' gradients agree within
    # 1e-6 of each tensor's largest; the parameters differ by up to
    # 1.1e-5, 1.1e-2 * lr). So the loss rows are held tightly and the
    # parameters to 5e-2 * lr
    for name in ('single', 'meshed'):
        with open(str(tmp_path / name / 'metrics.csv')) as f:
            rows = [line.split(',') for line in f.read().split()[1:]]
        if name == 'single':
            ref_rows = rows
    assert [r[:3] for r in rows] == [r[:3] for r in ref_rows]
    np.testing.assert_allclose([float(r[3]) for r in rows],
                               [float(r[3]) for r in ref_rows], rtol=1e-6)
    for k, r in _leaves(ref):
        np.testing.assert_allclose(dict(_leaves(ours))[k], r, rtol=1e-4,
                                   atol=5e-5, err_msg=k)
    odd = run('odd', batch_size=3)
    assert odd is not None
