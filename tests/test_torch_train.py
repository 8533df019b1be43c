"""
The port's training path (megadetector_tpu_torch/training/ and
classification/train_classifier.py) against the JAX package's, in one
process on the CPU:

- the YOLOv5 loss on yolov5n (nc 3, seed 0) at 128 px, batch 2, with
  targets on cell edges, near the border, in padded slots and two in one
  cell: loss, box, obj and cls within rtol 1e-5 of JAX's, the objectness
  targets identical, every gradient within rtol 1e-4 and atol 1e-4 *
  max|ref| of jax.grad's;
- three Adam steps (clip 5, lr 1e-3) against the JAX step: parameters
  within rtol 1e-4;
- bf16: the loss no further from JAX's bf16 than JAX's bf16 is from JAX's
  float32 (the port's bf16 bar since its first bf16 forward). The
  gradients are held to JAX's float32 instead: all of them together
  (L2) no further from it than JAX's bf16 gradients are, and each tensor
  within 1.1 times JAX's bf16 distance on the mean absolute difference
  and 1.5 times on the max. JAX's own bar does not apply to them: XLA on
  the CPU rounds every addition of a bias gradient's bf16 sum (the port
  rounds once: ops/silu_bf16.py), which puts JAX's bf16 bias gradients
  about as far from the port's as from float32, and the conv weight
  gradients' bf16 sums round at other points in the two libraries, two
  independent errors of one size (measured on this case: the port's
  gradients are 0.0125 of JAX bf16's distance from float32 in L2, each
  tensor at most 1.045 times on the mean and 1.44 times on the max);
- the classifier step on efficientnetv2_test at 32 px, float32 and bf16,
  against training/train_classifier.make_train_step (loss, accuracy,
  parameters after the step);
- the two trainers end to end on the CPU (training/train_classifier
  .train and classification/train_classifier.main): their checkpoints
  load in both packages and give equal logits;
- inference is unchanged when training mode is switched on and off, and a
  fused stem whose l0 weights changed refuses to run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu.training import train_detector as jax_td
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.training import optim
from megadetector_tpu_torch.training import train_detector as td

SIZE = 128


def _targets():
    """Two images: edges (integer grid coordinates at every stride), the
    border (below one cell), a shared cell and padded slots."""

    boxes = [np.array([[0.5, 0.5, 0.3, 0.25],       # on cell edges
                       [0.25, 0.75, 0.1, 0.2],      # on cell edges
                       [0.03, 0.97, 0.05, 0.05],    # at the border
                       [0.62, 0.41, 0.2, 0.3],      # two in one cell
                       [0.625, 0.405, 0.12, 0.1]]),
             np.array([[0.31, 0.52, 0.6, 0.5],
                       [0.8, 0.2, 0.15, 0.1]])]
    classes = [np.array([0, 1, 2, 1, 0]), np.array([2, 1])]
    return jax_td.pad_targets(boxes, classes, max_targets=8)


@pytest.fixture(scope='module')
def detector_case():
    cfg = jax_yolov5.YoloV5Config('yolov5n', num_classes=3)
    params = jax_yolov5.init_params(cfg, seed=0)
    rng = np.random.RandomState(1)
    images_u8 = rng.randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    return cfg, params, images_u8, _targets()


def _jax_loss_and_grads(cfg, params, images_u8, targets, dtype,
                        record=False):
    """(loss, metrics, grads, the objectness targets of each level when
    [record], else None; the program is jitted then)."""

    x = jnp.asarray(images_u8.astype(np.float32) / 255.0)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    if not record:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda q: jax_td.detection_loss(cfg, q, x, *targets,
                                            compute_dtype=dtype),
            has_aux=True))(p)
        return loss, metrics, grads, None
    recorded = []
    bce = jax_td._bce_with_logits

    def recording_bce(logits, t):
        if t.ndim == 4:
            recorded.append(np.asarray(t))
        return bce(logits, t)

    jax_td._bce_with_logits = recording_bce
    try:
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: jax_td.detection_loss(cfg, q, x, *targets,
                                            compute_dtype=dtype),
            has_aux=True)(p)
    finally:
        jax_td._bce_with_logits = bce
    return loss, metrics, grads, recorded[:len(cfg.strides)]


def _port_model(params, dtype):
    cfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
    return cfg, yolov5.YoloV5(cfg).load_params(params).set_training(dtype)


def _port_loss_and_grads(params, images_u8, targets, dtype):
    """(loss, metrics, grads, the objectness targets of each level)."""

    cfg, model = _port_model(params, dtype)
    x = torch.from_numpy(images_u8).float() / 255.0
    tobj = []
    scatter = td.scatter_max

    def recording_scatter(*args):
        tobj.append(scatter(*args))
        return tobj[-1]

    td.scatter_max = recording_scatter
    try:
        loss, metrics = td.detection_loss(
            cfg, model, x, torch.from_numpy(targets[0]),
            torch.from_numpy(targets[1]).long(),
            torch.from_numpy(targets[2]), dtype)
    finally:
        td.scatter_max = scatter
    loss.backward()
    return loss, metrics, _grads(model), tobj


def _grads(model):
    """The gradients of [model] as a JAX-layout pytree (HWIO)."""

    out = {}
    for name, m in model.named_modules():
        if type(m) is not yolov5.Conv:
            continue
        node = out
        for key in name.split('.')[1:]:
            node = node.setdefault(key, {})
        node['w'] = m.weight.grad.permute(2, 3, 1, 0).numpy()
        node['b'] = m.bias.grad.numpy()
    return out


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_detection_loss_and_gradients_match_jax(detector_case):
    cfg, params, images_u8, targets = detector_case
    loss_j, m_j, g_j, tobj_j = _jax_loss_and_grads(
        cfg, params, images_u8, targets, jnp.float32, record=True)
    loss_t, m_t, g_t, tobj_t = _port_loss_and_grads(
        params, images_u8, targets, torch.float32)
    assert float(m_j['n_positives']) > 0
    for key in ('loss', 'box_loss', 'obj_loss', 'cls_loss', 'n_positives'):
        np.testing.assert_allclose(float(m_t[key].detach()), float(m_j[key]),
                                   rtol=1e-5, err_msg=key)
    # the objectness targets are the detached CIoU of each level's
    # positives: the same cells, values as close as the forward's
    assert len(tobj_t) == len(tobj_j) == 3
    for t, j in zip(tobj_t, tobj_j):
        np.testing.assert_array_equal(t.numpy() > 0, j > 0)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5)
    ref = dict((jax.tree_util.keystr(k), np.asarray(v))
               for k, v in _leaves(g_j))
    ours = dict((jax.tree_util.keystr(k), v) for k, v in _leaves(g_t))
    assert sorted(ref) == sorted(ours)
    for k, r in ref.items():
        np.testing.assert_allclose(ours[k], r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)


def test_scatter_max_equals_jax_at_max():
    """tobj's scatter with duplicates: identical to JAX's .at[].max."""

    rng = np.random.RandomState(4)
    shape = (2, 5, 6, 3)
    idx = [rng.randint(0, n, 400) for n in shape]
    idx[1][:50] = 2     # many duplicates
    idx[2][:50] = 3
    values = rng.uniform(-0.2, 1, 400).astype(np.float32)
    values[::7] = 0.0
    ref = jnp.zeros(shape, jnp.float32).at[tuple(idx)].max(values)
    ours = td.scatter_max(shape, [torch.from_numpy(i).long() for i in idx],
                          torch.from_numpy(values))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_ciou_and_bce_match_jax():
    rng = np.random.RandomState(3)
    a = np.abs(rng.standard_normal((64, 4))).astype(np.float32) + 0.1
    b = np.abs(rng.standard_normal((64, 4))).astype(np.float32) + 0.1
    b[:8] = a[:8]
    np.testing.assert_allclose(
        td._ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_td._ciou(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)
    logits = (rng.standard_normal(100) * 8).astype(np.float32)
    t = rng.uniform(0, 1, 100).astype(np.float32)
    np.testing.assert_allclose(
        td._bce_with_logits(torch.from_numpy(logits),
                            torch.from_numpy(t)).numpy(),
        np.asarray(jax_td._bce_with_logits(jnp.asarray(logits),
                                           jnp.asarray(t))), rtol=1e-6)


def test_pad_targets_matches_jax():
    boxes = [np.array([[0.5, 0.5, 0.2, 0.2]]), np.zeros((0, 4)),
             np.random.RandomState(0).uniform(0, 1, (12, 4))]
    classes = [np.array([1]), np.zeros((0,), int), np.arange(12) % 3]
    for a, b in zip(td.pad_targets(boxes, classes, max_targets=8),
                    jax_td.pad_targets(boxes, classes, max_targets=8)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_detector_steps_match_jax(detector_case):
    cfg, params, images_u8, targets = detector_case
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p_j)
    step_j = jax.jit(jax_td.make_detector_train_step(cfg, tx))

    cfg_t, model = _port_model(params, torch.float32)
    opt = optim.Optimizer(model.parameters(), optim.chain(
        optim.clip_by_global_norm(5.0), optim.adam(1e-3)))
    step_t = td.make_detector_train_step(cfg_t, model, opt)
    for _ in range(3):
        p_j, state, m_j = step_j(p_j, state, images_u8, *targets)
        m_t = step_t(images_u8, *targets)
        np.testing.assert_allclose(float(m_t['loss']), float(m_j['loss']),
                                   rtol=1e-5)
    ours = dict((jax.tree_util.keystr(k), v)
                for k, v in _leaves(model.export_params()))
    for k, r in _leaves(p_j):
        r = np.asarray(r)
        np.testing.assert_allclose(ours[jax.tree_util.keystr(k)], r,
                                   rtol=1e-4, atol=1e-4 * np.abs(r).max())


def test_bf16_loss_and_gradients_within_the_jax_bf16_bar(detector_case):
    cfg, params, images_u8, targets = detector_case
    _, m32, g32, _ = _jax_loss_and_grads(cfg, params, images_u8, targets,
                                         jnp.float32)
    _, m16, g16, _ = _jax_loss_and_grads(cfg, params, images_u8, targets,
                                         jnp.bfloat16)
    _, mt, gt, _ = _port_loss_and_grads(params, images_u8, targets,
                                        torch.bfloat16)
    own = abs(float(m16['loss']) - float(m32['loss']))
    assert abs(float(mt['loss'].detach()) - float(m16['loss'])) <= own
    ours = dict((jax.tree_util.keystr(k), v) for k, v in _leaves(gt))
    r32 = dict((jax.tree_util.keystr(k), np.asarray(v))
               for k, v in _leaves(g32))
    sq_ours, sq_jax = 0.0, 0.0
    for k, r16 in _leaves(g16):
        k = jax.tree_util.keystr(k)
        jax_err = np.abs(np.asarray(r16, np.float32) - r32[k])
        err = np.abs(ours[k] - r32[k])
        assert ours[k].dtype == np.float32
        assert err.mean() <= 1.1 * jax_err.mean(), \
            (k, err.mean(), jax_err.mean())
        assert err.max() <= 1.5 * jax_err.max(), (k, err.max(),
                                                    jax_err.max())
        sq_ours += float((err.astype(np.float64) ** 2).sum())
        sq_jax += float((jax_err.astype(np.float64) ** 2).sum())
    assert sq_ours <= sq_jax


#%% The classifier

from megadetector_tpu.models import efficientnet as jax_eff  # noqa: E402
from megadetector_tpu.training import train_classifier as jax_tc  # noqa: E402
from megadetector_tpu_torch.models import efficientnet  # noqa: E402
from megadetector_tpu_torch.training import train_classifier as tc  # noqa: E402,E501


def _classifier_case(seed=0, train_init=True):
    cfg = jax_eff.EfficientNetConfig('efficientnetv2_test', num_classes=4,
                                     image_size=32)
    params = jax_eff.init_params(cfg, seed=seed, train_init=train_init)
    rng = np.random.RandomState(seed + 10)
    images = rng.randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, 6).astype(np.int32)
    return cfg, params, images, labels


def _classifier_step_both(dtype_j, dtype_t, steps=2, train_init=True):
    cfg, params, images, labels = _classifier_case(train_init=train_init)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-3, weight_decay=1e-5))
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p_j)
    step_j = jax.jit(jax_tc.make_train_step(cfg, tx, 0.1, dtype_j))
    cfg_t = efficientnet.EfficientNetConfig('efficientnetv2_test', 4, 32)
    model = tc.make_classifier(cfg_t, params, 'cpu', dtype_t)
    opt = optim.Optimizer(model.parameters(), optim.chain(
        optim.clip_by_global_norm(1.0), optim.adamw(1e-3, weight_decay=1e-5)))
    step_t = tc.make_train_step(cfg_t, model, opt, 0.1, dtype_t)
    out = []
    for _ in range(steps):
        p_j, state, m_j = step_j(p_j, state, images, labels)
        m_t = step_t(images, labels)
        out.append((m_j, m_t))
    return out, p_j, model


def test_classifier_step_matches_jax_float32():
    out, p_j, model = _classifier_step_both(jnp.float32, torch.float32)
    for m_j, m_t in out:
        np.testing.assert_allclose(float(m_t['loss']), float(m_j['loss']),
                                   rtol=1e-5)
        assert float(m_t['accuracy']) == float(m_j['accuracy'])
    ours = dict((jax.tree_util.keystr(k), v)
                for k, v in _leaves(model.export_params()))
    for k, r in _leaves(p_j):
        r = np.asarray(r)
        np.testing.assert_allclose(ours[jax.tree_util.keystr(k)], r,
                                   rtol=1e-4, atol=1e-4 * np.abs(r).max())


def test_classifier_step_bf16_within_the_jax_bf16_bar():
    """Three steps from He-initialised weights (train_init's zero head
    gives every class the same logit, the same loss in both dtypes): each
    step's loss no further from JAX bf16's than that is from JAX
    float32's."""

    out32, _, _ = _classifier_step_both(jnp.float32, torch.float32, 3,
                                        train_init=False)
    out16, _, model = _classifier_step_both(jnp.bfloat16, torch.bfloat16,
                                            3, train_init=False)
    for (m32, _), (m16, mt) in zip(out32, out16):
        own = abs(float(m16['loss']) - float(m32['loss']))
        assert abs(float(mt['loss']) - float(m16['loss'])) <= own
    assert model.train_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _u8_batch(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def test_inference_unchanged_after_training_mode_on_and_off():
    cfg = jax_yolov5.YoloV5Config('yolov5n', num_classes=3)
    params = jax_yolov5.init_params(cfg, seed=2)
    u8 = torch.from_numpy(_u8_batch(0, (2, 64, 96, 3)))
    tcfg = yolov5.YoloV5Config('yolov5n', num_classes=3)
    model = yolov5.YoloV5(tcfg).load_params(params).eval()
    with torch.inference_mode():
        before = model(u8)
    model.set_training(torch.bfloat16)
    model(u8.float() / 255.0, decode=False)[0].float().sum().backward()
    model.set_training(None)
    with torch.inference_mode():
        after = model(u8)
    assert torch.equal(before, after)
    assert all(m.cast is None for m in model.modules()
               if type(m) is yolov5.Conv)
    # bf16 inference with the fused stem, then as a fresh model
    model.set_compute_dtype(torch.bfloat16, fused_stem=True)
    fresh = yolov5.YoloV5(tcfg).load_params(params).set_compute_dtype(
        torch.bfloat16, fused_stem=True)
    with torch.inference_mode():
        assert torch.equal(model(u8), fresh(u8))
    # the classifier: float32 and bf16 logits unchanged
    ecfg = efficientnet.EfficientNetConfig('efficientnetv2_test', 4, 32)
    eparams = jax_eff.init_params(jax_eff.EfficientNetConfig(
        'efficientnetv2_test', 4, 32), seed=1)
    x = torch.from_numpy(_u8_batch(1, (2, 32, 32, 3))).float() / 255.0
    for dtype in (torch.float32, torch.bfloat16):
        net = efficientnet.EfficientNet(ecfg).load_params(eparams)
        ref = efficientnet.EfficientNet(ecfg).load_params(
            eparams).set_compute_dtype(dtype)
        net.set_training(dtype)
        net(x).sum().backward()
        net.set_training(None).set_compute_dtype(dtype)
        assert not any(p.requires_grad for p in net.parameters())
        with torch.inference_mode():
            assert torch.equal(net(x), ref(x))


def test_stale_fused_stem_refuses_to_run():
    cfg = jax_yolov5.YoloV5Config('yolov5n', num_classes=3)
    params = jax_yolov5.init_params(cfg, seed=2)
    u8 = torch.from_numpy(_u8_batch(0, (1, 64, 64, 3)))
    model = yolov5.YoloV5(yolov5.YoloV5Config('yolov5n', 3)).load_params(
        params).set_compute_dtype(torch.bfloat16, fused_stem=True)
    with torch.inference_mode():
        model(u8)
    with torch.no_grad():
        model.layers['l0'].weight.add_(1)       # an optimizer's step
    with pytest.raises(ValueError, match='fused stem'):
        with torch.inference_mode():
            model(u8)
    # bf16 weights cannot train; float32 ones do not make a stem
    with pytest.raises(ValueError, match='float32 weights'):
        model.set_training(torch.bfloat16)


def test_exported_detector_checkpoint_loads_in_both_packages(tmp_path):
    from megadetector_tpu.models.convert_weights import \
        load_checkpoint as jax_load
    from megadetector_tpu_torch.models.convert_weights import (
        load_checkpoint, save_checkpoint)
    cfg, params, images_u8, targets = (
        jax_yolov5.YoloV5Config('yolov5n', num_classes=3),
        jax_yolov5.init_params(jax_yolov5.YoloV5Config('yolov5n', 3),
                               seed=0),
        _u8_batch(1, (2, SIZE, SIZE, 3)), _targets())
    tcfg, model = _port_model(params, torch.float32)
    opt = optim.Optimizer(model.parameters(), optim.adam(1e-3))
    step = td.make_detector_train_step(tcfg, model, opt)
    step(images_u8, *targets)
    path = str(tmp_path / 'trained.npz')
    save_checkpoint(model.export_params(), path, {'arch': 'yolov5n'})
    p_jax, _ = jax_load(path)
    p_port, _ = load_checkpoint(path)
    x = images_u8.astype(np.float32) / 255.0
    ref = np.asarray(jax_yolov5.apply(cfg, jax.tree_util.tree_map(
        jnp.asarray, p_jax), jnp.asarray(x)))
    fresh = yolov5.YoloV5(tcfg).load_params(p_port)
    model.set_training(None)
    with torch.inference_mode():
        ours = fresh(torch.from_numpy(x)).numpy()
        trained = model(torch.from_numpy(x)).numpy()
    assert np.array_equal(ours, trained)
    np.testing.assert_allclose(ours, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def _crop_folder(root, n=6, size=40):
    from PIL import Image
    rng = np.random.RandomState(0)
    for cls, base in (('deer', 60), ('fox', 180)):
        folder = root / 'crops' / cls
        folder.mkdir(parents=True)
        for i in range(n):
            arr = np.full((size, size, 3), base, np.uint8) + \
                rng.randint(0, 20, (size, size, 3)).astype(np.uint8)
            Image.fromarray(arr).save(str(folder / '{}.jpg'.format(i)))
    return str(root / 'crops')


def _logits_both(ckpt, crops):
    """Logits of the checkpoint in the JAX and the port's
    SpeciesClassifier on the same crops."""

    from megadetector_tpu.models.classifier import \
        SpeciesClassifier as JaxClassifier
    from megadetector_tpu_torch.models.classifier import SpeciesClassifier
    ours = SpeciesClassifier(ckpt, device='cpu').classify_batch(crops)
    ref = JaxClassifier(ckpt).classify_batch(crops)
    return np.asarray(ours), np.asarray(ref)


@pytest.mark.parametrize('dtype', ['float32', 'bf16'])
def test_folder_train_checkpoint_loads_in_both_packages(tmp_path, dtype):
    crops = _crop_folder(tmp_path)
    options = tc.TrainingOptions()
    options.arch = 'efficientnetv2_test'
    options.image_size = 32
    options.batch_size = 4
    options.num_epochs = 1
    options.log_every = 1
    options.dtype = dtype
    options.device = 'cpu'
    ckpt = str(tmp_path / 'clf.npz')
    model, history = tc.train(crops, ckpt, options)
    assert len(history) == 3 and all(np.isfinite(h['loss'])
                                     for h in history)
    test_crops = [_u8_batch(i, (40, 40, 3)) for i in range(3)]
    ours, ref = _logits_both(ckpt, test_crops)
    assert ours.shape == (3, 2)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)
    # the checkpoint's network gives the trained module's logits
    from megadetector_tpu_torch.models.classifier import SpeciesClassifier
    clf = SpeciesClassifier(ckpt, device='cpu')
    assert clf.class_names == ['deer', 'fox']
    x = torch.from_numpy(_u8_batch(5, (2, 32, 32, 3))).float() / 255.0
    with torch.inference_mode():
        assert torch.equal(clf.model(x), model(x))


@pytest.fixture
def classification_dataset(tmp_path):
    from PIL import Image
    import json
    crops_dir = tmp_path / 'crops'
    rows = []
    rng = np.random.RandomState(0)
    for i in range(8):
        label = ('bear', 'deer')[i % 2]
        loc = 'locA' if i < 6 else 'locB'
        rel = 'ds1/img_{}___crop00_mdv5.0.jpg'.format(i)
        p = crops_dir / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (40, 50, 3),
                                    dtype=np.uint8)).save(p)
        rows.append([rel, 'ds1', loc, label, str(0.5 + 0.05 * i), label])
    ds_dir = tmp_path / 'dataset'
    ds_dir.mkdir()
    with open(ds_dir / 'classification_ds.csv', 'w') as f:
        f.write('path,dataset,location,dataset_class,confidence,label\n')
        for r in rows:
            f.write(','.join(r) + '\n')
    with open(ds_dir / 'label_index.json', 'w') as f:
        json.dump({'0': 'bear', '1': 'deer'}, f)
    with open(ds_dir / 'splits.json', 'w') as f:
        json.dump({'train': [['ds1', 'locA']],
                   'val': [['ds1', 'locB']], 'test': []}, f)
    return str(ds_dir), str(crops_dir)


@pytest.mark.parametrize('finetune', [False, True])
def test_classification_main_checkpoint_loads_in_both_packages(
        classification_dataset, tmp_path, finetune):
    import os
    from megadetector_tpu_torch.classification import train_classifier \
        as ctc
    from megadetector_tpu_torch.models.convert_weights import load_checkpoint
    ds_dir, crops_dir = classification_dataset
    logdir = str(tmp_path / 'run')
    before = jax_eff.init_params(jax_eff.EfficientNetConfig(
        'efficientnetv2_s', 2), train_init=True)
    best = ctc.main(ds_dir, crops_dir, model_name='efficientnetv2_s',
                    finetune=finetune, epochs=1, batch_size=2, img_size=32,
                    lr=1e-3, label_weighted=True, logdir=logdir, seed=0,
                    device='cpu')
    assert best is not None and 'acc_top1' in best
    with open(os.path.join(logdir, 'metrics.csv')) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == 'split,epoch,metric,value'
    ckpt = os.path.join(logdir, 'params.npz')
    trained, meta = load_checkpoint(ckpt)
    assert meta['class_names'] == ['bear', 'deer']
    changed = [jax.tree_util.keystr(k) for k, v in _leaves(trained)
               if not np.array_equal(
                   v, _leaves_dict(before)[jax.tree_util.keystr(k)])]
    if finetune:
        assert sorted(changed) == ["['fc']['b']", "['fc']['w']"]
    else:
        assert len(changed) > 10
    crops = [_u8_batch(i, (40, 50, 3)) for i in range(2)]
    ours, ref = _logits_both(ckpt, crops)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)


def _leaves_dict(tree):
    return dict((jax.tree_util.keystr(k), np.asarray(v))
                for k, v in _leaves(tree))


def test_classification_helpers_match_jax():
    from megadetector_tpu.classification import train_classifier as jctc
    from megadetector_tpu_torch.classification import train_classifier \
        as ctc
    outputs = np.random.RandomState(0).standard_normal((20, 5))
    labels = np.arange(20) % 5
    weights = np.linspace(0.5, 1.5, 20)
    assert ctc.correct(outputs, labels, weights, top=(1, 3)) == \
        jctc.correct(outputs, labels, weights, top=(1, 3))
    cfg, model, mask = ctc.build_model('efficientnetv2_s', 3, False, True,
                                       device='cpu')
    names = [n for n, _ in model.named_parameters()]
    assert [n for n, m in zip(names, mask) if m] == ['fc_w', 'fc_b']
    _, _, mask_all = ctc.build_model('efficientnetv2_s', 3, False, False,
                                     device='cpu')
    assert all(mask_all)
    with pytest.raises(AssertionError):
        ctc.build_model('not_a_model', 3, False, False, device='cpu')


def test_build_model_defaults_to_the_card(monkeypatch):
    """build_model with the JAX signature (no device) builds on CUDA, so
    without a card it raises rather than training on the CPU."""
    from megadetector_tpu_torch.classification import train_classifier \
        as ctc
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        ctc.build_model('efficientnetv2_s', 3, False, False)


@pytest.mark.parametrize('arch', ['efficientnetv2_test', 'efficientnetv2_s'])
def test_classifier_activated_conv_shapes_count_e7(arch):
    """efficientnet.activated_conv_shapes (the bf16 epilogue's tensors of
    a forward, which the card's backward check takes) has one entry per E7
    launch of a bf16 float forward, and every one is an [N, C, H, W] that
    a bf16 training forward gives silu_bf16."""

    config = efficientnet.EfficientNetConfig(arch, 3, 64)
    shapes = efficientnet.activated_conv_shapes(config, 64, 2)
    assert len(shapes) == efficientnet.forward_launches(
        config, False, torch.bfloat16)[1]
    calls = []
    real = efficientnet.silu_bf16

    def spy(x, bias=None, out=None):
        calls.append(tuple(x.shape))
        return real(x, bias, out)

    model = efficientnet.EfficientNet(config).load_params(
        efficientnet.init_params(config, train_init=True)).set_training(
            torch.bfloat16)
    efficientnet.silu_bf16 = spy
    try:
        model(torch.zeros(2, 64, 64, 3))
    finally:
        efficientnet.silu_bf16 = real
    assert calls == shapes
