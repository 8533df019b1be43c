"""
The port's RF-DETR (megadetector_tpu_torch/models/rfdetr.py) against the
JAX package's, on the CPU, at the test preset (rfdetr_test: ViT dim 64, 4
blocks, 2 windows, 50 queries) and 112-168 px:

- RFDetrConfig and init_params: the same presets and arrays from a seed;
- the position-embedding resize against jax.image.resize 'bilinear'
  (antialias=True by default): downsampled and upsampled axes, non-square
  grids, and the stored 40x40 grid of rfdetr_base onto the 448x560 and
  336x560 canvases; F.interpolate without antialias differs where an axis
  shrinks, which is why the port builds JAX's weights;
- one windowed and one global ViT block (prefix tokens in every window,
  averaged back), deformable attention (sampling points inside and
  outside the maps), the 2-d sine embedding: float32, rtol 1e-4 and atol
  1e-4 * max|ref|;
- two-stage selection: the top-Q indices identical;
- the whole forward, float32, on a 112x168 canvas whose grid (8x12) is
  shorter than the stored one (12x12, image_size 168): rtol 1e-4;
- bf16: the dtype of every LayerNorm, dense layer, attention, ViT block,
  deformable attention and box MLP output, in call order, equal to JAX's;
  the port's largest class-score and box error against JAX bf16 no larger
  than JAX bf16's own against JAX float32. The JAX apply raises TypeError
  at the projector conv in bf16 (a float32 input against a bf16 weight;
  ROADMAP C), so its bf16 reference runs with lax.conv_general_dilated
  promoting both operands, the rule the port follows there;
- the detector through load_and_run_detector_batch against the JAX driver
  at the MD-JSON golden tolerances (conf 0.005, coord 0.001), with a
  168x112 auto canvas (stride 28: patch 14 x 2 windows); rfdetr_nano
  (stride 56) in preprocess_mode device against the JAX detector's device
  mode at the same tolerances. The
  checkpoint's zero-initialized layers (the box MLPs' last layers, the
  sampling offsets and attention weights) get small seeded values: with
  them at zero every box is exactly its anchor, whose edges fall on
  half-pixel ties that torch's and XLA's float32 sigmoids (an ulp apart)
  round to neighbouring pixels (measured: 9 of 50 boxes of one image one
  pixel apart; ROADMAP C). augment=True raises ValueError;
- the rfdetr_detector shim: load_model and
  convert_detections_to_md_format as JAX's.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from PIL import Image

from megadetector_tpu.detection import rfdetr_detector as jax_shim
from megadetector_tpu.detection import run_detector_batch as jax_batch
from megadetector_tpu.models import rfdetr as jax_rfdetr
from megadetector_tpu.models.detector import TPUDetector
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import rfdetr_detector, \
    run_detector_batch
from megadetector_tpu_torch.models import rfdetr
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.models.params import ParamTree

import torch_port_data as data

ARCH = 'rfdetr_test'


def _close(got, ref):
    """The float32 bar: rtol 1e-4, atol 1e-4 * max|ref|."""

    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def _configs(image_size=112):
    return (rfdetr.RFDetrConfig(ARCH, 3, image_size=image_size),
            jax_rfdetr.RFDetrConfig(ARCH, 3, image_size=image_size))


def _tree(node):
    return ParamTree(node)


def _promoting_conv(monkeypatch):
    """lax.conv_general_dilated with both operands promoted to their
    common dtype, as jnp ops promote (the JAX rfdetr's bf16 projector conv
    otherwise raises TypeError)."""

    conv = jax.lax.conv_general_dilated

    def promoting(lhs, rhs, *args, **kwargs):
        ct = jnp.promote_types(lhs.dtype, rhs.dtype)
        return conv(lhs.astype(ct), rhs.astype(ct), *args, **kwargs)

    monkeypatch.setattr(jax.lax, 'conv_general_dilated', promoting)


def _cast_conv_leaves(params, dtype):
    """The JAX detector's _cast: floating leaves with ndim >= 4 only."""

    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(dtype) if np.ndim(a) >= 4
        else jnp.asarray(a), params)


@pytest.mark.parametrize('arch', sorted(rfdetr.PRESETS))
def test_config_matches_jax(arch):
    ours = rfdetr.RFDetrConfig(arch, 3)
    ref = jax_rfdetr.RFDetrConfig(arch, 3)
    assert vars(ours) == vars(ref)


def test_init_params_match_jax():
    ours, ref = (m.init_params(c, seed=5) for m, c in zip(
        (rfdetr, jax_rfdetr), _configs(168)))
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_ours, flat_ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


@pytest.mark.parametrize('side,grid', [
    ((8, 8), (4, 8)), ((8, 8), (8, 12)), ((12, 12), (8, 12)),
    ((12, 12), (12, 4)), ((40, 40), (32, 40)), ((40, 40), (24, 40))])
def test_pos_embed_resize_matches_jax(side, grid):
    rng = np.random.RandomState(sum(side + grid))
    pos = rng.normal(0, 0.02, (1,) + side + (16,)).astype(np.float32)
    ref = np.asarray(jax.image.resize(pos, (1,) + grid + (16,),
                                      method='bilinear'))
    got = rfdetr.resize_pos_embed(torch.from_numpy(pos), *grid).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    plain = F.interpolate(torch.from_numpy(pos).permute(0, 3, 1, 2),
                          size=grid, mode='bilinear', align_corners=False,
                          antialias=False).permute(0, 2, 3, 1).numpy()
    shrinks = grid[0] < side[0] or grid[1] < side[1]
    assert (np.abs(plain - ref).max() > 1e-3) == shrinks


def _block_params(rng, dim):
    """A ViT block's parameters with LayerScale 1 and random LayerNorm
    affines, so every branch shows in the output."""

    p = jax_rfdetr._vit_block(rng, dim, 4)
    for name in ('norm1', 'norm2'):
        p[name] = {'g': rng.uniform(0.5, 1.5, dim).astype(np.float32),
                   'b': rng.normal(0, 0.1, dim).astype(np.float32)}
    for name in ('ls1', 'ls2'):
        p[name] = {'g': np.ones(dim, np.float32)}
    return p


@pytest.mark.parametrize('windowed', [True, False])
def test_vit_block_matches_jax(windowed):
    rng = np.random.RandomState(7)
    dim, grid, n_prefix = 32, (4, 6), 5
    p = _block_params(rng, dim)
    x = rng.normal(0, 1, (2, n_prefix + 24, dim)).astype(np.float32)
    block = jax.jit(jax_rfdetr._vit_block_apply, static_argnums=(2, 3, 4,
                                                                 5, 6))
    ref = np.asarray(block(p, x, 4, windowed, 2, grid, n_prefix))
    with torch.inference_mode():
        got = rfdetr.vit_block(_tree(p), torch.from_numpy(x), 4, windowed,
                               2, grid, n_prefix).numpy()
    _close(got, ref)
    if windowed:
        # The windows differ from global attention everywhere
        full = np.asarray(block(p, x, 4, False, 2, grid, n_prefix))
        assert np.abs(full - ref).max() > 1e-2


def test_deformable_attention_matches_jax():
    rng = np.random.RandomState(8)
    c = jax_rfdetr.RFDetrConfig(ARCH, 3)
    layer = jax_rfdetr._dec_layer(rng, c)
    # Offsets and weights that spread the sampling points over and past
    # the maps (the init's zero weights keep them near the references)
    for name, scale in (('sampling_offsets', 4.0),
                        ('attention_weights', 1.0)):
        layer[name]['w'] = rng.normal(
            0, scale, layer[name]['w'].shape).astype(np.float32)
    b, nq, d = 2, 10, c.hidden_dim
    queries = rng.normal(0, 1, (b, nq, d)).astype(np.float32)
    ref_boxes = np.concatenate([rng.uniform(0, 1, (b, nq, 2)),
                                rng.uniform(0.05, 0.6, (b, nq, 2))],
                               axis=-1).astype(np.float32)
    shapes = [(6, 8), (3, 4)]
    values = [rng.normal(0, 1, (b, h * w, d)).astype(np.float32)
              for h, w in shapes]
    ref = np.asarray(jax.jit(functools.partial(
        jax_rfdetr._deformable_attn, level_shapes=shapes, heads=c.dec_heads,
        num_points=c.num_points, dtype=jnp.float32))(
            layer, queries, ref_boxes, values))
    with torch.inference_mode():
        got = rfdetr.deformable_attn(
            _tree(layer), torch.from_numpy(queries),
            torch.from_numpy(ref_boxes),
            [torch.from_numpy(v) for v in values], shapes, c.dec_heads,
            c.num_points, torch.float32).numpy()
    _close(got, ref)
    # Some sampling points fell outside the maps
    offsets = (queries @ layer['sampling_offsets']['w'] +
               layer['sampling_offsets']['b']).reshape(
                   b, nq, c.dec_heads, 2, c.num_points, 2)
    loc = ref_boxes[:, :, None, None, None, :2] + offsets / c.num_points * \
        ref_boxes[:, :, None, None, None, 2:] * 0.5
    assert ((loc < 0) | (loc > 1)).any() and ((loc > 0) & (loc < 1)).any()


def test_sine_embed_matches_jax():
    xy = np.random.RandomState(9).uniform(0, 1, (2, 7, 2)).astype(
        np.float32)
    ref = np.asarray(jax_rfdetr._sine_embed_2d(xy, 64))
    got = rfdetr.sine_embed_2d(torch.from_numpy(xy), 64).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 7, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6)
    # (y, x) order: the first half encodes y
    only_x = np.asarray(jax_rfdetr._sine_embed_2d(
        np.stack([xy[..., 0], np.zeros_like(xy[..., 1])], -1), 64))
    np.testing.assert_allclose(got[..., 64:], only_x[..., 64:], rtol=1e-5,
                               atol=2e-6)


@pytest.fixture(scope='module')
def forward_case():
    """rfdetr_test with a 12x12 stored grid (image_size 168) on a uint8
    112x168 batch of 2 (grid 8x12: the height is downsampled), and the
    JAX float32 forward's (class logits, normalized boxes)."""

    ours_c, ref_c = _configs(168)
    params = jax_rfdetr.init_params(ref_c, seed=0)
    u8 = np.random.RandomState(0).randint(0, 256, (2, 112, 168, 3),
                                          dtype=np.uint8)
    x = jnp.asarray(u8, jnp.float32) / jnp.float32(255.0)
    ref32 = [np.asarray(a) for a in jax.jit(functools.partial(
        jax_rfdetr.apply, ref_c, dtype=jnp.float32, decode=False))(
            params, x)]
    return ours_c, ref_c, params, u8, ref32


def test_top_q_indices_match_jax(forward_case):
    ours_c, ref_c, params, u8, _ = forward_case
    x = u8.astype(np.float32) / np.float32(255.0)

    def jax_top_idx(p, x):
        # The JAX apply's pyramid and selection, step for step
        feats = jax_rfdetr.backbone_features(ref_c, p, x, jnp.float32)
        pj = p['projector']
        dn = ('NHWC', 'HWIO', 'NHWC')
        f = jax.lax.conv_general_dilated(
            jnp.concatenate(feats, -1), pj['conv1']['w'], (1, 1),
            [(1, 1), (1, 1)], dimension_numbers=dn) + pj['conv1']['b']
        levels = [jax.nn.gelu(jax_rfdetr._ln(pj['norm1'], f),
                              approximate=False)]
        g = jax.lax.conv_general_dilated(
            levels[0], pj['downs']['d0']['w'], (2, 2), [(1, 1), (1, 1)],
            dimension_numbers=dn) + pj['downs']['d0']['b']
        levels.append(jax.nn.gelu(jax_rfdetr._ln(pj['down_norms']['n0'], g),
                                  approximate=False))
        memory = jnp.concatenate(
            [lv.reshape(x.shape[0], -1, ref_c.hidden_dim) +
             p['level_embed'][i] for i, lv in enumerate(levels)], axis=1)
        enc = jax_rfdetr._ln(p['enc_output_norm'],
                             jax_rfdetr._dense(p['enc_output'], memory))
        score = jnp.max(jax_rfdetr._dense(p['enc_out_class_embed'], enc),
                        axis=-1)
        return jax.lax.top_k(score, ref_c.num_queries)[1]

    ref = np.asarray(jax.jit(jax_top_idx)(params, x))
    tree = _tree(params)
    with torch.inference_mode():
        tokens, shapes = rfdetr.pyramid(ours_c, tree, torch.from_numpy(x),
                                        torch.float32)
        _, _, top_idx = rfdetr.select_queries(ours_c, tree, tokens, shapes)
    assert shapes == [(8, 12), (4, 6)]
    assert np.array_equal(top_idx.numpy(), ref)


def test_forward_float32_matches_jax(forward_case):
    ours_c, ref_c, params, u8, ref = forward_case
    model = rfdetr.RFDetr(ours_c).load_params(params).eval()
    with torch.inference_mode():
        logits, boxes = model(torch.from_numpy(u8), decode=False)
        decoded = model(torch.from_numpy(u8))
    _close(logits.numpy(), ref[0])
    _close(boxes.numpy(), ref[1])
    assert decoded.shape == (2, ref_c.num_queries, 8)
    assert np.array_equal(decoded[..., 4].numpy(), np.ones((2, 50)))


_RECORDED = {
    # port name: JAX name
    'layer_norm': '_ln', '_dense': '_dense', '_mha': '_mha',
    'vit_block': '_vit_block_apply', 'deformable_attn': '_deformable_attn',
    '_mlp3': '_mlp3'}


def _record_dtypes(monkeypatch, module, names, log):
    """Wrap [module]'s functions [names] to append (name, output dtype) to
    [log] at each call."""

    for name in names:
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            log.append((_name, str(out.dtype).split('.')[-1]))
            return out

        monkeypatch.setattr(module, name, wrapped)


def test_bf16_dtypes_and_error_match_jax(forward_case, monkeypatch):
    ours_c, ref_c, params, u8, ref32 = forward_case
    jparams = _cast_conv_leaves(params, jnp.bfloat16)
    x16 = jnp.asarray(u8).astype(jnp.bfloat16) / jnp.bfloat16(255.0)
    apply16 = functools.partial(jax_rfdetr.apply, ref_c, dtype=jnp.bfloat16,
                                decode=False)
    # The reference fault: the JAX bf16 forward fails at the projector
    with pytest.raises(TypeError, match='same dtypes'):
        jax.eval_shape(apply16, jparams, x16)
    _promoting_conv(monkeypatch)
    ref16 = [np.asarray(a, np.float32)
             for a in jax.jit(apply16)(jparams, x16)]

    jax_log, port_log = [], []
    _record_dtypes(monkeypatch, jax_rfdetr, _RECORDED.values(), jax_log)
    # A new partial: eval_shape would reuse the jit's cached trace
    jax.eval_shape(functools.partial(apply16), jparams, x16)
    _record_dtypes(monkeypatch, rfdetr, _RECORDED, port_log)
    model = rfdetr.RFDetr(ours_c).load_params(params).set_compute_dtype(
        torch.bfloat16).eval()
    assert model.params['patch_embed']['w'].dtype == torch.bfloat16
    assert model.params['pos_embed'].dtype == torch.float32
    with torch.inference_mode():
        got = [t.float().numpy()
               for t in model(torch.from_numpy(u8), decode=False)]
    assert [(_RECORDED[n], d) for n, d in port_log] == jax_log
    # The compute dtype reaches the first LayerNorm's input only (its
    # float32 parameters promote); after it, bf16 returns in the query
    # position head and the deformable attention's output projection
    assert jax_log[0] == ('_ln', 'float32')
    assert ('_dense', 'bfloat16') in jax_log

    def conf(logits):
        return 1.0 / (1.0 + np.exp(-logits))

    for name, g, r16, r32 in (('conf', conf(got[0]), conf(ref16[0]),
                               conf(ref32[0])),
                              ('boxes', got[1], ref16[1], ref32[1])):
        own = np.abs(r16 - r32).max()
        err = np.abs(g - r16).max()
        assert 0 < own and err <= own, (name, err, own)


def _test_checkpoint_params(config):
    """init_params with its zero-initialized layers (the box MLPs' last
    layers, the sampling offsets and attention weights) given small
    seeded values, so boxes leave the anchor grid (module docstring)."""

    params = jax_rfdetr.init_params(config, seed=0)
    rng = np.random.RandomState(11)
    nodes = [params['bbox_embed']['l2'], params['enc_out_bbox_embed']['l2']]
    for layer in params['decoder'].values():
        nodes += [layer['sampling_offsets'], layer['attention_weights']]
    for node in nodes:
        node['w'] = rng.normal(0, 0.05, node['w'].shape).astype(np.float32)
    return params


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_rfdetr')
    folder = root / 'images'
    folder.mkdir()
    for i, img in enumerate(data.images()):
        Image.fromarray(img).save(str(folder / 'im{:02d}.png'.format(i)))
    model = str(root / 'rfdetr_test.npz')
    _, ref_c = _configs(168)
    save_checkpoint(_test_checkpoint_params(ref_c), model, {
        'metadata_format_version': 1.0, 'arch': ARCH,
        'model_type': 'rfdetr', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'], 'image_size': 168})
    return root, str(folder), model


def test_detector_matches_jax_driver(checkpoint):
    root, folder, model = checkpoint
    ours = run_detector_batch.load_and_run_detector_batch(
        model, folder, batch_size=4, quiet=True, device='cpu')
    ref = jax_batch.load_and_run_detector_batch(
        model, folder, batch_size=4, quiet=True, loader_workers=1,
        detector_options={'force_cpu': True, 'use_mesh': 'false'})
    ours_out, ref_out = (
        module.write_results_to_file(
            results, str(root / '{}.json'.format(tag)),
            relative_path_base=folder, detector_file=model)
        for module, results, tag in ((run_detector_batch, ours, 'ours'),
                                     (jax_batch, ref, 'ref')))
    counts = [len(im['detections']) for im in ours_out['images']]
    assert counts == [len(im['detections']) for im in ref_out['images']]
    assert all(0 < n <= 50 for n in counts), counts
    result = md_tests.compare_results(ref_out, ours_out,
                                      data.golden_options())
    assert result['n_images_compared'] == len(data.SIZES)
    assert result['errors'] == [], result['errors'][:5]


def test_detector_dispatch_and_augment_refused(checkpoint):
    _, folder, model = checkpoint
    loaded = rfdetr_detector.load_model(model, device='cpu')
    detector = loaded['model']
    assert isinstance(detector.model, rfdetr.RFDetr)
    # patch 14 x 2 windows for the test preset
    assert detector.letterbox_stride == 28
    assert (loaded['model_type'], loaded['image_size']) == ('rfdetr', 168)
    with pytest.raises(ValueError, match='augment'):
        detector.generate_detections_one_batch(data.images()[:2],
                                               augment=True)
    with pytest.raises(ValueError, match='augment'):
        run_detector_batch.load_and_run_detector_batch(
            model, folder, batch_size=4, quiet=True, device='cpu',
            augment=True)


def test_device_preprocess_at_stride_56(tmp_path):
    """A preset with 4 windows (rfdetr_nano: stride 14 x 4 = 56) in
    preprocess_mode device against the JAX detector's device mode at the
    golden tolerances, on the 224x280 auto canvas of image_size 280 (400
    memory tokens for 300 queries; a canvas with fewer tokens than queries
    raises in both packages)."""

    config = jax_rfdetr.RFDetrConfig('rfdetr_nano', 3, image_size=280)
    model = str(tmp_path / 'rfdetr_nano.npz')
    save_checkpoint(_test_checkpoint_params(config), model, {
        'arch': 'rfdetr_nano', 'model_type': 'rfdetr', 'num_classes': 3,
        'image_size': 280})
    # The four 240x320 images: one batch on the 224x280 canvas (grid 16x20
    # from the stored 20x20: the height downsampled)
    images = data.images()[:4]
    ids = ['im{:02d}.png'.format(i) for i in range(len(images))]
    options = {'preprocess_mode': 'device'}
    port = rfdetr_detector.RFDETRDetector(model, options, device='cpu')
    ref = TPUDetector(model, dict(options, force_cpu=True))
    assert port.letterbox_stride == ref.letterbox_stride == 56
    results = []
    for detector in (ref, port):
        infos = [detector.preprocess_image(im, image_id=i)
                 for im, i in zip(images, ids)]
        assert [tuple(info['target_shape']) for info in infos] == \
            [(224, 280)] * 4
        results.append({'images': detector.generate_detections_one_batch(
            infos, ids, 0.005)})
    assert all(r['detections'] for r in results[1]['images'])
    result = md_tests.compare_results(*results, data.golden_options())
    assert result['n_images_compared'] == len(images)
    assert result['errors'] == [], result['errors'][:5]
    with pytest.raises(ValueError, match='too small'):
        port.model(torch.zeros((1, 168, 112, 3), dtype=torch.uint8))


def test_convert_detections_to_md_format_matches_jax():
    class Detections:
        xyxy = np.array([[10.0, 20.0, 110.0, 70.0], [-5.0, 3.0, 250.0, 90.0],
                         [150.0, 80.0, 199.0, 99.5]])
        confidence = np.array([0.91234, 0.5, 0.0123456])
        class_id = np.array([1, 2, 3])

        def __len__(self):
            return 3

    for dets in (Detections(), None):
        assert rfdetr_detector.convert_detections_to_md_format(
            dets, 200, 100) == jax_shim.convert_detections_to_md_format(
                dets, 200, 100)
