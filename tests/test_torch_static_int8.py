"""
int8 static-scale checkpoints (quantize_checkpoint mode='static') in the
port, held to the JAX package on the CPU:

- quantize_params byte-identical to the JAX module's (w_q, w_scale, b, and
  which convs stay float), detect heads included once nc >= 17;
- calibrate_activation_scales: given the same per-conv inputs as JAX's
  calibration forward (captured there), each conv's abs-max and dynamic-
  scale output agree within 1e-6 and the x_scale written is JAX's within
  1e-6 (measured: identical bytes), stored as float32 as JAX stores it.
  End to end, each package's scales are its own forward's abs-max exactly,
  and the forwards drift apart: the first int8 conv's input differs from
  JAX's by a few float32 ulps (the float convs' sum order), and each
  later conv's dynamic-scale roundings amplify that; the scales drift up
  to 1.22e-3 (measured), held within 2e-3 (see the test);
- each int8 conv: given the same float input and x_scale, the quantized
  input and the int32 sums identical to JAX's (the bar allows x_q 1 lsb
  apart on 1e-4 of elements; measured 0), and quantized_conv's float
  output within 1e-6 relative (XLA on the CPU may contract the affine
  epilogue into one FMA; the port rounds twice);
- the yolov5n forward at 64 px against yolov5.apply: heads within 1e-4 *
  max|ref| (measured 5.9e-7 of it);
- the detector on such checkpoints: tests/test_torch_static_int8_detector.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu.models.convert_weights import (
    load_checkpoint as jax_load_checkpoint, quantize_checkpoint as
    jax_quantize_checkpoint)
from megadetector_tpu.ops import quantization as jax_q
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import (
    flatten_params, load_checkpoint, quantize_checkpoint, save_checkpoint)
from megadetector_tpu_torch.ops import conv_int8
from megadetector_tpu_torch.ops import quantization as q

import torch_port_data as data

CALIBRATION_SIZE = 64


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """(folder, float checkpoint, JAX's static file, the port's static
    file) for torch_port_data's sharpened yolov5n."""

    folder = tmp_path_factory.mktemp('torch_static_int8')
    f_path = str(folder / 'float.npz')
    save_checkpoint(data.sharpened_params(data.images()), f_path,
                    data.METADATA)
    jax_path = str(folder / 'static_jax.npz')
    jax_quantize_checkpoint(f_path, jax_path,
                            calibration_image_size=CALIBRATION_SIZE,
                            mode='static')
    port_path = str(folder / 'static_port.npz')
    quantize_checkpoint(f_path, port_path,
                        calibration_image_size=CALIBRATION_SIZE,
                        mode='static', device='cpu')
    return folder, f_path, jax_path, port_path


@pytest.mark.parametrize('arch,nc', [('yolov5n', 3), ('yolov5s6', 3),
                                     ('yolov5s', 20)])
def test_quantize_params_identical_to_jax(arch, nc):
    params = yolov5.init_params(yolov5.YoloV5Config(arch, nc), seed=3)
    ref = flatten_params(jax_q.quantize_params(params))
    ours = flatten_params(q.quantize_params(params))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        assert ours[k].tobytes() == ref[k].tobytes(), k
    heads = [k for k in ours if k.startswith('l{}/'.format(
        len(yolov5.YoloV5Config(arch, nc).layers) - 1))]
    assert any(k.endswith('w_q') for k in heads) == (nc >= 17)


def _scale(absmax):
    """calibrate_activation_scales' x_scale of an input abs-max (both
    packages write it so)."""

    return np.float32(max(absmax, 1e-6) / 127.0)


@pytest.fixture(scope='module')
def calibration_inputs(checkpoints):
    """Each int8 conv's float NHWC input in the calibration forward of
    each package, {'l6.m0.cv2': array}: JAX's captured by wrapping its
    quantized_conv, which its _conv calls for every int8 conv, the port's
    by a forward pre-hook on each QConv. Also the calibration samples and
    the float parameters."""

    folder, f_path, _, _ = checkpoints
    params, _ = load_checkpoint(f_path)
    samples = np.random.RandomState(0).uniform(
        0, 1, (4, CALIBRATION_SIZE, CALIBRATION_SIZE, 3)).astype(np.float32)

    params_j = jax_q.quantize_params(params)
    paths = {}

    def walk(node, path):
        if 'w_q' in node:
            paths[id(node)] = '.'.join(path)
            return
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
    walk(params_j, ())
    captured = []
    original = jax_q.quantized_conv

    def recording(p, x, *args, **kwargs):
        captured.append(id(p))
        captured.append(x)
        return original(p, x, *args, **kwargs)

    cfg = jax_yolov5.YoloV5Config('yolov5n', num_classes=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_q, 'quantized_conv', recording)
        xs = jax.jit(lambda x: [
            jax_yolov5.apply(cfg, params_j, x, decode=False),
            captured[1::2]][1])(jnp.asarray(samples))
    jax_inputs = {paths[i]: np.array(x)
                  for i, x in zip(captured[::2], xs)}

    model = yolov5.YoloV5(yolov5.YoloV5Config('yolov5n', 3)).load_params(
        q.quantize_params(params)).eval()
    names = {m: n[len('layers.'):] for n, m in model.named_modules()
             if isinstance(m, yolov5.QConv)}
    port_inputs = {}

    def hook(m, args):
        port_inputs[names[m]] = args[0].permute(0, 2, 3, 1).numpy().copy()

    hooks = [m.register_forward_pre_hook(hook) for m in names]
    for m in names:
        m.stats = {'in': 0.0, 'out': 0.0}
    try:
        with torch.inference_mode():
            model(torch.from_numpy(samples), decode=False)
    finally:
        for h in hooks:
            h.remove()
    assert sorted(jax_inputs) == sorted(port_inputs)
    return jax_inputs, port_inputs, samples, params


def test_calibration_from_the_same_inputs_matches_jax(checkpoints,
                                                     calibration_inputs,
                                                     monkeypatch):
    """Calibration itself, apart from the forward that feeds it: each
    conv given JAX's input records JAX's abs-max and gives JAX's
    dynamic-scale output (1e-6), and those abs-maxes make JAX's x_scale
    (1e-6; measured: identical bytes)."""

    _, _, jax_path, _ = checkpoints
    jax_inputs, _, samples, params = calibration_inputs
    ref = jax_load_checkpoint(jax_path)[0]
    params_q = q.quantize_params(params)
    model = yolov5.YoloV5(yolov5.YoloV5Config('yolov5n', 3)).load_params(
        q.quantize_params(params)).eval()
    modules = {n: m for n, m in model.named_modules()
               if isinstance(m, yolov5.QConv)}
    assert len(modules) == len(jax_inputs) == 13
    recorded = []
    for name, m in modules.items():
        x = jax_inputs[name[len('layers.'):]]
        node = ref
        for key in name.split('.')[1:]:
            node = node[key]
        node = {k: v for k, v in node.items() if k != 'x_scale'}
        m.stats = {'in': 0.0, 'out': 0.0}
        with torch.inference_mode():
            y = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1).numpy()
        absmax = float(np.abs(x).max())
        assert abs(m.stats['in'] / absmax - 1.0) <= 1e-6, name
        pads = [(m.pads[0], m.pads[1]), (m.pads[2], m.pads[3])]
        want = np.asarray(jax.jit(lambda xv, p: jax_q.quantized_conv(
            p, xv, m.stride, pads, act=m.act, accum_dtype=jnp.float32))(
                x, node))
        np.testing.assert_allclose(y, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        recorded.append((name, m.stats))
    monkeypatch.setattr(q, '_calibration_forward',
                        lambda *args: recorded)
    q.calibrate_activation_scales(
        yolov5.YoloV5Config('yolov5n', 3), params_q, samples, device='cpu')
    ours, want = flatten_params(params_q), flatten_params(ref)
    scales = [k for k in want if k.endswith('x_scale')]
    assert len(scales) == 13
    for k in scales:
        assert abs(float(ours[k]) / float(want[k]) - 1.0) <= 1e-6, k
        assert np.float32(ours[k]).tobytes() == \
            np.float32(want[k]).tobytes(), k


def test_calibrated_scales_match_jax(checkpoints, calibration_inputs):
    """End to end: each package writes its own forward's abs-max scales
    exactly; the two forwards drift apart from a few ulps at the first
    int8 conv's input, and the scales with them."""

    _, _, jax_path, port_path = checkpoints
    jax_inputs, port_inputs, _, _ = calibration_inputs
    ref = flatten_params(jax_load_checkpoint(jax_path)[0])
    ours, metadata = load_checkpoint(port_path)
    assert metadata['quantization'] == 'int8-static'
    assert jax_load_checkpoint(jax_path)[1]['quantization'] == 'int8-static'
    ours = flatten_params(ours)
    assert sorted(ours) == sorted(ref)
    scales = [k for k in ref if k.endswith('x_scale')]
    assert len(scales) == sum(k.endswith('w_q') for k in ref) > 10
    rel = {}
    for k in ref:
        if k.endswith('x_scale'):
            name = k[:-len('/x_scale')].replace('/', '.')
            # each file holds its own forward's abs-max, exactly
            assert np.float32(ours[k]) == _scale(
                float(np.abs(port_inputs[name]).max())), k
            assert np.float32(ref[k]) == _scale(
                float(np.abs(jax_inputs[name]).max())), k
            rel[k] = abs(float(ours[k]) / float(ref[k]) - 1.0)
        else:
            assert ours[k].tobytes() == ref[k].tobytes(), k
    # The drift's source: the first int8 conv's input (l3, after the float
    # convs l0-l2, which sum in another order than XLA's) is JAX's within
    # a few float32 ulps of its abs-max (measured 4). Every later int8
    # conv quantizes at a dynamic scale, so an ulp moves some x_q
    # roundings by 1 lsb, and later abs-maxes move further: on this
    # checkpoint the first 10 scales agree within 1e-6 and the last three
    # (l18, l20, l23, the smallest activations) drift up to 1.22e-3
    # (measured), held here within 2e-3.
    first = jax_inputs['l3']
    ulp = np.spacing(np.float32(np.abs(first).max()))
    assert np.abs(port_inputs['l3'] - first).max() <= 8 * ulp
    assert np.median(list(rel.values())) <= 1e-6, rel
    assert sum(r > 1e-3 for r in rel.values()) <= 1, rel
    assert max(rel.values()) <= 2e-3, rel
    with np.load(port_path) as f:
        stored = {k: f[k] for k in f.files if k.endswith('x_scale')}
    assert stored and all(v.dtype == np.float32 and v.shape == ()
                          for v in stored.values())


def _conv_inputs(model, x):
    """{QConv module: its float NHWC input} over one forward."""

    inputs = {}

    def hook(module, args):
        inputs[module] = args[0].permute(0, 2, 3, 1).contiguous()

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, yolov5.QConv)]
    try:
        with torch.inference_mode():
            model(torch.from_numpy(x), decode=False)
    finally:
        for h in hooks:
            h.remove()
    return inputs


def test_each_conv_matches_jax(checkpoints):
    _, _, jax_path, _ = checkpoints
    params, _ = jax_load_checkpoint(jax_path)
    model = yolov5.YoloV5(yolov5.YoloV5Config('yolov5n', 3)).load_params(
        load_checkpoint(jax_path)[0]).eval()
    x = np.random.RandomState(4).uniform(0, 1, (2, 64, 96, 3)).astype(
        np.float32)
    inputs = _conv_inputs(model, x)
    names = {m: n[len('layers.'):] for n, m in model.named_modules()}
    assert len(inputs) == 13
    n_flipped = n_total = 0
    for m, xin in inputs.items():
        node = params
        for key in names[m].split('.'):
            node = node[key]
        strides = (m.stride, m.stride)
        pads = [(m.pads[0], m.pads[1]), (m.pads[2], m.pads[3])]

        def jax_conv(xv, xs, w_q):
            x_q = jnp.clip(jnp.round(xv / xs), -127, 127).astype(jnp.int8)
            acc = jax.lax.conv_general_dilated(
                x_q, w_q, window_strides=strides, padding=pads,
                dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
                preferred_element_type=jnp.int32)
            return x_q, acc

        xv = xin.numpy()
        ref_q, ref_acc = jax.jit(jax_conv)(xv, node['x_scale'], node['w_q'])
        ours_q = torch.clamp(torch.round(xin / m.x_scale), -127,
                             127).to(torch.int8)
        n_flipped += int((ours_q.numpy() != np.asarray(ref_q)).sum())
        n_total += ours_q.numel()
        assert np.abs(ours_q.numpy().astype(np.int32) -
                      np.asarray(ref_q)).max() <= 1
        # the same x_q gives the same int32 sums
        acc = conv_int8.conv_int32_reference(
            torch.from_numpy(np.asarray(ref_q)), m.weight, strides, m.pads)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))
        # and the float output, through each package's quantized_conv
        ref_y = np.asarray(jax.jit(lambda xv, p: jax_q.quantized_conv(
            p, xv, m.stride, pads, act=m.act,
            accum_dtype=jnp.float32))(xv, node))
        ours_y = q.quantized_conv(xin, m.weight, m.w_scale, m.bias,
                                  m.stride, m.pads, act=m.act,
                                  x_scale=m.x_scale).numpy()
        np.testing.assert_allclose(ours_y, ref_y, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref_y).max())
    assert n_flipped <= 1e-4 * n_total, (n_flipped, n_total)


def test_forward_matches_jax_apply(checkpoints):
    _, _, jax_path, _ = checkpoints
    params, _ = jax_load_checkpoint(jax_path)
    cfg = jax_yolov5.YoloV5Config('yolov5n', num_classes=3)
    x = np.random.RandomState(2).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ref = jax.jit(lambda p, x: jax_yolov5.apply(cfg, p, x, decode=False))(
        params, x)
    model = yolov5.YoloV5(yolov5.YoloV5Config('yolov5n', 3)).load_params(
        load_checkpoint(jax_path)[0]).eval()
    with torch.inference_mode():
        ours = model(torch.from_numpy(x), decode=False)
    for r, o in zip(ref, ours):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())
