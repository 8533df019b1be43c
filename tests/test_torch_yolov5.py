"""
Port parity: parameters, checkpoint I/O and the YOLOv5 forward of
megadetector_tpu_torch against the JAX package, on the CPU.

Same numpy parameters and inputs go through both packages. Parameters
and checkpoints must be identical; the forward agrees to rtol 1e-4 and
atol 1e-4 * max|ref| (the CPU convolutions of XLA and PyTorch sum in
different orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megadetector_tpu.models import convert_weights as jax_convert
from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu_torch.models import convert_weights
from megadetector_tpu_torch.models import yolov5

ARCHS = ['yolov5n', 'yolov5n6']


def _assert_close_scaled(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize('arch', ['yolov5n', 'yolov5n6', 'yolov5s',
                                  'yolov5l6', 'yolov5x'])
def test_config_matches_jax(arch):
    ours = yolov5.YoloV5Config(arch, num_classes=3)
    ref = jax_yolov5.YoloV5Config(arch, num_classes=3)
    assert ours.layers == ref.layers
    assert ours.strides == ref.strides
    assert ours.save_indices == ref.save_indices
    np.testing.assert_array_equal(ours.anchors, ref.anchors)


@pytest.mark.parametrize('arch', ARCHS)
def test_init_params_identical_to_jax(arch):
    ours = convert_weights.flatten_params(
        yolov5.init_params(yolov5.YoloV5Config(arch, 3), seed=3))
    ref = jax_convert.flatten_params(
        jax_yolov5.init_params(jax_yolov5.YoloV5Config(arch, 3), seed=3))
    assert ours.keys() == ref.keys()
    for key in ref:
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_params_to_torch_round_trips():
    params = yolov5.init_params(yolov5.YoloV5Config('yolov5n', 3), seed=0)
    converted = convert_weights.flatten_params(
        convert_weights.params_to_torch(params))
    flat = convert_weights.flatten_params(params)
    assert converted.keys() == flat.keys()
    for key, value in flat.items():
        t = converted[key]
        assert t.dtype == np.float32
        back = t.transpose(2, 3, 1, 0) if key.endswith('/w') else t
        np.testing.assert_array_equal(back, value, err_msg=key)


def test_model_state_holds_the_params():
    config = yolov5.YoloV5Config('yolov5n6', 3)
    params = yolov5.init_params(config, seed=0)
    model = yolov5.YoloV5(config).load_params(params)
    conv = model.layers['l2'].m0.cv2
    np.testing.assert_array_equal(
        conv.weight.detach().numpy(),
        params['l2']['m0']['cv2']['w'].transpose(3, 2, 0, 1))
    head = model.layers['l33'].m3
    np.testing.assert_array_equal(head.bias.detach().numpy(),
                                  params['l33']['m3']['b'])


def test_checkpoint_format_shared_with_jax(tmp_path):
    params = yolov5.init_params(yolov5.YoloV5Config('yolov5n', 3), seed=1)
    meta = {'arch': 'yolov5n', 'num_classes': 3, 'image_size': 128}
    path = str(tmp_path / 'm.npz')
    convert_weights.save_checkpoint(params, path, meta)

    ours, ours_meta = convert_weights.load_checkpoint(path)
    ref, ref_meta = jax_convert.load_checkpoint(path)
    assert ours_meta == ref_meta == meta
    flat_ours = convert_weights.flatten_params(ours)
    flat_ref = jax_convert.flatten_params(ref)
    assert flat_ours.keys() == flat_ref.keys()
    for key in flat_ref:
        np.testing.assert_array_equal(flat_ours[key], flat_ref[key])

    # Folder form: weights.npz + metadata.json
    folder = tmp_path / 'ckpt'
    folder.mkdir()
    convert_weights.save_checkpoint(params, str(folder / 'weights.npz'))
    (folder / 'metadata.json').write_text('{"arch": "yolov5n"}')
    _, folder_meta = convert_weights.load_checkpoint(str(folder))
    assert folder_meta == {'arch': 'yolov5n'}


def test_quantized_checkpoint_is_refused(tmp_path):
    """int8 checkpoints load (int8 leaves kept, static scales as Python
    floats); the model refuses only the JAX package's mode=static nodes
    (an x_scale without a y_scale), which the port does not run."""

    from megadetector_tpu_torch.ops import quantization

    config = yolov5.YoloV5Config('yolov5n', 3)
    params = quantization.quantize_params_chain(
        yolov5.init_params(config, seed=0), skip_names=('l24',),
        float_store_names=('l0',))
    params['l1']['x_scale'] = 0.02
    path = str(tmp_path / 'q.npz')
    convert_weights.save_checkpoint(params, path)
    loaded, _ = convert_weights.load_checkpoint(path)
    assert loaded['l1']['w_q'].dtype == np.int8
    assert isinstance(loaded['l1']['x_scale'], float)
    with pytest.raises(NotImplementedError, match='int8'):
        yolov5.YoloV5(config).load_params(loaded)


@pytest.mark.parametrize('arch', ARCHS)
def test_forward_matches_jax(arch):
    config = yolov5.YoloV5Config(arch, 3)
    params = yolov5.init_params(config, seed=0)
    x = np.random.RandomState(5).rand(2, 128, 128, 3).astype(np.float32)

    model = yolov5.YoloV5(config).load_params(params).eval()
    with torch.inference_mode():
        heads = model(torch.from_numpy(x), decode=False)
        decoded = model(torch.from_numpy(x), decode=True)

    jax_config = jax_yolov5.YoloV5Config(arch, 3)
    ref_heads = jax_yolov5.apply(jax_config, params, jnp.asarray(x),
                                 decode=False)
    ref_decoded = jax_yolov5.apply(jax_config, params, jnp.asarray(x))

    assert len(heads) == len(ref_heads) == len(config.strides)
    for got, ref in zip(heads, ref_heads):
        assert tuple(got.shape) == tuple(ref.shape)
        _assert_close_scaled(got.numpy(), ref)
    assert tuple(decoded.shape) == tuple(ref_decoded.shape)
    _assert_close_scaled(decoded.numpy(), ref_decoded)
