"""
The detector on int8 static-scale checkpoints (quantize_checkpoint
mode='static'), held to the JAX package on the CPU; the checkpoints are
tests/test_torch_static_int8.py's (torch_port_data's sharpened yolov5n,
calibrated at 64 px by each package):

- float32 detections at the golden tolerances (conf 0.005, coord 0.001,
  detections from 0.01: the 0.005 floor plus the conf tolerance) against
  the JAX TPUDetector, on files written by either package (each loads
  and runs in the other's detector);
- bf16 no further from JAX's float32 than JAX's bf16 is (IoU-matched
  above 0.02: measured 1 unmatched, conf error max 0.021, mean 0.0036,
  against JAX's 2, 0.023, 0.0035);
- detect heads quantized at nc >= 17: JAX's forward fails there
  (_conv_linear reads 'w'; ROADMAP C), the port runs them as JAX's own
  quantized_conv computes an int8 conv without SiLU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu.models.detector import TPUDetector
from megadetector_tpu.ops import quantization as jax_q
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.ops import quantization as q

import torch_port_data as data
from test_torch_static_int8 import _conv_inputs, checkpoints  # noqa: F401


def _results(detections):
    return {'images': [dict(r, detections=[
        dict(d, bbox=list(d['bbox'])) for d in r['detections']])
        for r in detections]}


def _run(detector, images):
    ids = ['im{}'.format(i) for i in range(len(images))]
    return detector.generate_detections_one_batch(images, ids, 0.005)


@pytest.mark.parametrize('which', ['jax', 'port'])
def test_detector_matches_jax_on_either_file(checkpoints, which):
    """A static file written by either package runs in the other's
    detector, at the golden tolerances."""

    _, _, jax_path, port_path = checkpoints
    path = jax_path if which == 'jax' else port_path
    images = data.images()
    ref = _run(TPUDetector(path, {'force_cpu': True}), images)
    ours = _run(run_detector.load_detector(path, device='cpu'), images)
    assert sum(len(r['detections']) for r in ours) > 20
    # Both run at the 0.005 floor; a detection within the conf tolerance
    # of the floor may sit on either side of it, so compare from the floor
    # plus that tolerance
    options = data.golden_options()
    options.comparison_confidence_threshold = 0.01
    result = md_tests.compare_results(_results(ref), _results(ours), options)
    assert result['n_images_compared'] == len(images)
    assert result['errors'] == [], result['errors'][:5]


def test_bf16_detector_within_jax_bf16_error(checkpoints):
    from test_torch_bf16 import _distance

    _, _, jax_path, _ = checkpoints
    images = data.images()
    jax32 = _run(TPUDetector(jax_path, {'force_cpu': True}), images)
    jax16 = _run(TPUDetector(jax_path, {'force_cpu': True,
                                        'dtype': 'bfloat16'}), images)
    port = run_detector.load_detector(jax_path, device='cpu',
                                      detector_options={'dtype': 'bf16'})
    assert port.model.stem_w is not None
    ours = _run(port, images)
    own = _distance(jax32, jax16)
    got = _distance(jax32, ours)
    assert sum(len(r['detections']) for r in ours) > 20
    assert got[0] <= own[0] + 1 and got[1] <= own[1] and \
        got[2] <= 1.25 * own[2], (got, own)


def test_quantized_heads_run_where_jax_fails(tmp_path):
    # yolov5s: the 512-channel head (1x1, c_in >= 288) quantizes at nc 20
    cfg = yolov5.YoloV5Config('yolov5s', num_classes=20)
    params = q.quantize_params(yolov5.init_params(cfg, seed=1))
    x = np.random.RandomState(3).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    q.calibrate_activation_scales(cfg, params, x, device='cpu')
    detect = 'l{}'.format(len(cfg.layers) - 1)
    assert 'w_q' in params[detect]['m2'] and 'w' in params[detect]['m0']
    with pytest.raises(KeyError):
        jax.eval_shape(lambda x: jax_yolov5.apply(
            jax_yolov5.YoloV5Config('yolov5s', 20), params, x), x)

    model = yolov5.YoloV5(cfg).load_params(params).eval()
    inputs = _conv_inputs(model, x)
    head = model.layers[detect].m2
    assert isinstance(head, yolov5.QConv) and not head.act
    with torch.inference_mode():
        raw = model(torch.from_numpy(x), decode=False)
    ref = np.asarray(jax_q.quantized_conv(
        params[detect]['m2'], inputs[head].numpy(), 1, 0, act=False,
        accum_dtype=jnp.float32))
    np.testing.assert_allclose(raw[2].numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())

    path = str(tmp_path / 'nc20.npz')
    save_checkpoint(params, path, {
        'arch': 'yolov5s', 'model_type': 'yolov5', 'num_classes': 20,
        'class_names': ['c{}'.format(i) for i in range(20)],
        'image_size': 64})
    detector = run_detector.load_detector(
        path, device='cpu',
        detector_options={'use_model_native_classes': True})
    out = detector.generate_detections_one_image(
        (x[0] * 255).astype(np.uint8), 'x.jpg', detection_threshold=0.1)
    assert out['detections'] is not None
    json.dumps(out)
