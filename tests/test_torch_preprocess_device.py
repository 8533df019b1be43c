"""
The port's device letterbox (ops/preprocess_device.py) on the CPU against
the JAX package's (megadetector_tpu/ops/preprocess_device.py):

- letterbox_batch (the matmul form) vs JAX letterbox_batch: float32 within
  1e-5 (the same two-term interpolation sums; products and sums may round
  in another order); with bf16 operands within 1e-5 of JAX's bf16 resize
  and within 2/255 of the float32 resize (the bound the JAX module states
  for rounding the weights to bf16);
- the gather form (the oracle) vs the matmul form within 1e-5;
- at ratio 1 (images equal to the canvas) the letterbox is the image / 255
  bit for bit, which is what the detector's identity path computes;
- stage_images identical;
- the batch runner in device mode (staged infos through canvas buckets,
  batch padding and the writer) against the JAX package's, on files;
- the detector in device mode: a batch of images that equal the canvas
  takes the identity path and gives the host path's detections exactly;
  other images go through the device letterbox and match the JAX
  TPUDetector in device mode at the golden tolerances.
"""

import numpy as np
import pytest
import torch

from PIL import Image

import jax.numpy as jnp

import torch_port_data as data

from megadetector_tpu.ops import preprocess_device as jax_pre
from megadetector_tpu.detection import run_detector_batch as jax_batch
from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector, run_detector_batch
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.ops import boxes
from megadetector_tpu_torch.ops import preprocess_device as pre

# (image sizes, canvas, scale_target): square canvases (auto=False) and a
# minimal stride rectangle of the auto canvas mode
CASES = [
    ([(240, 320), (300, 200), (256, 256)], 256, None),
    ([(97, 131), (180, 64)], (192, 160), None),
    ([(480, 640), (600, 800)], (192, 256), 256),
    ([(333, 250)], (256, 192), 256),
]


def _images(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


def _jax(staged, sizes, canvas, scale_target, resize_dtype=None):
    out_size = canvas if isinstance(canvas, int) else tuple(canvas)
    return np.asarray(jax_pre.letterbox_batch(
        jnp.asarray(staged), jnp.asarray(sizes), out_size,
        scale_target=scale_target, resize_dtype=resize_dtype))


@pytest.mark.parametrize('sizes,canvas,scale_target', CASES)
def test_letterbox_batch_matches_jax(sizes, canvas, scale_target):
    staged, hw = pre.stage_images(_images(sizes), multiple=64)
    ref = _jax(staged, hw, canvas, scale_target)
    ours = pre.letterbox_batch(torch.from_numpy(staged),
                               torch.from_numpy(hw), canvas,
                               scale_target=scale_target).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-5

    gather = pre.letterbox_batch_gather(torch.from_numpy(staged),
                                        torch.from_numpy(hw), canvas,
                                        scale_target=scale_target).numpy()
    assert np.abs(gather - ours).max() <= 1e-5

    ref_bf16 = _jax(staged, hw, canvas, scale_target, jnp.bfloat16)
    ours_bf16 = pre.letterbox_batch(
        torch.from_numpy(staged), torch.from_numpy(hw), canvas,
        scale_target=scale_target, resize_dtype=torch.bfloat16).numpy()
    assert np.abs(ours_bf16 - ref_bf16).max() <= 1e-5
    assert np.abs(ours_bf16 - ref).max() <= 2.0 / 255.0


@pytest.mark.parametrize('sizes,canvas,scale_target', [CASES[0], CASES[2]])
def test_geometry_matches_host_letterbox(sizes, canvas, scale_target):
    """The canvas each image lands on is the host letterbox's: same padding
    rows and columns (gray 114), content within the bilinear rounding of
    cv2's uint8 output."""

    images = _images(sizes, seed=1)
    staged, hw = pre.stage_images(images, multiple=64)
    ours = pre.letterbox_batch(torch.from_numpy(staged),
                               torch.from_numpy(hw), canvas,
                               scale_target=scale_target).numpy() * 255.0
    square = scale_target or canvas
    for img, got in zip(images, ours):
        host, _, _ = boxes.letterbox(img, (square, square), stride=64,
                                     auto=scale_target is not None)
        assert host.shape == got.shape
        pad = host.astype(np.int32) == 114
        assert np.abs(got - host).max() <= 1.5, np.abs(got - host).max()
        assert np.all(np.abs(got[pad.all(-1)] - 114.0) <= 1.5)


def test_identity_is_the_letterbox_at_ratio_one():
    images = _images([(192, 256), (192, 256)], seed=2)
    staged, hw = pre.stage_images(images, multiple=256)
    assert staged.shape[1:3] == (256, 256)
    out = pre.letterbox_batch(torch.from_numpy(staged), torch.from_numpy(hw),
                              (192, 256), scale_target=256)
    identity = torch.from_numpy(staged)[:, :192, :256].to(torch.float32) / \
        torch.full((), 255.0)
    assert torch.equal(out, identity)


def test_stage_images_matches_jax():
    images = _images([(97, 131), (180, 64), (5, 7)])
    for kwargs in ({}, {'multiple': 64}, {'staging_size': 200},
                   {'staging_size': (192, 160)}):
        ours = pre.stage_images(images, **kwargs)
        ref = jax_pre.stage_images(images, **kwargs)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match='staging'):
        pre.stage_images(images, staging_size=100)
    with pytest.raises(NotImplementedError):
        pre.letterbox_batch(torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
                            torch.tensor([[8, 8]]), 8, fold_layout='h2')


def test_detector_device_mode_identity_and_letterbox(tmp_path):
    model = str(tmp_path / 'md_v5a.0.0_test.npz')
    images = data.images()
    save_checkpoint(data.sharpened_params(images), model, data.METADATA)
    size = data.IMAGE_SIZE
    rng = np.random.RandomState(3)
    exact = [np.clip(images[0][:1, :1].astype(np.int32) +
                     rng.randint(-30, 30, (size, size, 3)), 0, 255).astype(
                         np.uint8) for _ in range(2)]
    host = run_detector.load_detector(model, device='cpu')
    device = run_detector.load_detector(
        model, device='cpu', detector_options={'preprocess_mode': 'device'})

    want = host.generate_detections_one_batch(exact, ['a', 'b'], 0.005)
    got = device.generate_detections_one_batch(exact, ['a', 'b'], 0.005)
    assert device.identity_programs_run == 1
    assert got == want

    # Other images letterbox on the device: the JAX detector in device mode
    # gives the same detections at the golden tolerances
    from megadetector_tpu.models.detector import TPUDetector
    ref = TPUDetector(model, detector_options={
        'preprocess_mode': 'device', 'force_cpu': True})
    want = ref.generate_detections_one_batch(images[:4], list('wxyz'), 0.005)
    got = device.generate_detections_one_batch(images[:4], list('wxyz'),
                                               0.005)
    assert device.identity_programs_run == 1 and device.programs_run == 2
    for w, g in zip(want, got):
        assert 0 < len(g['detections']) < 300
        result = md_tests.compare_detection_lists(
            w['detections'], g['detections'], options=data.golden_options(),
            image_id=g['file'])
        assert result['errors'] == [], result['errors'][:5]


def test_batch_runner_device_mode_matches_jax(tmp_path):
    """Two aspect buckets at batch 4: one full batch and one tail of 3,
    padded to 4 by repeating its last image."""

    images = data.images()
    folder = tmp_path / 'images'
    folder.mkdir()
    for i, img in enumerate(images):
        Image.fromarray(img).save(str(folder / 'im{:02d}.png'.format(i)))
    model = str(tmp_path / 'md_v5a.0.0_test.npz')
    save_checkpoint(data.sharpened_params(images), model, data.METADATA)
    options = {'preprocess_mode': 'device'}
    ours = run_detector_batch.load_and_run_detector_batch(
        model, str(folder), batch_size=4, quiet=True, device='cpu',
        include_image_size=True, detector_options=dict(options))
    ref = jax_batch.load_and_run_detector_batch(
        model, str(folder), batch_size=4, quiet=True, loader_workers=1,
        include_image_size=True, detector_options=dict(
            options, force_cpu=True, use_mesh='false'))
    for r, img in zip(ours, images):
        assert (r['height'], r['width']) == img.shape[:2]
    ours_out = run_detector_batch.write_results_to_file(
        ours, str(tmp_path / 'ours.json'), relative_path_base=str(folder))
    ref_out = jax_batch.write_results_to_file(
        ref, str(tmp_path / 'ref.json'), relative_path_base=str(folder))
    assert [im['file'] for im in ours_out['images']] == \
        [im['file'] for im in ref_out['images']]
    result = md_tests.compare_results(ref_out, ours_out,
                                      data.golden_options())
    assert result['n_images_compared'] == len(images)
    assert result['errors'] == [], result['errors'][:5]
