"""
The port on a CUDA card: the greedy-NMS kernel against its plain version,
and the card's selection, NMS and detector against the CPU's.

Every test is marked `cuda` and skips without a card. This file imports
no jax, so it also runs on a machine without the JAX package's
dependencies (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from megadetector_tpu.utils import md_tests
from megadetector_tpu_torch.detection import run_detector
from megadetector_tpu_torch.models.convert_weights import save_checkpoint
from megadetector_tpu_torch.ops import cuda_nms, decode, nms

import torch_port_data as data

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from megadetector_tpu_torch.device import set_float32_exact
    set_float32_exact()
    return torch.device('cuda')


def _offset_boxes(rng, b, k, canvas=1280.0):
    xy = rng.uniform(0, canvas, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(8, 240, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    boxes += rng.randint(0, 3, (b, k, 1)).astype(np.float32) * 8192.0
    return boxes, rng.rand(b, k) > 0.1


def _kernel_vs_plain(device, boxes, valid, thresh):
    boxes_d = torch.from_numpy(boxes).to(device)
    valid_d = torch.from_numpy(valid).to(device)
    before = cuda_nms.launches
    keep = cuda_nms.greedy_nms_keep(boxes_d, valid_d, thresh)
    torch.cuda.synchronize()
    assert cuda_nms.launches == before + 1
    ref = cuda_nms.greedy_nms_keep_reference(torch.from_numpy(boxes),
                                             torch.from_numpy(valid), thresh)
    assert torch.equal(keep.cpu(), ref)
    return keep.cpu()


@pytest.mark.parametrize('b,k', [(8, 512), (8, 2048), (8, 8192), (3, 1000),
                                 (1, 1), (2, 65)])
def test_kernel_identical_to_plain(cuda_device, b, k):
    rng = np.random.RandomState(k)
    _kernel_vs_plain(cuda_device, *_offset_boxes(rng, b, k), 0.45)


def test_kernel_chain_duplicates_invalid(cuda_device):
    # A overlaps B, B overlaps C, A does not overlap C: A and C are kept
    chain = np.array([[[100, 100, 140, 140], [120, 100, 160, 140],
                       [140, 100, 180, 140], [500, 500, 540, 540]]],
                     np.float32)
    keep = _kernel_vs_plain(cuda_device, chain, np.ones((1, 4), bool), 0.2)
    assert keep.tolist() == [[True, False, True, True]]

    boxes, valid = _offset_boxes(np.random.RandomState(1), 2, 130)
    boxes[:, 1] = boxes[:, 0]
    boxes[:, 64] = boxes[:, 0]
    boxes[:, 65] = boxes[:, 3]
    valid[:, 0] = True
    valid[:, 3] = False
    valid[:, 100:110] = False
    keep = _kernel_vs_plain(cuda_device, boxes, valid, 0.45)
    assert not keep[:, 1].any() and not keep[:, 64].any()


def test_kernel_rejects_bad_inputs(cuda_device):
    boxes = torch.zeros((2, 16, 4), device=cuda_device)
    valid = torch.ones((2, 16), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        cuda_nms.greedy_nms_keep(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError):
        cuda_nms.greedy_nms_keep(boxes, valid.cpu(), 0.5)
    with pytest.raises(ValueError):
        cuda_nms.greedy_nms_keep(boxes[:, ::2], valid[:, ::2], 0.5)


def test_selection_and_nms_match_cpu(cuda_device):
    rng = np.random.RandomState(3)
    heads = [(rng.standard_normal((2, h, w, 24)) * 3).astype(np.float32)
             for h, w in ((32, 40), (16, 20), (8, 10), (4, 5))]
    anchors = np.asarray([[(19, 27), (44, 40), (38, 94)],
                          [(96, 68), (86, 152), (180, 137)],
                          [(140, 301), (303, 264), (238, 542)],
                          [(436, 615), (739, 380), (925, 792)]], np.float32)
    outs = []
    for device in ('cpu', cuda_device):
        cands = decode.select_topk_candidates(
            [torch.from_numpy(h).to(device) for h in heads], anchors,
            (8, 16, 32, 64), 3, 0.005, 2048)
        outs.append((cands, nms.nms_on_candidates(cands, 0.45)))
    (c_cpu, n_cpu), (c_gpu, n_gpu) = outs
    for key in ('classes', 'valid', 'n_candidates'):
        assert torch.equal(c_gpu[key].cpu(), c_cpu[key]), key
    torch.testing.assert_close(c_gpu['scores'].cpu(), c_cpu['scores'],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(c_gpu['boxes_cxcywh'].cpu(),
                               c_cpu['boxes_cxcywh'], rtol=2e-6, atol=1e-4)
    assert torch.equal(n_gpu['valid'].cpu(), n_cpu['valid'])
    assert torch.equal(n_gpu['classes'].cpu(), n_cpu['classes'])


def test_detector_on_card_matches_cpu(cuda_device, tmp_path):
    imgs = data.images()
    model = str(tmp_path / 'm.npz')
    save_checkpoint(data.sharpened_params(imgs), model, data.METADATA)
    results = {}
    for device in ('cpu', 'cuda'):
        detector = run_detector.load_detector(model, device=device)
        before = cuda_nms.launches
        results[device] = {'images': detector.generate_detections_one_batch(
            imgs, ['im{}'.format(i) for i in range(len(imgs))],
            detection_threshold=0.005)}
        if device == 'cuda':
            assert cuda_nms.launches > before
    result = md_tests.compare_results(results['cpu'], results['cuda'],
                                      data.golden_options())
    assert result['n_images_compared'] == len(imgs)
    assert result['errors'] == [], result['errors'][:5]
