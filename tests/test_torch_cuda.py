"""
The port on a CUDA card: the greedy-NMS, int8 conv, fused int8
bottleneck, fused stem and bf16 epilogue kernels (and the epilogue's
backward), and the int8 experiments' conv (every epilogue) and GEMM
kernels, against their plain versions, and the card's selection, NMS,
detectors (float32, int8 chain, int8 static and bf16) and training steps
(a bf16 detector step, a classifier step) against the CPU's; the
accelerator probe on the card; the path kernels through their custom
operators (mdtorch::*), the NMS kernel's device-memory threshold in one
captured graph, and the exported artifact against the live detector.

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
from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.models.convert_weights import quantize_checkpoint
from megadetector_tpu_torch.ops import (bottleneck_int8, conv_int8,
                                        cuda_nms, decode, gemm_int8,
                                        l0_fused, nms, silu_bf16)

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


def test_kernel_segmented_sweep_and_invalid_images(cuda_device):
    """K = 16383 (256 mask words a row: the sweep walks each chunk's tile
    in two ring stages; K not a multiple of 64), against the plain
    version on the card; and an image with no valid slot beside one with
    all valid."""

    boxes, valid = _offset_boxes(np.random.RandomState(16383), 1, 16383)
    boxes_d = torch.from_numpy(boxes).to(cuda_device)
    valid_d = torch.from_numpy(valid).to(cuda_device)
    before = cuda_nms.launches
    keep = cuda_nms.greedy_nms_keep(boxes_d, valid_d, 0.45)
    torch.cuda.synchronize()
    assert cuda_nms.launches == before + 1
    ref = cuda_nms.greedy_nms_keep_reference(boxes_d, valid_d, 0.45)
    assert torch.equal(keep, ref)
    assert 0 < int(keep.sum()) < int(valid_d.sum())
    del boxes_d, valid_d, keep, ref
    torch.cuda.empty_cache()

    boxes, valid = _offset_boxes(np.random.RandomState(2), 2, 300)
    valid[0] = False
    valid[1] = True
    keep = _kernel_vs_plain(cuda_device, boxes, valid, 0.45)
    assert not keep[0].any() and keep[1].any()


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


def _int8(rng, shape):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))


def _conv_case(rng, cin, cout, k):
    """int8 weight, and a scale that puts acc * scale at about unit std"""
    w = _int8(rng, (cout, k, k, cin))
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, cout) / (
        np.sqrt(cin * k * k) * 127.0 * 127.0 / 3.0)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-0.5, 0.5, cout).astype(np.float32))
    return w, scale, bias


# The last column is the instance conv_tiling picks, (bm, bn, bk, vec):
# M off both tiles ([1,13,21], [3,15,20]), Cout 8 to 1024, Cin 4 / 24 /
# 36 / 516 on 4-byte copies and 64 / 128 / 768 / 1024 on 16-byte ones,
# a long K (3x3 over 1024), and both tiles of the small-grid rule
@pytest.mark.parametrize('b,h,w,cin,cout,k,stride,pads,tiling', [
    (2, 16, 16, 128, 128, 3, (1, 1), (1, 1, 1, 1), (64, 128, 128, 16)),
    (1, 13, 21, 36, 72, 3, (1, 1), (1, 1, 1, 1), (64, 128, 64, 4)),
    (2, 17, 23, 64, 96, 3, (2, 2), (1, 1, 1, 1), (64, 128, 64, 16)),
    (1, 9, 30, 516, 200, 1, (1, 1), (0, 0, 0, 0), (64, 128, 64, 4)),
    (1, 8, 12, 4, 8, 6, (2, 2), (2, 2, 2, 2), (64, 64, 64, 4)),
    (1, 10, 11, 24, 40, 3, (2, 1), (1, 1, 1, 0), (64, 64, 64, 4)),
    (3, 15, 20, 768, 1024, 1, (1, 1), (0, 0, 0, 0), (64, 128, 128, 16)),
    (1, 15, 20, 1024, 128, 3, (1, 1), (1, 1, 1, 1), (64, 128, 128, 16)),
    (4, 64, 66, 64, 64, 1, (1, 1), (0, 0, 0, 0), (128, 64, 64, 16)),
    (2, 60, 80, 128, 256, 3, (1, 1), (1, 1, 1, 1), (128, 128, 128, 16)),
    (1, 33, 41, 256, 64, 3, (2, 2), (1, 1, 1, 1), (64, 64, 128, 16)),
    (4, 64, 66, 64, 128, 1, (1, 1), (0, 0, 0, 0), (128, 128, 64, 16)),
    (4, 64, 66, 36, 100, 1, (1, 1), (0, 0, 0, 0), (128, 128, 64, 4)),
])
def test_conv_kernel_identical_to_plain(cuda_device, b, h, w, cin, cout, k,
                                        stride, pads, tiling):
    rng = np.random.RandomState(cin + cout)
    x = _int8(rng, (b, h, w, cin))
    wq, scale, bias = _conv_case(rng, cin, cout, k)
    dev = [t.to(cuda_device) for t in (x, wq, scale, bias)]
    ho = (h + pads[0] + pads[1] - k) // stride[0] + 1
    wo = (w + pads[2] + pads[3] - k) // stride[1] + 1
    assert tuple(conv_int8.conv_tiling(b * ho * wo, cin, cout)[:4]) == \
        tiling
    for y_scale in (None, 0.013):
        before = conv_int8.launches
        got = conv_int8.conv_int8(*dev, stride, pads, y_scale)
        torch.cuda.synchronize()
        assert conv_int8.launches == before + 1
        ref = conv_int8.conv_int8_reference(x, wq, scale, bias, stride, pads,
                                            y_scale)
        ref_card = conv_int8.conv_int8_reference(*dev, stride, pads,
                                                 y_scale)
        assert got.dtype == ref.dtype and tuple(got.shape) == \
            tuple(ref.shape)
        assert torch.equal(got.cpu(), ref_card.cpu())
        if y_scale is None:
            assert torch.equal(got.cpu(), ref)
        else:
            diff = (got.cpu().int() - ref.int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) \
                <= 1e-3


def test_conv_kernel_misaligned_view(cuda_device):
    """x 4 bytes past a 16-byte boundary (a contiguous view into a larger
    buffer): the wrapper takes the 4-byte instance and the result is
    identical; the kernel refuses the 16-byte instance for it."""

    from megadetector_tpu_torch.ops import _build

    rng = np.random.RandomState(11)
    x = _int8(rng, (2, 9, 11, 64))
    wq, scale, bias = [t.to(cuda_device) for t in _conv_case(rng, 64, 72, 3)]
    buf = torch.zeros(x.numel() + 4, dtype=torch.int8, device=cuda_device)
    xv = buf[4:].view(x.shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16 == 4
    assert conv_int8.conv_tiling(2 * 9 * 11, 64, 72, False).vec == 4
    for y_scale in (None, 0.013):
        before = conv_int8.launches
        got = conv_int8.conv_int8(xv, wq, scale, bias, (1, 1), (1, 1, 1, 1),
                                  y_scale)
        torch.cuda.synchronize()
        assert conv_int8.launches == before + 1
        assert torch.equal(got, conv_int8.conv_int8_reference(
            xv, wq, scale, bias, (1, 1), (1, 1, 1, 1), y_scale))
    got = conv_int8.conv3x3_int8_exp(xv, wq, scale, bias, 0.8531, 0.043,
                                     'hybrid')
    assert torch.equal(got, conv_int8.conv3x3_int8_exp_reference(
        xv, wq, scale, bias, 0.8531, 0.043, 'hybrid'))

    lib = _build.load_library()
    out = torch.empty((2, 9, 11, 72), dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.md_conv_int8(xv.data_ptr(), wq.data_ptr(), 0, 0, out.data_ptr(),
                           2, 9, 11, 64, 72, 3, 3, 1, 1, 1, 1, 9, 11, 0.0, 0,
                           conv_int8.INST_VEC16, stream)
    assert err != 0
    err = lib.md_conv3x3_int8_exp(
        xv.data_ptr(), wq.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), 2, 9, 11, 64, 72, 0, 1.0, 1.0, 1,
        conv_int8.INST_VEC16 | conv_int8.INST_BK128, stream)
    assert err != 0
    torch.cuda.synchronize()


# Every instance of the bottleneck kernel (bn, vec) at its edges: H and W
# off the 16 x 8 tile, a 1-pixel-high image, K and N tails (C 36, 144,
# 516 on 4-byte words or a 16-wide last N chunk), the yolov5l6 levels'
# C (the C = 512 level is routed unfused, but the kernel takes it), and
# the largest C that fits shared memory
@pytest.mark.parametrize('shortcut', [True, False])
@pytest.mark.parametrize('b,h,w,c,tiling', [
    (2, 12, 16, 128, (128, 16)), (1, 9, 8, 128, (128, 16)),
    (1, 60, 8, 64, (64, 16)), (2, 17, 35, 36, (64, 4)),
    (1, 5, 7, 516, (128, 4)), (1, 1, 9, 144, (128, 16)),
    (2, 33, 20, 256, (128, 16)), (1, 23, 17, 384, (128, 16)),
    (2, 15, 20, 512, (128, 16)), (1, 6, 10, 896, (128, 16)),
    (1, 3, 1, 48, (64, 16))])
def test_bottleneck_kernel_identical_to_plain(cuda_device, b, h, w, c,
                                              tiling, shortcut):
    """The kernel against its plain version and against the unfused pair
    of conv kernels with the residual in torch (conv_backend xla's
    route): identical."""

    rng = np.random.RandomState(c + h)
    x = _int8(rng, (b, h, w, c))
    w1, scale1, bias1 = _conv_case(rng, c, c, 1)
    w2, scale2, bias2 = _conv_case(rng, c, c, 3)
    args = (x, w1, scale1, bias1, 0.021, w2, scale2, bias2, 0.033,
            0.007, shortcut)
    dev = [a.to(cuda_device) if torch.is_tensor(a) else a for a in args]
    assert tuple(bottleneck_int8.kernel_tiling(c)[:2]) == tiling
    before = bottleneck_int8.launches
    got, got_scale = bottleneck_int8.bottleneck_int8(*dev)
    torch.cuda.synchronize()
    assert bottleneck_int8.launches == before + 1
    ref, ref_scale = bottleneck_int8.bottleneck_int8_reference(*dev)
    assert got_scale == ref_scale
    assert torch.equal(got, ref)
    h1 = conv_int8.conv_int8(dev[0], dev[1], dev[2], dev[3], (1, 1),
                             (0, 0, 0, 0), 0.021)
    h2 = conv_int8.conv_int8(h1, dev[5], dev[6], dev[7], (1, 1),
                             (1, 1, 1, 1), 0.033)
    if shortcut:
        h2 = bottleneck_int8.residual_requant(dev[0], 0.007, h2, 0.033)[0]
    assert torch.equal(got, h2)


def test_bottleneck_kernel_misaligned_view(cuda_device):
    """x 4 bytes past a 16-byte boundary: the wrapper takes the 4-byte
    instance and the result is identical; the kernel refuses the 16-byte
    instance for it, and a C whose h1 tile does not fit raises."""

    from megadetector_tpu_torch.ops import _build

    rng = np.random.RandomState(12)
    c = 64
    x = _int8(rng, (2, 9, 11, c))
    w1, s1, b1 = [t.to(cuda_device) for t in _conv_case(rng, c, c, 1)]
    w2, s2, b2 = [t.to(cuda_device) for t in _conv_case(rng, c, c, 3)]
    buf = torch.zeros(x.numel() + 4, dtype=torch.int8, device=cuda_device)
    xv = buf[4:].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 == 4
    assert bottleneck_int8.kernel_tiling(c, False).vec == 4
    args = (xv, w1, s1, b1, 0.021, w2, s2, b2, 0.033, 0.007, True)
    got, _ = bottleneck_int8.bottleneck_int8(*args)
    assert torch.equal(got, bottleneck_int8.bottleneck_int8_reference(
        *args)[0])

    lib = _build.load_library()
    out = torch.empty_like(xv)
    err = lib.md_bottleneck_int8(
        xv.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(), 0.021,
        w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), 0.033, 0.007, 0.04, 1,
        out.data_ptr(), 2, 9, 11, c, bottleneck_int8.INST_VEC16,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    torch.cuda.synchronize()
    big = torch.zeros((1, 4, 4, 900), dtype=torch.int8, device=cuda_device)
    wb1 = torch.zeros((900, 1, 1, 900), dtype=torch.int8,
                      device=cuda_device)
    wb2 = torch.zeros((900, 3, 3, 900), dtype=torch.int8,
                      device=cuda_device)
    sb = torch.ones(900, device=cuda_device)
    with pytest.raises(ValueError, match='does not fit'):
        bottleneck_int8.bottleneck_int8(big, wb1, sb, sb, 0.1, wb2, sb, sb,
                                        0.1, 0.1, True)


def test_int8_kernels_reject_bad_inputs(cuda_device):
    x = torch.zeros((1, 8, 8, 6), dtype=torch.int8, device=cuda_device)
    w = torch.zeros((8, 3, 3, 6), dtype=torch.int8, device=cuda_device)
    s = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError, match='multiple of 4'):
        conv_int8.conv_int8(x, w, s, s, (1, 1), (1, 1, 1, 1), 0.1)
    with pytest.raises(ValueError):
        conv_int8.conv_int8(x[..., :4], w[..., :4], s, s, (1, 1),
                            (1, 1, 1, 1), 0.1)
    x4 = torch.zeros((1, 8, 8, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        bottleneck_int8.bottleneck_int8(
            x4, w[:, :1, :1, :], s, s, 0.1, w, s, s, 0.1, 0.1, True)


def test_int8_detector_on_card_matches_cpu(cuda_device, tmp_path):
    """The int8 yolov5s6 on the card: both conv backends give identical
    detections and launch their kernels, the bottleneck kernel exactly
    once per bottleneck that routing fuses and the conv kernel for every
    other chain conv; the forward agrees with the
    CPU's within the int8-vs-float bounds of the JAX package's
    test_int8_chain_close_to_float (the float l0 sums in another order on
    the card, which can move an l1 input across a rounding boundary)."""

    config = yolov5.YoloV5Config('yolov5s6', num_classes=3)
    f_path = str(tmp_path / 'float.npz')
    save_checkpoint(yolov5.init_params(config, seed=0), f_path, {
        'arch': 'yolov5s6', 'model_type': 'yolov5', 'num_classes': 3,
        'image_size': 256})
    q_path = str(tmp_path / 'int8.npz')
    quantize_checkpoint(f_path, q_path, calibration_image_size=256,
                        device='cpu')
    imgs = data.images()
    results = {}
    for backend in ('xla', 'pallas'):
        detector = run_detector.load_detector(
            q_path, device='cuda', detector_options={'conv_backend': backend})
        modules = list(detector.model.modules())
        n_qconv = sum(isinstance(m, yolov5.QConv) for m in modules)
        shapes = []
        hooks = [m.register_forward_pre_hook(
            lambda _, inputs: shapes.append(tuple(inputs[0].q.shape)))
            for m in modules if isinstance(m, yolov5.Bottleneck)]
        conv_before = conv_int8.launches
        fused_before = bottleneck_int8.launches
        results[backend] = detector.generate_detections_one_batch(
            imgs, ['im{}'.format(i) for i in range(len(imgs))],
            detection_threshold=0.005)
        for hook in hooks:
            hook.remove()
        # routing: a bottleneck runs fused where bottleneck_tiling takes
        # its shape, else as two conv launches
        forwards = len(shapes) // sum(isinstance(m, yolov5.Bottleneck)
                                      for m in modules)
        fused = 0
        if backend == 'pallas':
            fused = sum(bottleneck_int8.bottleneck_tiling(*shape) is not None
                        for shape in shapes)
            assert 0 < fused < len(shapes)
        assert bottleneck_int8.launches - fused_before == fused
        assert conv_int8.launches - conv_before == \
            n_qconv * forwards - 2 * fused
    assert results['xla'] == results['pallas']
    assert sum(len(r['detections']) for r in results['xla']) > 0

    x = torch.from_numpy(np.random.RandomState(2).rand(
        2, 256, 256, 3).astype(np.float32))
    cpu = run_detector.load_detector(q_path, device='cpu')
    with torch.inference_mode():
        ref = cpu.model(x, decode=True).numpy()
        got = detector.model(x.to(cuda_device), decode=True).cpu().numpy()
    assert np.isfinite(got).all() and got.shape == ref.shape
    d_score = np.abs(got[..., 4:5] * got[..., 5:] - ref[..., 4:5] *
                     ref[..., 5:])
    assert np.percentile(d_score, 99) < 0.02
    assert np.percentile(np.abs(got[..., :2] - ref[..., :2]), 99) < 2.0


@pytest.mark.parametrize('b,h,w,c', [(2, 64, 96, 64), (1, 70, 134, 16),
                                     (1, 32, 66, 32), (2, 18, 200, 80),
                                     (1, 8, 10, 256), (8, 96, 128, 64)])
def test_l0_fused_kernel_identical_to_plain(cuda_device, b, h, w, c):
    """The tensor cores sum the taps in another order than the plain
    version: within l0_fused.plain_bar (1 bf16 ulp or 1e-5, on at most
    1e-3 of the elements)."""

    rng = np.random.RandomState(c + h)
    images = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3),
                                          dtype=np.uint8))
    wt, bias = l0_fused.prepare_l0_weights({
        'w': rng.standard_normal((6, 6, 3, c)).astype(np.float32) * 0.2,
        'b': rng.uniform(-1, 1, c).astype(np.float32)})
    dev = [t.to(cuda_device) for t in (images, wt, bias)]
    before = l0_fused.launches
    got = l0_fused.l0_fused(*dev)
    torch.cuda.synchronize()
    assert l0_fused.launches == before + 1
    ref = l0_fused.l0_fused_reference(*dev)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h // 2, w // 2,
                                                         c)
    differ, max_abs, outside = l0_fused.plain_bar(got, ref)
    print('stem C={} [{},{},{}]: {} of {} elements differ, max |d| {:.3e}'
          .format(c, b, h, w, differ, got.numel(), max_abs))
    assert outside == 0
    assert differ <= l0_fused.DIFF_SHARE * got.numel()
    cpu = l0_fused.l0_fused_reference(images, wt, bias)
    diff = (got.cpu().float() - cpu.float()).abs()
    assert float(diff.max()) <= 2 ** -6 * max(1.0, float(cpu.float().abs()
                                                         .max()))


def test_silu_bf16_kernel_identical_to_plain(cuda_device):
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).to(cuda_device)
    cases = [(x, None), (x[:65535], None)]      # vector and scalar paths
    rng = np.random.RandomState(5)
    for shape in ((2, 24, 5, 7), (1, 16, 8, 8)):
        t = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 4).to(torch.bfloat16).to(cuda_device)
        bias = torch.from_numpy(rng.uniform(-2, 2, shape[1]).astype(
            np.float32)).to(torch.bfloat16).to(cuda_device)
        cases += [(t, bias),
                  (t.contiguous(memory_format=torch.channels_last), bias)]
    for t, bias in cases:
        before = silu_bf16.launches
        got = silu_bf16.silu_bf16(t, bias)
        torch.cuda.synchronize()
        assert silu_bf16.launches == before + 1
        assert got.stride() == t.stride()
        ref = silu_bf16.silu_bf16_reference(t, bias)
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    y = cases[-1][0].clone(memory_format=torch.channels_last)
    want = silu_bf16.silu_bf16_reference(y, cases[-1][1])
    assert silu_bf16.silu_bf16(y, cases[-1][1], out=y) is y
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))
    with pytest.raises(ValueError):
        silu_bf16.silu_bf16(x.float())
    with pytest.raises(ValueError):
        silu_bf16.silu_bf16(cases[2][0][:, :, ::2], cases[2][1])


def test_bf16_detector_on_card_matches_cpu(cuda_device, tmp_path):
    """The bf16 yolov5n on the card: the stem runs once per batch and the
    bf16 epilogue once per activated conv after l0; the decoded forward
    agrees with the CPU's within the bounds the int8 test uses (cuDNN
    sums in another order, and one bf16 ulp moves through the layers)."""

    imgs = data.images()
    model = str(tmp_path / 'm.npz')
    save_checkpoint(data.sharpened_params(imgs), model, data.METADATA)
    options = {'dtype': 'bfloat16'}
    detector = run_detector.load_detector(model, device='cuda',
                                          detector_options=options)
    n_act = sum(1 for m in detector.model.modules()
                if type(m) is yolov5.Conv and m.act) - 1
    stem_before, silu_before = l0_fused.launches, silu_bf16.launches
    detector.programs_run = 0
    results = detector.generate_detections_one_batch(
        imgs, ['im{}'.format(i) for i in range(len(imgs))],
        detection_threshold=0.005)
    batches = detector.programs_run
    assert batches == 2
    assert l0_fused.launches - stem_before == batches
    assert silu_bf16.launches - silu_before == n_act * batches
    assert sum(len(r['detections']) for r in results) > 0

    x = torch.from_numpy(np.stack([im[:192, :256] for im in imgs[:4]]))
    cpu = run_detector.load_detector(model, device='cpu',
                                     detector_options=options)
    with torch.inference_mode():
        ref = cpu.model(x, decode=True).numpy()
        got = detector.model(x.to(cuda_device), decode=True).cpu().numpy()
    assert np.isfinite(got).all() and got.shape == ref.shape
    d_score = np.abs(got[..., 4:5] * got[..., 5:] - ref[..., 4:5] *
                     ref[..., 5:])
    assert np.percentile(d_score, 99) < 0.02
    assert np.percentile(np.abs(got[..., :2] - ref[..., :2]), 99) < 2.0


@pytest.mark.parametrize('epilogue', sorted(conv_int8.EXP_EPILOGUES))
@pytest.mark.parametrize('b,h,w,cin,cout,in_ratio', [
    (2, 24, 40, 128, 128, 0.8531),
    (1, 13, 21, 36, 72, 1.0),      # H, W, Cout off the tiles
    (1, 9, 30, 516, 200, 0.8531),  # Cin off the 64-byte stage
    (1, 5, 7, 4, 8, 1.25),
    (3, 15, 20, 64, 40, 0.8531),   # 16-byte copies, 64-byte stages
    (1, 12, 17, 768, 1024, 1.0),   # Cout 1024, 128-byte stages
    (2, 48, 96, 128, 256, 0.8531),  # BM 128 (two warpgroups)
])
def test_exp_conv_kernel_identical_to_plain(cuda_device, b, h, w, cin, cout,
                                            in_ratio, epilogue):
    """The experiments' conv (E1-E4) at ragged shapes, every epilogue,
    with and without the input requant: identical to the plain version on
    the card; within the f32 bar of the CPU's (its sigmoid and exp differ
    by an ulp from the card's), identical where the epilogue has no
    float32 sigmoid."""

    rng = np.random.RandomState(cin + cout + h)
    x = _int8(rng, (b, h, w, cin))
    wq = _int8(rng, (cout, 3, 3, cin))
    scale = torch.from_numpy(rng.uniform(1e-6, 4e-6, cout).astype(
        np.float32))
    bias = torch.from_numpy(rng.uniform(-0.5, 0.5, cout).astype(np.float32))
    dev = [t.to(cuda_device) for t in (x, wq, scale, bias)]
    before = conv_int8.exp_launches
    got = conv_int8.conv3x3_int8_exp(*dev, in_ratio, 0.043, epilogue)
    torch.cuda.synchronize()
    assert conv_int8.exp_launches == before + 1
    assert got.dtype == torch.int8 and tuple(got.shape) == (b, h, w, cout)
    ref_card = conv_int8.conv3x3_int8_exp_reference(*dev, in_ratio, 0.043,
                                                    epilogue)
    assert torch.equal(got, ref_card)
    ref = conv_int8.conv3x3_int8_exp_reference(x, wq, scale, bias, in_ratio,
                                               0.043, epilogue)
    diff = (got.cpu().int() - ref.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3


def test_exp_conv_template_keeps_the_chain_conv(cuda_device):
    """At in_ratio 1 with the f32 epilogue, the experiments' conv and the
    chain conv (B2) share the int32 sums; their int8 outputs differ only
    where B2's division by y_scale and the multiply by f32(1 / y_scale)
    round apart."""

    rng = np.random.RandomState(4)
    x = _int8(rng, (2, 16, 24, 64)).to(cuda_device)
    wq, scale, bias = [t.to(cuda_device) for t in _conv_case(rng, 64, 64, 3)]
    chain = conv_int8.conv_int8(x, wq, scale, bias, (1, 1), (1, 1, 1, 1),
                                0.043)
    exp = conv_int8.conv3x3_int8_exp(x, wq, scale, bias, 1.0, 0.043, 'f32')
    diff = (chain.int() - exp.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3


@pytest.mark.parametrize('requant', [None, 3e-4])
@pytest.mark.parametrize('m,k,n', [(512, 1152, 512), (1000, 300, 72),
                                   (37, 45, 29), (65, 130, 66), (1, 4, 4),
                                   (4097, 2304, 256), (300, 1000, 200),
                                   (129, 16, 257), (2000, 4096, 129),
                                   (17000, 160, 700), (5, 0, 7)])
def test_gemm_kernel_identical_to_plain(cuda_device, m, k, n, requant):
    """gemm_int8 (E5, E6) at the check shapes and off every tile (M, N, K
    not multiples of the tile; K % 16 != 0 and K = 0 take the pad
    pre-pass; M < 64 and N below the tile's width; N % 4 != 0 takes the
    element stores; 17000x160x700 has more tiles than the persistent grid
    has blocks): identical to the plain version on the card and to numpy's
    int64 product."""

    rng = np.random.RandomState(m + k + n)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    before = gemm_int8.launches
    got = gemm_int8.gemm_int8(a.to(cuda_device), b.to(cuda_device), requant)
    torch.cuda.synchronize()
    assert gemm_int8.launches == before + 1
    ref_card = gemm_int8.gemm_int8_reference(a.to(cuda_device),
                                             b.to(cuda_device), requant)
    assert got.dtype == ref_card.dtype and torch.equal(got, ref_card)
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    if requant is None:
        assert np.array_equal(got.cpu().numpy(), want)
    else:
        assert torch.equal(got.cpu(), gemm_int8.gemm_int8_reference(
            a, b, requant))


@pytest.mark.parametrize('requant', [None, 3e-4])
def test_gemm_kernel_misaligned_view(cuda_device, requant):
    """a at a storage offset that is not 16-byte aligned (TMA cannot read
    it in place: the pad pre-pass copies it): identical to the plain
    version."""

    rng = np.random.RandomState(5)
    m, k, n = 333, 512, 384
    flat = _int8(rng, (m * k + 1,)).to(cuda_device)
    a = flat[1:].view(m, k)
    b = _int8(rng, (k, n)).to(cuda_device)
    assert a.is_contiguous() and a.data_ptr() % 16
    assert gemm_int8.gemm_tiling(m, k, n, aligned=False).pad_a
    before = gemm_int8.launches
    got = gemm_int8.gemm_int8(a, b, requant)
    torch.cuda.synchronize()
    assert gemm_int8.launches == before + 1
    assert torch.equal(got, gemm_int8.gemm_int8_reference(a, b, requant))


def test_exp_kernels_reject_bad_inputs(cuda_device):
    x = torch.zeros((1, 8, 8, 8), dtype=torch.int8, device=cuda_device)
    s = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError, match='3x3'):
        conv_int8.conv3x3_int8_exp(
            x, torch.zeros((8, 1, 1, 8), dtype=torch.int8,
                           device=cuda_device), s, s, 1.0, 0.1)
    a = torch.zeros((8, 16), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        gemm_int8.gemm_int8(a, a)
    with pytest.raises(ValueError):
        gemm_int8.gemm_int8(a.float(), a.t().float())
    with pytest.raises(ValueError):
        gemm_int8.gemm_int8(a, a.t())



#%% The program cache: CUDA graphs replayed against the eager programs


_PRECISIONS = {'float32': {}, 'int8-xla': {'conv_backend': 'xla'},
               'int8-pallas': {'conv_backend': 'pallas'},
               'bf16': {'dtype': 'bfloat16'}}


@pytest.fixture(scope='module')
def graph_models(tmp_path_factory):
    """{arch: (float .npz, int8 .npz)}: random yolov5n and yolov5s6 at 320
    px, the int8 one quantized by the port on the card."""

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    folder = tmp_path_factory.mktemp('graphs')
    calib = np.random.RandomState(1).uniform(
        0, 1, (2, 320, 320, 3)).astype(np.float32)
    paths = {}
    for arch in ('yolov5n', 'yolov5s6'):
        config = yolov5.YoloV5Config(arch, num_classes=3)
        f_path = str(folder / '{}.npz'.format(arch))
        save_checkpoint(yolov5.init_params(config, seed=0), f_path, {
            'arch': arch, 'model_type': 'yolov5', 'num_classes': 3,
            'image_size': 320, 'anchors': config.anchors.tolist()})
        q_path = str(folder / '{}_int8.npz'.format(arch))
        quantize_checkpoint(f_path, q_path, calibration_images=calib,
                            device='cuda')
        paths[arch] = (f_path, q_path)
    return paths


def _graph_detector(graph_models, arch, precision, **options):
    f_path, q_path = graph_models[arch]
    path = q_path if precision.startswith('int8') else f_path
    return run_detector.load_detector(path, device='cuda', detector_options=dict(
        _PRECISIONS[precision], **options))


def _canvas_batch(seed, h=320, w=320, b=2):
    return np.random.RandomState(seed).randint(0, 256, (b, h, w, 3),
                                               dtype=np.uint8)


def _counted_run(detector, batch, conf=0.005, iou=0.45, augment=False):
    from megadetector_tpu_torch.models import program_cache

    before = program_cache.read_counters()
    out, topk = detector.run_program(batch, conf, iou, augment=augment)
    torch.cuda.synchronize()
    after = program_cache.read_counters()
    return out, topk, [a - b for a, b in zip(after, before)]


def _assert_identical(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize('precision', sorted(_PRECISIONS))
@pytest.mark.parametrize('arch', ['yolov5n', 'yolov5s6'])
def test_replay_identical_to_eager(cuda_device, graph_models, arch,
                                   precision):
    """The eager program, then the graphs: the first graph call captures
    and replays, the later ones replay; every output identical to the
    eager program's, every call counting the eager launches."""

    detector = _graph_detector(graph_models, arch, precision)
    batch = _canvas_batch(0)
    detector._cuda_graphs = False
    eager, topk, launches = _counted_run(detector, batch)
    assert sum(launches) > 0
    detector._cuda_graphs = True
    for call in range(3):
        out, t, got = _counted_run(detector, batch)
        assert t == topk
        _assert_identical(out, eager)
        assert got == launches, (call, got, launches)
    assert detector._programs.captures >= 2
    assert detector._programs.replays >= 6


def test_escalation_to_the_ceiling_under_replay(cuda_device, graph_models):
    """Random yolov5n puts every anchor of a 320 px canvas above the
    floor: 512 escalates to the 8192 ceiling; both capacities' selection
    + NMS graphs replay on the forward's static heads."""

    detector = _graph_detector(graph_models, 'yolov5n', 'float32')
    batch = _canvas_batch(1)
    detector._cuda_graphs = False
    eager, topk, launches = _counted_run(detector, batch)
    assert topk == 8192 and int(eager['n_candidates'].max()) > 4096
    # Two NMS launches a call: at 512, then at 8192
    assert launches[0] == 2
    detector._cuda_graphs = True
    for _ in range(3):
        detector.host_reads = 0
        out, t, got = _counted_run(detector, batch)
        assert t == 8192 and got == launches
        assert detector.host_reads == 2
        _assert_identical(out, eager)
    selects = [k for k, e in detector._programs.entries.items()
               if 'select' in k and e.graph is not None]
    assert sorted(k[-3] for k in selects) == [512, 8192]


def test_replay_order_across_two_canvases(cuda_device, graph_models):
    """c1, c2, c1, ...: graphs of two canvases share the detector's pool;
    no replay corrupts another canvas's static outputs."""

    detector = _graph_detector(graph_models, 'yolov5s6', 'bf16')
    c1, c2 = _canvas_batch(2), _canvas_batch(3, h=256)
    detector._cuda_graphs = False
    want = {1: _counted_run(detector, c1), 2: _counted_run(detector, c2)}
    detector._cuda_graphs = True
    outs = []
    for canvas in (1, 2, 1, 2, 2, 1):
        out, topk, launches = _counted_run(detector, c1 if canvas == 1
                                           else c2)
        outs.append((canvas, out))
        assert topk == want[canvas][1] and launches == want[canvas][2]
    for canvas, out in outs:
        _assert_identical(out, want[canvas][0])
    pools = {id(detector._programs.capturer.pool)}
    assert len(pools) == 1 and detector._programs.captures >= 4


def test_threshold_change_captures_a_new_graph(cuda_device, graph_models):
    detector = _graph_detector(graph_models, 'yolov5n', 'int8-pallas',
                               auto_escalate_topk='false')
    batch = _canvas_batch(4)
    eager = run_detector.load_detector(graph_models['yolov5n'][1],
                                       device='cuda', detector_options={
                                           'conv_backend': 'pallas',
                                           'auto_escalate_topk': 'false'})
    eager._cuda_graphs = False
    for conf in (0.005, 0.005, 0.2, 0.2, 0.2):
        captures = detector._programs.captures
        out, _, _ = _counted_run(detector, batch, conf=conf)
        _assert_identical(out, _counted_run(eager, batch, conf=conf)[0])
        key = ('forward', 2, 320, 320, True, 'select', 512, conf, 0.45)
        entry = detector._programs.entries[key]
        if entry.calls == 2:
            assert detector._programs.captures > captures
        assert (entry.graph is not None) == (entry.calls >= 2)


@pytest.mark.parametrize('precision', ['float32', 'int8-pallas', 'bf16'])
def test_tta_replay_identical_to_eager(cuda_device, graph_models, precision):
    detector = _graph_detector(graph_models, 'yolov5s6', precision,
                               pre_nms_topk='1024')
    batch = _canvas_batch(5)
    detector._cuda_graphs = False
    eager, topk, launches = _counted_run(detector, batch, augment=True)
    assert topk == 1024 and 'n_candidates' not in eager
    # One NMS launch a call, on the merged candidates
    assert launches[0] == 1
    detector._cuda_graphs = True
    for _ in range(3):
        out, _, got = _counted_run(detector, batch, augment=True)
        assert got == launches
        _assert_identical(out, eager)
    assert [k for k in detector._programs.entries
            if k[0] == 'augment'] == [('augment', 2, 320, 320, True, 0.005,
                                       0.45)]


def test_deleting_the_detector_frees_its_graphs(cuda_device, graph_models):
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    detector = _graph_detector(graph_models, 'yolov5s6', 'float32')
    batch = _canvas_batch(6)
    for _ in range(3):
        detector.run_program(batch, 0.005, 0.45)
    assert detector._programs.captures >= 2
    held = torch.cuda.memory_reserved()
    assert held > base
    del detector
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= base + (held - base) // 10


#%% The single-image, tiled and video entry points on the card


@pytest.fixture
def entry_point_inputs(tmp_path):
    """(model, image folder, video folder): the sharpened yolov5n, a
    tile-sized, a larger and a smaller image, and a folder with one short
    video and one corrupt file."""

    import cv2
    from PIL import Image

    imgs = data.images()
    model = str(tmp_path / 'm.npz')
    save_checkpoint(data.sharpened_params(imgs), model, data.METADATA)
    images = tmp_path / 'images'
    images.mkdir()
    Image.fromarray(imgs[0][:128, :128]).save(str(images / 'tile.png'))
    Image.fromarray(imgs[1][:200, :300]).save(str(images / 'big.png'))
    Image.fromarray(imgs[5][:, :120]).save(str(images / 'small.png'))
    videos = tmp_path / 'videos'
    videos.mkdir()
    out = cv2.VideoWriter(str(videos / 'v.mp4'),
                          cv2.VideoWriter_fourcc(*'mp4v'), 8.0, (160, 120))
    base = cv2.resize(imgs[0], (160, 120))
    rng = np.random.RandomState(0)
    for _ in range(10):
        frame = np.clip(base.astype(np.int32) + rng.randint(-24, 24,
                                                            base.shape),
                        0, 255).astype(np.uint8)
        out.write(frame[..., ::-1].copy())
    out.release()
    (videos / 'corrupt.mp4').write_bytes(b'not a video')
    return model, str(images), str(videos)


def _assert_close_json(cpu, card, n_images):
    result = md_tests.compare_results(cpu, card, data.golden_options())
    assert result['n_images_compared'] == n_images
    assert result['errors'] == [], result['errors'][:5]


def test_load_and_run_detector_on_card_matches_cpu(cuda_device,
                                                   entry_point_inputs,
                                                   tmp_path):
    import os

    model, folder, _ = entry_point_inputs
    files = [os.path.join(folder, n) for n in ('big.png', 'small.png')]
    out = {}
    for device in ('cpu', 'cuda'):
        before = cuda_nms.launches
        out[device] = {'images': run_detector.load_and_run_detector(
            model, files, str(tmp_path / device), device=device)}
        torch.cuda.synchronize()
        assert (cuda_nms.launches > before) == (device == 'cuda')
        assert len(os.listdir(str(tmp_path / device))) == 2
    _assert_close_json(out['cpu'], out['cuda'], 2)


def test_tiled_inference_on_card_matches_cpu(cuda_device, entry_point_inputs,
                                             tmp_path):
    from megadetector_tpu_torch.detection import run_tiled_inference

    model, folder, _ = entry_point_inputs
    out = {}
    for device in ('cpu', 'cuda'):
        before = cuda_nms.launches
        out[device] = run_tiled_inference.run_tiled_inference(
            model, folder, None, str(tmp_path / (device + '.json')),
            tile_size_x=128, tile_size_y=128, batch_size=4, image_size=128,
            detector_options={'use_mesh': 'false'}, device=device)
        torch.cuda.synchronize()
        assert (cuda_nms.launches > before) == (device == 'cuda')
    _assert_close_json(out['cpu'], out['cuda'], 3)


def test_process_videos_on_card_matches_cpu(cuda_device, entry_point_inputs,
                                            tmp_path):
    from megadetector_tpu_torch.detection import process_video

    model, _, videos = entry_point_inputs
    out = {}
    for device in ('cpu', 'cuda'):
        options = process_video.ProcessVideoOptions()
        options.model_file = model
        options.input_video_file = videos
        options.output_json_file = str(tmp_path / (device + '.json'))
        options.frame_sample = 3
        options.frame_batch_size = 3
        options.device = device
        before = cuda_nms.launches
        out[device] = process_video.process_videos(options)
        torch.cuda.synchronize()
        assert (cuda_nms.launches > before) == (device == 'cuda')
    frames = []
    for device in ('cpu', 'cuda'):
        by_file = {im['file']: im for im in out[device]['images']}
        assert by_file['corrupt.mp4']['detections'] is None
        assert by_file['v.mp4']['frames_processed'] == [0, 3, 6, 9]
        frames.append({'images': [
            {'file': str(n), 'detections': [
                d for d in by_file['v.mp4']['detections']
                if d['frame_number'] == n]} for n in (0, 3, 6, 9)]})
    _assert_close_json(frames[0], frames[1], 4)


#%% The species classifier (EfficientNetV2)


@pytest.mark.parametrize('b,h,cin,cout,k,s', [
    (4, 30, 960, 176, 1, 1), (2, 15, 1824, 304, 1, 1),
    (3, 60, 320, 80, 1, 1), (2, 48, 24, 96, 3, 2), (2, 24, 48, 192, 3, 1)])
@pytest.mark.parametrize('act', [True, False])
def test_chain_conv_with_and_without_silu_identical_to_plain(
        cuda_device, b, h, cin, cout, k, s, act):
    """The int8 conv kernel's chain epilogues at EfficientNetV2 shapes:
    Cout off the tile's multiples (176, 304, 80), Cin = 24 on the 4-byte
    copies; without SiLU (kChainLinear) as the plain act=False."""

    rng = np.random.RandomState(cin + cout)
    x = torch.from_numpy(rng.randint(-127, 128, (b, h, h, cin)).astype(
        np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (cout, k, k, cin)).astype(
        np.int8))
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, cout) / (
        np.sqrt(cin * k * k) * 127.0 * 127.0 / 3.0)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-0.5, 0.5, cout).astype(np.float32))
    pads = (k // 2,) * 4
    ref = conv_int8.conv_int8_reference(x, w, scale, bias, (s, s), pads,
                                        4.0 / 127, act)
    before = conv_int8.launches
    got = conv_int8.conv_int8(x.to(cuda_device), w.to(cuda_device),
                              scale.to(cuda_device), bias.to(cuda_device),
                              (s, s), pads, 4.0 / 127, act=act)
    torch.cuda.synchronize()
    assert conv_int8.launches == before + 1
    assert torch.equal(got.cpu(), ref)
    assert len(torch.unique(ref)) > 100


def _classifier_checkpoint(tmp_path, quantize=False):
    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.ops import quantization

    config = efficientnet.EfficientNetConfig('efficientnetv2_s', 6)
    params = efficientnet.init_params(config, seed=0)

    def scaled(node):
        return {k: scaled(v) if isinstance(v, dict) else
                (v * np.float32(0.8) if v.ndim == 4 else v)
                for k, v in node.items()}
    params = scaled(params)
    params['fc']['w'] = params['fc']['w'] * np.float32(64.0)
    if quantize:
        params = efficientnet.quantize_params_chain(params, config)
        x = np.random.RandomState(1).randint(0, 256, (4, 96, 96, 3)) / 255.0
        quantization.calibrate_chain_scales(config, params, x,
                                            device='cpu')
    path = str(tmp_path / 'classifier.npz')
    save_checkpoint(params, path, {'arch': 'efficientnetv2_s',
                                   'num_classes': 6, 'image_size': 96})
    return path


@pytest.mark.parametrize('precision', ['float32', 'bf16', 'int8'])
def test_classifier_on_card_matches_cpu(cuda_device, tmp_path, precision):
    """SpeciesClassifier (efficientnetv2_s at 96 px) on the card: eager,
    then replayed, identical; launches per forward as forward_launches
    counts them; the card against the CPU: float32 within rtol 1e-4,
    bf16 no further than the CPU's bf16 from its float32, int8 (the same
    calibrated checkpoint) within the CPU's int8-vs-float32 error."""

    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.models.classifier import SpeciesClassifier

    options = {'float32': {}, 'bf16': {'dtype': 'bfloat16'},
               'int8': {'quantize': 'int8'}}[precision]
    path = _classifier_checkpoint(tmp_path, precision == 'int8')
    crops = list(np.random.RandomState(2).randint(0, 256, (4, 96, 96, 3),
                                                  dtype=np.uint8))
    card = SpeciesClassifier(path, options, device=cuda_device)
    want = efficientnet.forward_launches(card.config, precision == 'int8',
                                         card.compute_dtype)
    out = []
    for _ in range(3):
        before = (conv_int8.launches, silu_bf16.launches)
        out.append(card.classify_batch(crops))
        torch.cuda.synchronize()
        assert (conv_int8.launches - before[0],
                silu_bf16.launches - before[1]) == want
    assert card._programs.replays == 2
    assert np.array_equal(out[0], out[1]) and np.array_equal(out[1], out[2])
    cpu = SpeciesClassifier(path, options, device='cpu').classify_batch(
        crops)
    if precision == 'float32':
        np.testing.assert_allclose(out[0], cpu, rtol=1e-4, atol=1e-6)
    else:
        f32 = SpeciesClassifier(path, device='cpu').classify_batch(crops)
        assert np.abs(out[0] - cpu).max() <= np.abs(cpu - f32).max()


def test_classifier_two_batches_in_flight_on_card(cuda_device, tmp_path):
    """dispatch 1, dispatch 2, fetch 1, fetch 2 on the card (batch 2's
    replay rewrites the graph's static output before batch 1 is fetched)
    equals serial calls."""

    from megadetector_tpu_torch.models.classifier import SpeciesClassifier

    clf = SpeciesClassifier(_classifier_checkpoint(tmp_path),
                            device=cuda_device)
    rng = np.random.RandomState(3)
    a = list(rng.randint(0, 256, (4, 96, 96, 3), dtype=np.uint8))
    b = list(rng.randint(0, 256, (4, 96, 96, 3), dtype=np.uint8))
    serial_a, serial_b = clf.classify_batch(a), clf.classify_batch(b)
    h1 = clf.classify_batch_async(a)
    h2 = clf.classify_batch_async(b)
    np.testing.assert_array_equal(clf.fetch_batch(h1), serial_a)
    np.testing.assert_array_equal(clf.fetch_batch(h2), serial_b)
    assert clf._programs.replays >= 3
    assert not np.array_equal(serial_a, serial_b)


#%% E7's backward and the training steps


def _bf16_step(v):
    """The spacing of bf16 values at |v| (2^-133 at least)."""

    e = torch.floor(torch.log2(torch.clamp(v.abs().float(), min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


@pytest.mark.parametrize('shape,layout', [
    ((8, 128, 60, 80), 'channels_last'),
    ((4, 96, 17, 23), 'nchw'),
    ((64, 1536, 1, 1), 'se')])
def test_silu_backward_kernel_identical_to_plain(cuda_device, shape, layout):
    """E7's backward kernel against silu_bf16_backward_reference on the
    card: dx bit-identical, db within one bf16 step of the plain version's
    (float32 partial sums in another order, rounded once); one launch."""

    gen = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen) * 3).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen).to(torch.bfloat16)
    bias = (torch.rand(shape[1], generator=gen) * 2 - 1).to(torch.bfloat16)
    if layout == 'channels_last':
        x = x.contiguous(memory_format=torch.channels_last)
        g = g.contiguous(memory_format=torch.channels_last)
    x, g, bias = x.to(cuda_device), g.to(cuda_device), bias.to(cuda_device)
    before = silu_bf16.backward_launches
    dx, db = silu_bf16.silu_bf16_backward(g, x, bias)
    torch.cuda.synchronize()
    assert silu_bf16.backward_launches == before + 1
    assert dx.stride() == x.stride()
    ref_dx, ref_db = silu_bf16.silu_bf16_backward_reference(g, x, bias)
    assert torch.equal(dx.view(torch.int16), ref_dx.view(torch.int16))
    assert bool(((db.float() - ref_db.float()).abs() <=
                 _bf16_step(ref_db)).all())
    # without a bias: dx only
    dx, db = silu_bf16.silu_bf16_backward(g, x)
    assert db is None
    ref_nobias = silu_bf16.silu_bf16_backward_reference(g, x)[0]
    assert torch.equal(dx.view(torch.int16), ref_nobias.view(torch.int16))
    # autograd: silu_bf16 on a tensor that requires grad runs the kernel
    xg = x.clone().requires_grad_(True)
    before = silu_bf16.backward_launches
    silu_bf16.silu_bf16(xg, bias).backward(g)
    torch.cuda.synchronize()
    assert silu_bf16.backward_launches == before + 1
    assert torch.equal(xg.grad.view(torch.int16), ref_dx.view(torch.int16))


def _grads_l2(model_a, model_b, ref):
    """(|a - ref|, |b - ref|) over every parameter's gradient (L2)."""

    da = db = 0.0
    for pa, pb, pr in zip(model_a.parameters(), model_b.parameters(),
                          ref.parameters()):
        r = pr.grad.double().cpu()
        da += float(((pa.grad.double().cpu() - r) ** 2).sum())
        db += float(((pb.grad.double().cpu() - r) ** 2).sum())
    return da ** 0.5, db ** 0.5


def test_bf16_detector_step_on_card_matches_cpu(cuda_device):
    """One bf16 loss and backward of yolov5n (nc 3) at 128 px, batch 2, on
    the card and on the CPU: E7 forward and backward once per activated
    conv on the card; the loss within the CPU's own bf16 error of the
    CPU's, and the card's gradients no further from the CPU's float32
    ones than the CPU's bf16 gradients are, times 1.5 (L2 over all)."""

    from megadetector_tpu_torch.training import train_detector as td

    config = yolov5.YoloV5Config('yolov5n', num_classes=3)
    params = yolov5.init_params(config, seed=0)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randint(0, 256, (2, 128, 128, 3)).astype(
        np.float32) / 255.0)
    targets = td.pad_targets(
        [np.array([[0.5, 0.5, 0.3, 0.25], [0.62, 0.41, 0.2, 0.3]]),
         np.array([[0.31, 0.52, 0.6, 0.5]])],
        [np.array([0, 1]), np.array([2])], max_targets=4)

    def run(device, dtype):
        model = yolov5.YoloV5(config).load_params(params).to(device)
        model.set_training(dtype)
        t = [torch.from_numpy(a).to(device) for a in targets]
        loss, _ = td.detection_loss(config, model, x.to(device), t[0],
                                    t[1].long(), t[2], dtype)
        loss.backward()
        return float(loss.detach()), model

    n_act = sum(1 for m in yolov5.YoloV5(config).modules()
                if type(m) is yolov5.Conv and m.act)
    before = (silu_bf16.launches, silu_bf16.backward_launches)
    card_loss, card = run(cuda_device, torch.bfloat16)
    torch.cuda.synchronize()
    assert (silu_bf16.launches - before[0],
            silu_bf16.backward_launches - before[1]) == (n_act, n_act)
    cpu_loss, cpu = run('cpu', torch.bfloat16)
    ref_loss, ref = run('cpu', torch.float32)
    assert abs(card_loss - cpu_loss) <= max(abs(cpu_loss - ref_loss),
                                            1e-3 * abs(ref_loss))
    d_card, d_cpu = _grads_l2(card, cpu, ref)
    assert d_card <= 1.5 * d_cpu, (d_card, d_cpu)


@pytest.mark.parametrize('precision', ['float32', 'bf16'])
def test_classifier_step_on_card_matches_cpu(cuda_device, precision):
    """One train step of efficientnetv2_test (32 px, batch 6) on the card
    and on the CPU from the same weights: float32 loss within rtol 1e-5
    and parameters after the step within rtol 1e-4 (atol 1e-4 * max);
    bf16 E7 forward and backward launches as forward_launches counts them,
    the loss within the CPU's own bf16 error."""

    from megadetector_tpu_torch.models import efficientnet
    from megadetector_tpu_torch.training import optim
    from megadetector_tpu_torch.training import train_classifier as tc

    dtype = torch.bfloat16 if precision == 'bf16' else torch.float32
    config = efficientnet.EfficientNetConfig('efficientnetv2_test', 4, 32)
    params = efficientnet.init_params(config, seed=0)
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, 6).astype(np.int32)

    def step(device, dt):
        model = tc.make_classifier(config, params, device, dt)
        opt = optim.Optimizer(model.parameters(), optim.chain(
            optim.clip_by_global_norm(1.0), optim.adamw(1e-3)))
        m = tc.make_train_step(config, model, opt, 0.1, dt)(images, labels)
        return float(m['loss']), model.export_params()

    before = (silu_bf16.launches, silu_bf16.backward_launches)
    card_loss, card = step(cuda_device, dtype)
    torch.cuda.synchronize()
    n = efficientnet.forward_launches(config, False, dtype)[1]
    assert (silu_bf16.launches - before[0],
            silu_bf16.backward_launches - before[1]) == (n, n)
    cpu_loss, cpu = step('cpu', dtype)
    if precision == 'float32':
        assert card_loss == pytest.approx(cpu_loss, rel=1e-5)

        def walk(a, b):
            for k in a:
                if isinstance(a[k], dict):
                    walk(a[k], b[k])
                else:
                    np.testing.assert_allclose(
                        a[k], b[k], rtol=1e-4,
                        atol=1e-4 * np.abs(b[k]).max())
        walk(card, cpu)
    else:
        ref_loss, _ = step('cpu', torch.float32)
        assert abs(card_loss - cpu_loss) <= max(abs(cpu_loss - ref_loss),
                                                1e-3 * abs(ref_loss))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_static_int8_detector_on_card_matches_cpu(cuda_device, tmp_path,
                                                  dtype):
    """An int8 static-scale yolov5s6 (quantize_checkpoint mode='static',
    calibrated on the CPU) on the card in [dtype]: under both conv
    backends the conv kernel launches once per int8 conv a forward (int32
    mode; static convs never fuse), in bf16 the stem once a forward and
    the bias + SiLU epilogue once per activated float conv after l0, and
    nothing else of ours but NMS; the replayed program gives the eager
    one's detections; the forward agrees with the CPU's in the same dtype
    within the int8 bounds of the test above."""

    config = yolov5.YoloV5Config('yolov5s6', num_classes=3)
    f_path = str(tmp_path / 'float.npz')
    save_checkpoint(yolov5.init_params(config, seed=0), f_path, {
        'arch': 'yolov5s6', 'model_type': 'yolov5', 'num_classes': 3,
        'image_size': 256})
    s_path = str(tmp_path / 'static.npz')
    quantize_checkpoint(f_path, s_path, calibration_image_size=256,
                        mode='static', device='cpu')
    imgs = data.images()
    ids = ['im{}'.format(i) for i in range(len(imgs))]
    results = {}
    for backend in ('xla', 'pallas'):
        detector = run_detector.load_detector(
            s_path, device='cuda', detector_options={'conv_backend': backend,
                                                     'dtype': dtype})
        n_qconv = sum(isinstance(m, yolov5.QConv)
                      for m in detector.model.modules())
        n_activated = sum(type(m) is yolov5.Conv and m.act
                          for m in detector.model.modules())
        assert n_qconv > 20 and n_activated > 10
        bf16 = dtype == 'bfloat16'
        forwards = []
        hook = detector.model.register_forward_pre_hook(
            lambda *_: forwards.append(1))
        before = (conv_int8.launches, bottleneck_int8.launches,
                  l0_fused.launches, silu_bf16.launches)
        eager = detector.generate_detections_one_batch(
            imgs, ids, detection_threshold=0.005)
        torch.cuda.synchronize()
        after = (conv_int8.launches, bottleneck_int8.launches,
                 l0_fused.launches, silu_bf16.launches)
        hook.remove()
        n = len(forwards)
        assert [a - b for a, b in zip(after, before)] == \
            [n_qconv * n, 0, n if bf16 else 0,
             (n_activated - 1) * n if bf16 else 0]
        replayed = detector.generate_detections_one_batch(
            imgs, ids, detection_threshold=0.005)
        assert detector._programs.replays > 0
        assert replayed == eager
        results[backend] = eager
    assert results['xla'] == results['pallas']
    assert sum(len(r['detections']) for r in results['xla']) > 0

    x = torch.from_numpy(np.random.RandomState(2).rand(
        2, 256, 256, 3).astype(np.float32))
    cpu = run_detector.load_detector(s_path, device='cpu',
                                     detector_options={'dtype': dtype})
    with torch.inference_mode():
        ref = cpu.model(x, decode=True).float().numpy()
        got = detector.model(x.to(cuda_device),
                             decode=True).float().cpu().numpy()
    assert np.isfinite(got).all() and got.shape == ref.shape
    d_score = np.abs(got[..., 4:5] * got[..., 5:] - ref[..., 4:5] *
                     ref[..., 5:])
    assert np.percentile(d_score, 99) < 0.02
    assert np.percentile(np.abs(got[..., :2] - ref[..., :2]), 99) < 2.0


def test_accelerator_probe_on_card(cuda_device):
    from megadetector_tpu_torch.utils.accelerator_test import \
        accelerator_test

    before = cuda_nms.launches
    result = accelerator_test(verbose=False)
    assert result['platform'] == 'gpu' and result['error'] is None
    assert result['smoke_test_ok'] and result['n_devices'] >= 1
    assert result['devices'][0] == torch.cuda.get_device_name(0)
    assert cuda_nms.launches == before + 1



#%% The path kernels as custom operators (mdtorch::*)


def _op_cases(rng):
    """{label: (operator, CPU arguments, plain output)} at small
    shapes."""

    def int8(shape):
        return torch.from_numpy(rng.randint(-127, 128, shape)
                                .astype(np.int8))

    def f32(shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32))

    ops = torch.ops.mdtorch
    boxes, valid = (torch.from_numpy(a) for a in _offset_boxes(rng, 4, 700))
    x = int8((2, 30, 40, 64))
    cases = {
        'nms_value': (ops.greedy_nms_keep, (boxes, valid, 0.45)),
        'nms_tensor': (ops.greedy_nms_keep_t,
                       (boxes, valid, torch.tensor(0.45))),
    }
    for label, w, stride, pads, y_scale, act in (
            ('conv_int32', int8((64, 3, 3, 64)), [1, 1], [1, 1, 1, 1], None,
             True),
            ('conv_silu', int8((64, 3, 3, 64)), [1, 1], [1, 1, 1, 1], 0.05,
             True),
            ('conv_linear_s2', int8((128, 3, 3, 64)), [2, 2], [1, 1, 1, 1],
             0.05, False)):
        scale, bias = f32((w.shape[0],), 1e-4).abs(), f32((w.shape[0],), 0.1)
        cases[label] = (ops.conv_int8, (
            x, w, None if y_scale is None else scale,
            None if y_scale is None else bias, stride, pads, y_scale, act))
    for shortcut in (True, False):
        cases['bottleneck_{}'.format(shortcut)] = (ops.bottleneck_int8, (
            x, int8((64, 1, 1, 64)), f32((64,), 1e-4).abs(),
            f32((64,), 0.1), 0.04, int8((64, 3, 3, 64)),
            f32((64,), 1e-4).abs(), f32((64,), 0.1), 0.05, 0.03, shortcut))
    w, b = l0_fused.prepare_l0_weights({'w': rng.randn(6, 6, 3, 32) * 0.1,
                                        'b': rng.randn(32) * 0.1})
    cases['l0_fused'] = (ops.l0_fused, (torch.from_numpy(
        rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)), w, b))
    cases['silu_bf16'] = (ops.silu_bf16, (
        f32((2, 32, 12, 20), 3.0).to(torch.bfloat16),
        f32((32,), 1.0).to(torch.bfloat16)))
    return cases


_PLAIN = {
    'greedy_nms_keep': cuda_nms.greedy_nms_keep_reference,
    'greedy_nms_keep_t': cuda_nms.greedy_nms_keep_reference,
    'conv_int8': conv_int8.conv_int8_reference,
    'bottleneck_int8': lambda *a: bottleneck_int8.bottleneck_int8_reference(
        *a)[0],
    'l0_fused': l0_fused.l0_fused_reference,
    'silu_bf16': silu_bf16.silu_bf16_reference}

_OP_COUNTERS = {'nms': (cuda_nms, 'launches'),
                'conv': (conv_int8, 'launches'),
                'bottleneck': (bottleneck_int8, 'launches'),
                'l0': (l0_fused, 'launches'), 'silu': (silu_bf16,
                                                      'launches')}


@pytest.mark.parametrize('label', [
    'nms_value', 'nms_tensor', 'conv_int32', 'conv_silu', 'conv_linear_s2',
    'bottleneck_True', 'bottleneck_False', 'l0_fused', 'silu_bf16'])
def test_custom_op_on_card_is_its_kernel(cuda_device, label):
    op, args = _op_cases(np.random.RandomState(17))[label]
    module, name = _OP_COUNTERS[label.split('_')[0]]
    args = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a
            for a in args]
    before = getattr(module, name)
    got = op(*args)
    torch.cuda.synchronize()
    assert got.device.type == 'cuda'
    assert getattr(module, name) == before + 1
    # The plain version on the same tensors (plain PyTorch on the card),
    # as the kernels' own tests hold them
    plain = _PLAIN[op.__name__.split('.')[-1]](*args)
    if label == 'l0_fused':
        n_diff, _, outside = l0_fused.plain_bar(got, plain)
        assert outside == 0 and n_diff <= l0_fused.DIFF_SHARE * plain.numel()
    else:
        assert got.dtype == plain.dtype and torch.equal(got, plain)


def test_silu_out_op_on_card(cuda_device):
    _, (x, bias) = _op_cases(np.random.RandomState(18))['silu_bf16']
    x, bias = x.to(cuda_device), bias.to(cuda_device)
    y = x.clone()
    torch.ops.mdtorch.silu_bf16_out(y, bias, y)
    assert torch.equal(y, silu_bf16.silu_bf16_reference(x, bias))


def test_threshold_split_on_card_is_bit_identical(cuda_device):
    rng = np.random.RandomState(19)
    values = [0.0, 1.0, 0.45, 0.5, 0.6, 1e-40, 1.4e-45, -0.45] + list(
        rng.rand(300).astype(np.float32))
    for v in values:
        v = float(np.float32(v))
        m, m_hi, m_lo, tie_up = cuda_nms.threshold_split(v)
        got = cuda_nms.threshold_split_tensor(torch.tensor(
            v, device=cuda_device)).cpu().numpy()
        want = np.array([m, m_hi, m_lo, float(tie_up)])
        assert np.array_equal(got.view(np.int64), want.view(np.int64)), v


def test_nms_device_threshold_entry_in_one_graph(cuda_device):
    """B1's device-memory threshold entry: the keep mask of the by-value
    entry at every threshold, from one captured CUDA graph whose
    threshold tensor is refilled before each replay."""

    boxes, valid = (torch.from_numpy(a).to(cuda_device)
                    for a in _offset_boxes(np.random.RandomState(20), 8,
                                           2048))
    thresh = torch.tensor(0.45, device=cuda_device)
    cuda_nms.greedy_nms_keep(boxes, valid, thresh)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='relaxed'):
        keep = cuda_nms.greedy_nms_keep(boxes, valid, thresh)
    for t in (0.3, 0.45, 0.5, 0.6, 0.85):
        thresh.fill_(t)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(keep, cuda_nms.greedy_nms_keep(boxes, valid, t))


@pytest.mark.parametrize('case', ['bf16', 'int8_pallas'])
def test_exported_artifact_on_card(cuda_device, tmp_path, case):
    """The artifact exported for the card against the live detector, each
    eager then replayed: identical detections, equal launches; and the
    live detector's outputs unchanged by the export."""

    from megadetector_tpu_torch.detection import export_detector as ed
    from megadetector_tpu_torch.models import program_cache

    imgs = data.images()
    model = str(tmp_path / 'md_v5a.0.0_cuda_export.npz')
    save_checkpoint(data.sharpened_params(imgs), model, data.METADATA)
    options = {'dtype': 'bf16'}
    if case == 'int8_pallas':
        q_path = str(tmp_path / 'q.npz')
        quantize_checkpoint(model, q_path,
                            calibration_images=[im[:192, :256]
                                                for im in imgs[:4]],
                            calibration_image_size=256, device='cuda')
        model, options = q_path, {'conv_backend': 'pallas'}
    live = run_detector.load_detector(model, detector_options=options)
    before = live.generate_detections_one_batch(imgs[:4],
                                                detection_threshold=0.005)
    artifact = str(tmp_path / 'x.mdpkg')
    ed.export_detector(model, artifact, batch_sizes=[4], aspects=['4:3'],
                       topk_ladder=[512, 1024], detector_options=options)
    exported = run_detector.load_detector(artifact)
    for threshold in (0.005, 0.005, 0.2, 0.005):
        c0 = program_cache.read_counters()
        want = live.generate_detections_one_batch(
            imgs[:4], detection_threshold=threshold)
        c1 = program_cache.read_counters()
        got = exported.generate_detections_one_batch(
            imgs[:4], detection_threshold=threshold)
        c2 = program_cache.read_counters()
        assert got == want
        assert [b - a for a, b in zip(c1, c2)] == \
            [b - a for a, b in zip(c0, c1)]
    assert live.generate_detections_one_batch(
        imgs[:4], detection_threshold=0.005) == before
    assert exported._programs.replays > 0
    # One selection graph served both thresholds
    assert not any(isinstance(k[-1], float)
                   for k in exported._programs.entries)
