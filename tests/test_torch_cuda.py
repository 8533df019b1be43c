"""
The port on a CUDA card: the greedy-NMS, int8 conv, fused int8
bottleneck, fused stem and bf16 epilogue kernels, and the int8
experiments' conv (every epilogue) and GEMM kernels, against their plain
versions, and the card's selection, NMS and detectors (float32, int8 chain
and bf16) against the CPU's.

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


@pytest.mark.parametrize('b,h,w,cin,cout,k,stride,pads', [
    (2, 16, 16, 128, 128, 3, (1, 1), (1, 1, 1, 1)),
    (1, 13, 21, 36, 72, 3, (1, 1), (1, 1, 1, 1)),
    (2, 17, 23, 64, 96, 3, (2, 2), (1, 1, 1, 1)),
    (1, 9, 30, 516, 200, 1, (1, 1), (0, 0, 0, 0)),
    (1, 8, 12, 4, 8, 6, (2, 2), (2, 2, 2, 2)),
    (1, 10, 11, 24, 40, 3, (2, 1), (1, 1, 1, 0)),
])
def test_conv_kernel_identical_to_plain(cuda_device, b, h, w, cin, cout, k,
                                        stride, pads):
    rng = np.random.RandomState(cin + cout)
    x = _int8(rng, (b, h, w, cin))
    wq, scale, bias = _conv_case(rng, cin, cout, k)
    dev = [t.to(cuda_device) for t in (x, wq, scale, bias)]
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


@pytest.mark.parametrize('shortcut', [True, False])
@pytest.mark.parametrize('b,h,w,c', [(2, 12, 16, 128), (1, 9, 8, 128),
                                     (1, 60, 8, 64), (2, 17, 35, 36),
                                     (1, 5, 7, 516)])
def test_bottleneck_kernel_identical_to_plain(cuda_device, b, h, w, c,
                                              shortcut):
    rng = np.random.RandomState(c + h)
    x = _int8(rng, (b, h, w, c))
    w1, scale1, bias1 = _conv_case(rng, c, c, 1)
    w2, scale2, bias2 = _conv_case(rng, c, c, 3)
    args = (x, w1, scale1, bias1, 0.021, w2, scale2, bias2, 0.033,
            0.007, shortcut)
    dev = [a.to(cuda_device) if torch.is_tensor(a) else a for a in args]
    before = bottleneck_int8.launches
    got, got_scale = bottleneck_int8.bottleneck_int8(*dev)
    torch.cuda.synchronize()
    assert bottleneck_int8.launches == before + 1
    ref, ref_scale = bottleneck_int8.bottleneck_int8_reference(*dev)
    assert got_scale == ref_scale
    assert torch.equal(got, ref)


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
    detections and launch their kernels; the forward agrees with the
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
        conv_before = conv_int8.launches
        fused_before = bottleneck_int8.launches
        results[backend] = detector.generate_detections_one_batch(
            imgs, ['im{}'.format(i) for i in range(len(imgs))],
            detection_threshold=0.005)
        assert conv_int8.launches > conv_before
        assert (bottleneck_int8.launches > fused_before) == \
            (backend == 'pallas')
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
                                     (1, 8, 10, 256)])
def test_l0_fused_kernel_identical_to_plain(cuda_device, b, h, w, c):
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
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
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
                                   (4097, 2304, 256)])
def test_gemm_kernel_identical_to_plain(cuda_device, m, k, n, requant):
    """gemm_int8 (E5, E6) at the check shapes and off every tile (M, N, K
    not multiples of 64; K and N not multiples of 4 take the byte loads):
    identical to the plain version on the card and to numpy's int64
    product."""

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

