#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (megadetector_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: torch/CUDA versions and the card's name and power limit;
     TF32 off so float32 is float32;
  2. build: nvcc compiles megadetector_tpu_torch/csrc/*.cu;
  3. kernel vs plain: the greedy-NMS kernel against its plain PyTorch
     version on the card (B=8, K in 512/2048/8192, plus a suppression
     chain, exact duplicates and invalid slots); keep masks must be
     identical; ms per call of both;
  4. main path: yolov5l6 (MDv5a's architecture, nc=3, full width, random
     weights from seed 0) saved as .npz, load_detector on cuda,
     load_and_run_detector_batch over 16 synthetic 4:3 and 16:9 images
     (two auto canvases, batch 8), write_results_to_file; the MD JSON is
     checked and the NMS kernel's launch count must cover every device
     batch; images/s of a second, timed pass;
  5. card vs CPU: the same yolov5l6 forward on a 320 px batch of 2;
     heads agree to max |d| <= 1e-3 * max |ref| (cuDNN sums in another
     order than the CPU, even with TF32 off);
  6. int8 kernels vs plain on the card, at yolov5l6 shapes of a 960x1280
     canvas, batch 8: the conv kernel on l1's 3x3 s2 64->128, a 3x3 s1
     128->128 at 120x160 and a 1x1 512->256 at 120x160 (int32 and int8
     outputs), the bottleneck kernel at C 64 / 256 / 512 (240x320, 60x80,
     15x20) with and without the residual; outputs must be identical; ms
     per call of both, and of torch._int_mm on the 1x1 int32 case (the
     same function: the conv kernel's library yardstick);
  7. int8 main path: the port's quantize_checkpoint on phase 4's
     yolov5l6 (calibrated on two 320 px uniform images from
     RandomState(1)), load_detector on cuda with conv_backend xla, then
     pallas, load_and_run_detector_batch over the same 16 images and
     write_results_to_file; the MD JSON is checked, the conv kernel must
     launch once per chain conv of every batch (under pallas: once per
     chain conv outside the bottlenecks) and the bottleneck kernel once
     per bottleneck of every batch (pallas) or never (xla), and the two
     backends' detections must be identical; images/s of a second, timed
     pass of each;
  8. card vs CPU, int8 forward at 320 px, batch 2: decoded obj*cls
     scores p99 |d| < 0.02 and xy p99 |d| < 2 px (the bounds of the JAX
     package's int8-vs-float test);
  9. bf16 kernels vs plain on the card at yolov5l6 shapes of a 960x1280
     batch of 8: the fused stem on u8 [8,960,1280,3] -> [8,480,640,64]
     with the model's l0 weights, the bf16 epilogue (bias + SiLU) on l1's
     output [8,128,240,320] and on a [8,1024,15,20] tensor, both
     channels_last; outputs must be bit-identical; ms of kernel, plain
     version and the library yardstick (cuDNN's bf16 conv of the
     normalized batch for the stem, F.silu for the epilogue);
 10. bf16 main path: phase 4's yolov5l6 with dtype bf16 through
     load_and_run_detector_batch over the same 16 images, batch 8; the
     stem must launch once per batch and the bf16 epilogue once per
     activated conv after l0 per batch; images/s of a second pass and the
     forward's CUDA-event ms on one 960x1280 batch of 8;
 11. int8 with dtype bf16 under conv_backend xla and pallas: the stem once
     per batch, the int8 kernels as in phase 7, no bf16 epilogue;
 12. preprocess_mode=device, float32 and bf16: the 16 images plus one
     batch of 8 images of exactly 960x1280 (the identity path); the device
     letterbox against the host letterbox's canvas; counts (no stem: l0
     takes the letterbox's float output, so the bf16 epilogue runs for l0
     too); images/s;
 13. card vs CPU, bf16 forward at 320 px, batch 2: the int8 bounds;
 14. the int8 experiments' kernels vs plain on the card: the 3x3 conv
     (E1-E4) at batch 8 on the stride-8/16/32 levels of a 960x1280 canvas
     (120x160x128, 60x80x256, 30x40x512), every epilogue (f32,
     f32_nosilu, bf16, hybrid), in_ratio 0.8531 and 1.0, at the
     experiments' scales and at scales that spread the outputs over the
     int8 range; the GEMM (E5, E6) at 65536x1152x1152 and 38400x2304x256,
     int32 and fused int8; outputs must be identical; ms of kernel, plain
     version and the yardsticks (im2col + torch._int_mm + plain epilogue,
     requant pass + B2; torch._int_mm);
 15. the six experiment entry points (megadetector_tpu_torch/experiments)
     through their main() at batch 8 with a chain of 2: every variant
     launches exactly the kernels it declares, once per step.
With --profile, after phase 13: torch.profiler over one bf16 device
program on a 960x1280 batch of 8 (device time by kernel, idle share).
Then one JSON line with every kernel's record (time, plain time, bound,
library yardstick, launches on the main path), and last the device line.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

NMS_SOURCE = 'megadetector_tpu_torch/csrc/nms.cu'
NMS_REPLACES = 'megadetector_tpu/ops/pallas_nms.py:26'
CONV_SOURCE = 'megadetector_tpu_torch/csrc/conv_int8.cu'
CONV_REPLACES = 'megadetector_tpu/ops/pallas_conv.py:90'
BOTTLENECK_SOURCE = 'megadetector_tpu_torch/csrc/bottleneck_int8.cu'
BOTTLENECK_REPLACES = 'megadetector_tpu/ops/pallas_bottleneck.py:136'
STEM_SOURCE = 'megadetector_tpu_torch/csrc/l0_fused.cu'
STEM_REPLACES = 'megadetector_tpu/ops/pallas_l0.py:80'
SILU_SOURCE = 'megadetector_tpu_torch/csrc/silu_bf16.cu'
SILU_REPLACES = 'experiments/exp_pallas_l0_retry.py:71'
GEMM_SOURCE = 'megadetector_tpu_torch/csrc/gemm_int8.cu'
# The experiments' kernels: label -> (record name, source, TPU kernel,
# the epilogue and in_ratio of the record's conv time (E1-E4), entry point)
EXPERIMENTS = {
    'E1': ('conv3x3_int8_exp_f32', CONV_SOURCE,
           'experiments/exp_pallas_conv3x3.py:70', ('f32', 0.8531),
           'exp_conv3x3'),
    'E2': ('conv3x3_int8_exp_f32_nosilu', CONV_SOURCE,
           'experiments/exp_pallas_conv3x3b.py:66', ('f32_nosilu', 0.8531),
           'exp_conv3x3b'),
    'E3': ('conv3x3_int8_exp_bf16', CONV_SOURCE,
           'experiments/exp_pallas_conv3x3c.py:64', ('bf16', 0.8531),
           'exp_conv3x3c'),
    'E4': ('conv3x3_int8_exp_hybrid', CONV_SOURCE,
           'experiments/exp_pallas_conv3x3d.py:60', ('hybrid', 1.0),
           'exp_conv3x3d'),
    'E5': ('gemm_int8', GEMM_SOURCE, 'experiments/exp_pallas_int8_chain.py:82',
           None, 'exp_int8_chain'),
    'E6': ('gemm_int8', GEMM_SOURCE,
           'experiments/exp_pallas_int8_matmul.py:73', None,
           'exp_int8_matmul'),
}

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W) for bound_ms
HBM_BYTES_PER_MS = 3.35e12 / 1e3
INT8_OPS_PER_MS = 1979e12 / 1e3
BF16_OPS_PER_MS = 989e12 / 1e3
F32_OPS_PER_MS = 67e12 / 1e3


def _bound(n_bytes, n_ops, ops_per_ms):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""

    t_bytes = n_bytes / HBM_BYTES_PER_MS
    t_ops = n_ops / ops_per_ms
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _time_ms(fn, reps, warmup=2):
    """Mean ms per call of fn() on the card (CUDA events)."""

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nms_case(rng, b, k, n_classes=3, canvas=1280.0):
    """Seeded score-sorted boxes [b, k, 4], class-offset like
    nms_on_candidates does, with ~10% invalid slots."""

    import numpy as np

    xy = rng.uniform(0, canvas, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(8, 240, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    classes = rng.randint(0, n_classes, (b, k)).astype(np.float32)
    boxes += classes[..., None] * np.float32(8192.0)
    valid = rng.rand(b, k) > 0.1
    return boxes, valid


def phase_kernel(device):
    """Kernel vs plain version on the card; returns the kernel record."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.ops import cuda_nms

    rng = np.random.RandomState(0)
    cases = []
    for k in (512, 2048, 8192):
        cases.append(('random B=8 K={}'.format(k), k) +
                     _nms_case(rng, 8, k) + (0.45,))

    # A overlaps B, B overlaps C, A does not overlap C: A and C are kept
    chain = np.array([[[100, 100, 140, 140], [120, 100, 160, 140],
                       [140, 100, 180, 140], [500, 500, 540, 540]]],
                     np.float32)
    cases.append(('chain', 4, chain, np.ones((1, 4), bool), 0.2))

    # Exact duplicates across the 64-box word boundary, invalid slots
    dup, dup_valid = _nms_case(rng, 2, 130)
    dup[:, 1] = dup[:, 0]
    dup[:, 64] = dup[:, 0]
    dup[:, 65] = dup[:, 3]
    dup[:, 127] = dup[:, 126]
    dup_valid[:, 0] = True
    dup_valid[:, 3] = False
    dup_valid[:, 100:110] = False
    cases.append(('duplicates+invalid', 130, dup, dup_valid, 0.45))

    timings = {}
    max_err = 0.0
    for name, k, boxes_np, valid_np, thresh in cases:
        boxes = torch.from_numpy(boxes_np).to(device)
        valid = torch.from_numpy(valid_np).to(device)
        got = cuda_nms.greedy_nms_keep(boxes, valid, thresh)
        torch.cuda.synchronize()
        ref = cuda_nms.greedy_nms_keep_reference(boxes, valid, thresh)
        max_err = max(max_err, float((got.int() - ref.int()).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(
                'NMS kernel disagrees with its plain version on {}: {} of '
                '{} slots differ'.format(name, int((got != ref).sum()),
                                         got.numel()))
        if name == 'chain' and got.cpu().numpy().tolist() != \
                [[True, False, True, True]]:
            raise AssertionError('chain case kept {}'.format(
                got.cpu().numpy().tolist()))
        line = 'kernel == plain on {}: kept {} of {} valid'.format(
            name, int(got.sum()), int(valid.sum()))
        if name.startswith('random'):
            ms = _time_ms(lambda: cuda_nms.greedy_nms_keep(
                boxes, valid, thresh), reps=20)
            plain_ms = _time_ms(lambda: cuda_nms.greedy_nms_keep_reference(
                boxes, valid, thresh), reps=2, warmup=1)
            timings[k] = (ms, plain_ms)
            line += '; kernel {:.4f} ms, plain {:.4f} ms per call'.format(
                ms, plain_ms)
        print(line, flush=True)
        del boxes, valid, got, ref
        torch.cuda.empty_cache()

    ms, plain_ms = timings[8192]
    # B=8, K=8192: boxes, valid in, keep out; K(K-1)/2 IoU tests per image
    # at 14 float32 operations each (intersection 9, union 2, divide and
    # max 2, compare 1), on the CUDA cores
    k = 8192
    bound_ms, bound_by = _bound(8 * k * (16 + 1 + 1),
                                8 * k * (k - 1) / 2 * 14, F32_OPS_PER_MS)
    print('greedy NMS B=8 K=8192: bound {:.4f} ms ({}); library call: none '
          '(PyTorch has no greedy NMS; torchvision is absent)'.format(
              bound_ms, bound_by), flush=True)
    return {'name': 'greedy_nms', 'route': 'cuda', 'source': NMS_SOURCE,
            'replaces': NMS_REPLACES, 'launches': None,
            'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None}


def _synthetic_images(rng):
    """16 seeded uint8 images: 8 at 1536x2048 (4:3), 8 at 1080x1920
    (16:9), gradients + blocks + noise."""

    import numpy as np

    images = []
    for i in range(16):
        h, w = (1536, 2048) if i % 2 == 0 else (1080, 1920)
        yy = np.linspace(0, 255, h, dtype=np.float32)[:, None]
        xx = np.linspace(0, 255, w, dtype=np.float32)[None, :]
        img = np.empty((h, w, 3), np.float32)
        img[..., 0] = xx
        img[..., 1] = yy
        img[..., 2] = 96 + 40 * i % 160
        for _ in range(6):
            y0, x0 = rng.randint(0, h - h // 5), rng.randint(0, w - w // 5)
            img[y0:y0 + h // 6, x0:x0 + w // 6] = rng.randint(0, 255, 3)
        img += rng.randint(-20, 20, (h, w, 1))
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def _write_and_check(results, pairs, model_path, out_file):
    """write_results_to_file, then check the MD JSON; returns the number
    of detections."""

    from megadetector_tpu_torch.detection.run_detector_batch import \
        write_results_to_file

    write_results_to_file(results, out_file, detector_file=model_path)
    with open(out_file) as f:
        written = json.load(f)
    if written['info']['format_version'] != '1.6':
        raise AssertionError('format_version {}'.format(
            written['info']['format_version']))
    files = sorted(im['file'] for im in written['images'])
    if files != sorted(p[0] for p in pairs):
        raise AssertionError('images in the JSON: {}'.format(files))
    n_det = 0
    for im in written['images']:
        if 'failure' in im or im['detections'] is None:
            raise AssertionError('{} failed: {}'.format(
                im['file'], im.get('failure')))
        for det in im['detections']:
            x, y, w, h = det['bbox']
            if not all(0.0 <= v <= 1.0 for v in (x, y, w, h)) or \
                    x + w > 1.0 + 1e-6 or y + h > 1.0 + 1e-6:
                raise AssertionError('{}: bbox {} outside [0, 1]'.format(
                    im['file'], det['bbox']))
            if not 0.0 < det['conf'] <= 1.0:
                raise AssertionError('{}: conf {}'.format(im['file'],
                                                          det['conf']))
            n_det += 1
    return n_det


def phase_main_path(device, workdir, config, params):
    """The port's batch detection path on the card; returns
    (launches, images/s, detector)."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch
    from megadetector_tpu_torch.models.convert_weights import \
        save_checkpoint
    from megadetector_tpu_torch.ops import cuda_nms

    model_path = os.path.join(workdir, 'md_smoke_{}.npz'.format(config.arch))
    save_checkpoint(params, model_path, {
        'arch': config.arch, 'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'], 'image_size': 1280})
    detector = load_detector(model_path, detector_options={
        'pad_batches_to': 8}, device=device)

    rng = np.random.RandomState(1)
    pairs = [('smoke/img_{:02d}.jpg'.format(i), img)
             for i, img in enumerate(_synthetic_images(rng))]

    cuda_nms.launches = 0
    detector.programs_run = 0
    results = load_and_run_detector_batch(detector, pairs, batch_size=8)
    torch.cuda.synchronize()
    launches = cuda_nms.launches
    batches = detector.programs_run

    n_det = _write_and_check(results, pairs, model_path,
                             os.path.join(workdir, 'smoke_results.json'))
    if batches < 2 or launches < batches:
        raise AssertionError('{} device batches but {} NMS kernel '
                             'launches'.format(batches, launches))
    truncated = sum(1 for im in results if 'pre_nms_truncation' in im)
    print('main path: 16 images, {} detections, {} device batches, {} NMS '
          'kernel launches, {} images past the 8192 capacity'.format(
              n_det, batches, launches, truncated), flush=True)

    # Timed second pass through the same entry point (host letterbox
    # included), then the device program alone on letterboxed batches
    start = time.time()
    load_and_run_detector_batch(detector, pairs, batch_size=8, quiet=True)
    torch.cuda.synchronize()
    e2e = len(pairs) / (time.time() - start)

    infos = [detector.preprocess_image(img, image_id=name)
             for name, img in pairs]
    buckets = {}
    for info in infos:
        buckets.setdefault(tuple(info['target_shape']), []).append(info)
    torch.cuda.synchronize()
    start = time.time()
    for bucket in buckets.values():
        detector.generate_detections_one_batch(bucket,
                                               detection_threshold=0.005)
    torch.cuda.synchronize()
    device_rate = len(infos) / (time.time() - start)
    return launches, e2e, device_rate, detector, buckets, model_path, pairs


def phase_breakdown(detector, buckets):
    """CUDA-event ms of forward / selection / NMS for one 960x1280 batch
    of 8 at the capacity the main path escalated to."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.ops.decode import select_topk_candidates
    from megadetector_tpu_torch.ops.nms import nms_on_candidates

    batch = np.stack([info['img_processed']
                      for info in buckets[(960, 1280)]])
    out, topk = detector.run_program(batch, 0.005, 0.45)
    config = detector.config
    with torch.inference_mode():
        x = torch.from_numpy(batch).to(detector.device).float() / 255.0
        heads = detector.model(x, decode=False)
        fwd = _time_ms(lambda: detector.model(x, decode=False), reps=5)
        sel = _time_ms(lambda: select_topk_candidates(
            heads, config.anchors, config.strides, config.num_classes,
            0.005, topk), reps=10)
        cands = select_topk_candidates(heads, config.anchors, config.strides,
                                       config.num_classes, 0.005, topk)
        nms = _time_ms(lambda: nms_on_candidates(cands, 0.45), reps=10)
    print('breakdown 960x1280 batch 8 (capacity {}, max above-floor '
          'candidates {}): forward {:.3f} ms, select {:.3f} ms, '
          'nms_on_candidates {:.3f} ms'.format(
              topk, int(out['n_candidates'].max()), fwd, sel, nms),
          flush=True)
    return batch, fwd


def phase_card_vs_cpu(detector, config, params):
    import numpy as np
    import torch

    from megadetector_tpu_torch.models.yolov5 import YoloV5

    x = np.random.RandomState(2).rand(2, 320, 320, 3).astype(np.float32)
    cpu_model = YoloV5(config).load_params(params).eval()
    with torch.inference_mode():
        ref = cpu_model(torch.from_numpy(x), decode=False)
        got = detector.model(torch.from_numpy(x).to(detector.device),
                             decode=False)
    worst = 0.0
    for lvl, (r, g) in enumerate(zip(ref, got)):
        g = g.cpu()
        if tuple(r.shape) != tuple(g.shape) or not torch.isfinite(g).all():
            raise AssertionError('level {}: shape {} vs {} or non-finite'
                                 .format(lvl, tuple(g.shape),
                                         tuple(r.shape)))
        diff = float((g - r).abs().max())
        scale = float(r.abs().max())
        if diff > 1e-3 * scale:
            raise AssertionError('level {}: max |d| {} > 1e-3 * {}'.format(
                lvl, diff, scale))
        worst = max(worst, diff / scale)
    print('card vs CPU yolov5l6 heads at 320 px: max |d| / max |ref| = '
          '{:.3e} (limit 1e-3)'.format(worst), flush=True)


def _int8_conv_case(rng, device, cin, cout, k):
    """Seeded int8 weight [cout, k, k, cin] and a float32 scale that puts
    acc * scale at about unit std, plus a bias, on the card."""

    import numpy as np
    import torch

    w = rng.randint(-127, 128, (cout, k, k, cin)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, cout) / (np.sqrt(cin * k * k) *
                                           127.0 * 127.0 / 3.0)
    bias = rng.uniform(-0.5, 0.5, cout)
    return (torch.from_numpy(w).to(device),
            torch.from_numpy(scale.astype(np.float32)).to(device),
            torch.from_numpy(bias.astype(np.float32)).to(device))


def _int8_input(rng, device, shape):
    import numpy as np
    import torch

    return torch.from_numpy(rng.randint(-127, 128, shape).astype(
        np.int8)).to(device)


def phase_int8_kernels(device):
    """Conv and bottleneck kernels vs their plain versions on the card at
    yolov5l6 shapes (960x1280 canvas, batch 8); returns their records."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.ops import bottleneck_int8, conv_int8

    rng = np.random.RandomState(6)
    conv_cases = [
        ('l1 3x3 s2 [8,480,640,64]->128', (8, 480, 640, 64), 128, 3,
         (2, 2), (1, 1, 1, 1)),
        ('3x3 s1 [8,120,160,128]->128', (8, 120, 160, 128), 128, 3,
         (1, 1), (1, 1, 1, 1)),
        ('1x1 [8,120,160,512]->256', (8, 120, 160, 512), 256, 1,
         (1, 1), (0, 0, 0, 0)),
    ]
    conv_ms, conv_err, bottleneck_err = {}, 0, 0
    for name, shape, cout, k, stride, pads in conv_cases:
        x = _int8_input(rng, device, shape)
        w, scale, bias = _int8_conv_case(rng, device, shape[3], cout, k)
        for y_scale in (None, 0.02):
            got = conv_int8.conv_int8(x, w, scale, bias, stride, pads,
                                      y_scale)
            torch.cuda.synchronize()
            ref = conv_int8.conv_int8_reference(x, w, scale, bias, stride,
                                                pads, y_scale)
            conv_err = max(conv_err, int((got.long() - ref.long()).abs()
                                         .max()))
            if not torch.equal(got, ref):
                raise AssertionError(
                    'conv kernel disagrees with its plain version on {} '
                    '({}): {} of {} elements differ'.format(
                        name, 'int32' if y_scale is None else 'int8',
                        int((got != ref).sum()), got.numel()))
        ms = _time_ms(lambda: conv_int8.conv_int8(
            x, w, scale, bias, stride, pads, 0.02), reps=10)
        plain_ms = _time_ms(lambda: conv_int8.conv_int8_reference(
            x, w, scale, bias, stride, pads, 0.02), reps=2, warmup=1)
        conv_ms[name] = (ms, plain_ms)
        print('conv kernel == plain (int32 and int8) on {}: kernel {:.4f} '
              'ms, plain {:.4f} ms per call'.format(name, ms, plain_ms),
              flush=True)
        if k == 1:
            # the 1x1 int32 case is a GEMM: torch._int_mm (cuBLASLt, int8
            # tensor cores) computes the same function
            x2d = x.view(-1, shape[3])
            w2d = w.view(cout, shape[3]).t().contiguous()
            lib = torch._int_mm(x2d, w2d)
            if not torch.equal(lib.view(got.shape[:3] + (cout,)),
                               conv_int8.conv_int8(x, w, scale, bias, stride,
                                                   pads, None)):
                raise AssertionError('torch._int_mm and the conv kernel '
                                     'differ on {} (int32)'.format(name))
            int32_ms = _time_ms(lambda: conv_int8.conv_int8(
                x, w, scale, bias, stride, pads, None), reps=10)
            lib_ms = _time_ms(lambda: torch._int_mm(x2d, w2d), reps=10)
            conv_lib = (int32_ms, lib_ms)
            print('  int32 on {}: kernel {:.4f} ms, torch._int_mm (same '
                  'function, identical) {:.4f} ms'.format(name, int32_ms,
                                                          lib_ms), flush=True)
            del x2d, w2d, lib
        del x, w, got, ref
        torch.cuda.empty_cache()

    bottleneck_ms = {}
    for c, h, w_ in ((64, 240, 320), (256, 60, 80), (512, 15, 20)):
        x = _int8_input(rng, device, (8, h, w_, c))
        w1, s1, b1 = _int8_conv_case(rng, device, c, c, 1)
        w2, s2, b2 = _int8_conv_case(rng, device, c, c, 3)
        for shortcut in (True, False):
            args = (x, w1, s1, b1, 0.021, w2, s2, b2, 0.033, 0.007,
                    shortcut)
            got, got_scale = bottleneck_int8.bottleneck_int8(*args)
            torch.cuda.synchronize()
            ref, ref_scale = bottleneck_int8.bottleneck_int8_reference(*args)
            bottleneck_err = max(bottleneck_err, int(
                (got.long() - ref.long()).abs().max()))
            name = 'C={} [8,{},{}] shortcut={}'.format(c, h, w_, shortcut)
            if got_scale != ref_scale or not torch.equal(got, ref):
                raise AssertionError(
                    'bottleneck kernel disagrees with its plain version on '
                    '{}: {} of {} elements differ'.format(
                        name, int((got != ref).sum()), got.numel()))
            ms = _time_ms(lambda: bottleneck_int8.bottleneck_int8(*args),
                          reps=10)
            plain_ms = _time_ms(
                lambda: bottleneck_int8.bottleneck_int8_reference(*args),
                reps=2, warmup=1)
            bottleneck_ms[name] = (ms, plain_ms)
            line = 'bottleneck kernel == plain on {}: kernel {:.4f} ms, ' \
                'plain {:.4f} ms per call'.format(name, ms, plain_ms)
            if shortcut:
                # the same bottleneck unfused: two conv kernel launches and
                # the residual requant in torch (the conv_backend=xla route)
                def unfused():
                    h1 = conv_int8.conv_int8(x, w1, s1, b1, (1, 1),
                                             (0, 0, 0, 0), 0.021)
                    h2 = conv_int8.conv_int8(h1, w2, s2, b2, (1, 1),
                                             (1, 1, 1, 1), 0.033)
                    return bottleneck_int8.residual_requant(x, 0.007, h2,
                                                            0.033)
                if not torch.equal(unfused()[0], got):
                    raise AssertionError('fused and unfused kernels differ '
                                         'on {}'.format(name))
                line += '; unfused through the conv kernel (identical) ' \
                    '{:.4f} ms'.format(_time_ms(unfused, reps=10))
            print(line, flush=True)
        del x, got, ref
        torch.cuda.empty_cache()

    ms, plain_ms = conv_ms['3x3 s1 [8,120,160,128]->128']
    # int8 x, w in; scale, bias; int8 out; 2 ops per int8 MAC
    pixels = 8 * 120 * 160
    conv_bound = _bound(pixels * 128 * 2 + 128 * 9 * 128 + 128 * 8,
                        2 * pixels * 128 * 128 * 9, INT8_OPS_PER_MS)
    conv_record = {'name': 'conv_int8', 'route': 'cuda',
                   'source': CONV_SOURCE, 'replaces': CONV_REPLACES,
                   'launches': None, 'max_abs_err': float(conv_err),
                   'ms': ms, 'plain_ms': plain_ms,
                   'bound_ms': conv_bound[0], 'bound_by': conv_bound[1],
                   'library_ms': conv_lib[1]}
    ms, plain_ms = bottleneck_ms['C=256 [8,60,80] shortcut=True']
    pixels = 8 * 60 * 80
    fused_bound = _bound(pixels * 256 * 2 + 256 * 256 * 10 + 256 * 16,
                         2 * pixels * 256 * 256 * 10, INT8_OPS_PER_MS)
    bottleneck_record = {'name': 'bottleneck_int8', 'route': 'cuda',
                         'source': BOTTLENECK_SOURCE,
                         'replaces': BOTTLENECK_REPLACES, 'launches': None,
                         'max_abs_err': float(bottleneck_err), 'ms': ms,
                         'plain_ms': plain_ms, 'bound_ms': fused_bound[0],
                         'bound_by': fused_bound[1], 'library_ms': None}
    print('int8 bounds: conv 3x3 s1 [8,120,160,128]->128 {:.4f} ms ({}), '
          'bottleneck C=256 [8,60,80] {:.4f} ms ({}); library call: none '
          'for a 3x3 (PyTorch has no CUDA int8 convolution); the conv '
          'record\'s library_ms is torch._int_mm on the 1x1 512->256 int32 '
          'case ({:.4f} ms, the kernel {:.4f} ms there)'.format(
              conv_bound[0], conv_bound[1], fused_bound[0], fused_bound[1],
              conv_lib[1], conv_lib[0]), flush=True)
    return conv_record, bottleneck_record


def phase_int8_main_path(device, workdir, float_path, pairs, batch):
    """The int8 chain through the port's entry points on the card, under
    both conv backends, and the forward's CUDA-event ms on [batch] (one
    960x1280 batch of 8); returns (int8 checkpoint path, {backend: (conv
    launches, bottleneck launches)}, {backend: images/s}, {backend:
    forward ms}, last detector)."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch
    from megadetector_tpu_torch.models.convert_weights import \
        quantize_checkpoint
    from megadetector_tpu_torch.models.yolov5 import Bottleneck, QConv
    from megadetector_tpu_torch.ops import bottleneck_int8, conv_int8

    q_path = os.path.join(workdir, 'md_smoke_int8.npz')
    start = time.time()
    calib = np.random.RandomState(1).uniform(
        0, 1, (2, 320, 320, 3)).astype(np.float32)
    quantize_checkpoint(float_path, q_path, calibration_images=calib,
                        device=device)
    print('int8 checkpoint: quantize_checkpoint calibrated on the card in '
          '{:.1f} s'.format(time.time() - start), flush=True)

    counts, rates, forward_ms, detections = {}, {}, {}, {}
    for backend in ('xla', 'pallas'):
        detector = load_detector(q_path, device=device, detector_options={
            'pad_batches_to': 8, 'conv_backend': backend})
        modules = list(detector.model.modules())
        n_qconv = sum(isinstance(m, QConv) for m in modules)
        n_bottleneck = sum(isinstance(m, Bottleneck) for m in modules)
        if backend == 'pallas':
            want_conv, want_fused = n_qconv - 2 * n_bottleneck, n_bottleneck
        else:
            want_conv, want_fused = n_qconv, 0

        detector.programs_run = 0
        conv_int8.launches = 0
        bottleneck_int8.launches = 0
        results = load_and_run_detector_batch(detector, pairs, batch_size=8)
        torch.cuda.synchronize()
        got = (conv_int8.launches, bottleneck_int8.launches)
        batches = detector.programs_run
        if batches < 2 or got != (want_conv * batches, want_fused * batches):
            raise AssertionError(
                'int8 {}: {} batches, kernel launches (conv, bottleneck) {}, '
                'expected ({} x {}, {} x {})'.format(
                    backend, batches, got, want_conv, batches, want_fused,
                    batches))
        counts[backend] = got
        n_det = _write_and_check(results, pairs, q_path, os.path.join(
            workdir, 'smoke_int8_{}.json'.format(backend)))
        detections[backend] = results

        start = time.time()
        load_and_run_detector_batch(detector, pairs, batch_size=8,
                                    quiet=True)
        torch.cuda.synchronize()
        rates[backend] = len(pairs) / (time.time() - start)
        with torch.inference_mode():
            x = torch.from_numpy(batch).to(device).float() / 255.0
            forward_ms[backend] = _time_ms(
                lambda: detector.model(x, decode=False), reps=5)
        print('int8 main path, conv_backend={}: 16 images, {} detections, '
              '{} device batches; conv kernel {} launches ({} chain convs '
              'x {}), bottleneck kernel {} ({} x {}); {:.3f} images/s '
              'through load_and_run_detector_batch (second pass); forward '
              '{:.3f} ms per 960x1280 batch of 8'.format(
                  backend, n_det, batches, got[0], want_conv, batches,
                  got[1], want_fused, batches, rates[backend],
                  forward_ms[backend]), flush=True)
    if detections['xla'] != detections['pallas']:
        raise AssertionError('int8 detections differ between the conv '
                             'backends')
    print('int8 detections identical under conv_backend xla and pallas',
          flush=True)
    return q_path, counts, rates, forward_ms, detector


def phase_int8_card_vs_cpu(q_path, detector):
    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector

    x = np.random.RandomState(2).rand(2, 320, 320, 3).astype(np.float32)
    cpu = load_detector(q_path, device='cpu')
    with torch.inference_mode():
        ref = cpu.model(torch.from_numpy(x), decode=True).numpy()
        got = detector.model(torch.from_numpy(x).to(detector.device),
                             decode=True).cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError('int8 forward: shape {} vs {} or '
                             'non-finite'.format(got.shape, ref.shape))
    d_score = np.percentile(np.abs(got[..., 4:5] * got[..., 5:] -
                                   ref[..., 4:5] * ref[..., 5:]), 99)
    d_xy = np.percentile(np.abs(got[..., :2] - ref[..., :2]), 99)
    if not (d_score < 0.02 and d_xy < 2.0):
        raise AssertionError('int8 card vs CPU: score p99 {} (limit 0.02), '
                             'xy p99 {} px (limit 2)'.format(d_score, d_xy))
    print('int8 card vs CPU yolov5l6 at 320 px: decoded score p99 |d| '
          '{:.3e} (limit 0.02), xy p99 |d| {:.3e} px (limit 2)'.format(
              d_score, d_xy), flush=True)


def _n_activated_convs(model):
    """Float convs with SiLU (every one runs the bf16 epilogue in bf16)."""

    from megadetector_tpu_torch.models.yolov5 import Conv

    return sum(1 for m in model.modules() if type(m) is Conv and m.act)


def phase_bf16_kernels(device, params):
    """Fused stem and bf16 epilogue vs their plain versions on the card at
    yolov5l6 shapes (960x1280 canvas, batch 8); returns their records."""

    import numpy as np
    import torch
    import torch.nn.functional as F

    from megadetector_tpu_torch.ops import l0_fused, silu_bf16

    rng = np.random.RandomState(9)
    images = torch.from_numpy(rng.randint(0, 256, (8, 960, 1280, 3),
                                          dtype=np.uint8)).to(device)
    w, b = l0_fused.prepare_l0_weights(params['l0'])
    w, b = w.to(device), b.to(device)
    got = l0_fused.l0_fused(images, w, b)
    torch.cuda.synchronize()
    ref = l0_fused.l0_fused_reference(images, w, b)
    if tuple(got.shape) != (8, 480, 640, 64) or \
            not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError(
            'stem kernel disagrees with its plain version: {} of {} '
            'elements differ'.format(int((got != ref).sum()), got.numel()))
    stem_err = float((got.float() - ref.float()).abs().max())
    stem_ms = _time_ms(lambda: l0_fused.l0_fused(images, w, b), reps=10)
    stem_plain_ms = _time_ms(
        lambda: l0_fused.l0_fused_reference(images, w, b), reps=2, warmup=1)
    # Yardstick: cuDNN's bf16 conv (+ bias) of the normalized batch
    x16 = (images.float() / 255.0).to(torch.bfloat16).permute(0, 3, 1, 2)
    w16 = torch.from_numpy(np.asarray(params['l0']['w'], np.float32)).permute(
        3, 2, 0, 1).to(torch.bfloat16).to(device).contiguous(
            memory_format=torch.channels_last)
    b16 = b.to(torch.bfloat16)
    stem_lib_ms = _time_ms(lambda: F.conv2d(x16, w16, b16, 2, 2), reps=10)
    macs = 8 * 480 * 640 * 64 * 108
    stem_bound = _bound(images.numel() + got.numel() * 2 + w.numel() * 2 +
                        b.numel() * 4, 2 * macs, BF16_OPS_PER_MS)
    print('stem kernel == plain (bit-identical) on u8 [8,960,1280,3] -> '
          '[8,480,640,64] bf16: kernel {:.4f} ms, plain {:.4f} ms, cuDNN bf16 '
          'conv of the normalized batch {:.4f} ms, bound {:.4f} ms ({}; {:.1f} '
          'G MAC)'.format(stem_ms, stem_plain_ms, stem_lib_ms, stem_bound[0],
                          stem_bound[1], macs / 1e9), flush=True)
    del images, got, ref, x16
    torch.cuda.empty_cache()

    silu_times = {}
    silu_err = 0.0
    for name, shape in (('l1 output [8,128,240,320]', (8, 128, 240, 320)),
                        ('[8,1024,15,20]', (8, 1024, 15, 20))):
        x = (torch.randn(shape, generator=torch.Generator().manual_seed(3))
             * 3).to(torch.bfloat16).to(device).contiguous(
                 memory_format=torch.channels_last)
        bias = (torch.rand(shape[1], generator=torch.Generator().manual_seed(
            4)) * 2 - 1).to(torch.bfloat16).to(device)
        for bias_arg in (bias, None):
            got = silu_bf16.silu_bf16(x, bias_arg)
            torch.cuda.synchronize()
            ref = silu_bf16.silu_bf16_reference(x, bias_arg)
            if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                raise AssertionError(
                    'bf16 epilogue disagrees with its plain version on {} '
                    '(bias {}): {} elements differ'.format(
                        name, bias_arg is not None, int((got != ref).sum())))
            silu_err = max(silu_err, float((got.float() - ref.float()).abs()
                                           .max()))
        ms = _time_ms(lambda: silu_bf16.silu_bf16(x, bias), reps=20)
        ms_nobias = _time_ms(lambda: silu_bf16.silu_bf16(x), reps=20)
        plain_ms = _time_ms(lambda: silu_bf16.silu_bf16_reference(x, bias),
                            reps=5, warmup=1)
        lib_ms = _time_ms(lambda: F.silu(x), reps=20)
        bound = _bound(x.numel() * 4 + bias.numel() * 2, x.numel() * 6,
                       F32_OPS_PER_MS)
        silu_times[name] = (ms, plain_ms, lib_ms, bound)
        print('bf16 epilogue == plain (bit-identical, with and without bias) '
              'on {} channels_last: kernel {:.4f} ms with bias ({:.4f} ms '
              'without), plain {:.4f} ms, F.silu {:.4f} ms, bound {:.4f} ms '
              '({})'.format(name, ms, ms_nobias, plain_ms, lib_ms, bound[0],
                            bound[1]), flush=True)
        del x, got, ref
        torch.cuda.empty_cache()

    stem_record = {'name': 'l0_fused', 'route': 'cuda',
                   'source': STEM_SOURCE, 'replaces': STEM_REPLACES,
                   'launches': None, 'max_abs_err': stem_err,
                   'ms': stem_ms, 'plain_ms': stem_plain_ms,
                   'bound_ms': stem_bound[0], 'bound_by': stem_bound[1],
                   'library_ms': stem_lib_ms}
    ms, plain_ms, lib_ms, bound = silu_times['l1 output [8,128,240,320]']
    silu_record = {'name': 'silu_bf16', 'route': 'cuda',
                   'source': SILU_SOURCE, 'replaces': SILU_REPLACES,
                   'launches': None, 'max_abs_err': silu_err, 'ms': ms,
                   'plain_ms': plain_ms, 'bound_ms': bound[0],
                   'bound_by': bound[1], 'library_ms': lib_ms}
    return stem_record, silu_record


def _reset_counts():
    from megadetector_tpu_torch.ops import (bottleneck_int8, conv_int8,
                                            cuda_nms, gemm_int8, l0_fused,
                                            silu_bf16)

    for module in (bottleneck_int8, conv_int8, cuda_nms, gemm_int8,
                   l0_fused, silu_bf16):
        module.launches = 0
    conv_int8.exp_launches = 0


def _counts():
    """Launches since _reset_counts: (nms, conv, bottleneck, stem, silu)."""

    import torch

    from megadetector_tpu_torch.ops import (bottleneck_int8, conv_int8,
                                            cuda_nms, l0_fused, silu_bf16)

    torch.cuda.synchronize()
    return (cuda_nms.launches, conv_int8.launches, bottleneck_int8.launches,
            l0_fused.launches, silu_bf16.launches)


def _forward_ms(detector, batch):
    import torch

    with torch.inference_mode():
        x = torch.from_numpy(batch).to(detector.device)
        return _time_ms(lambda: detector.model(x, decode=False), reps=5)


def phase_bf16_main_path(device, workdir, float_path, pairs, batch):
    """The bf16 configuration through the port's entry points; returns
    (stem launches, epilogue launches, images/s, forward ms, detector)."""

    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch

    detector = load_detector(float_path, device=device, detector_options={
        'pad_batches_to': 8, 'dtype': 'bfloat16'})
    n_epilogue = _n_activated_convs(detector.model) - 1
    detector.programs_run = 0
    _reset_counts()
    results = load_and_run_detector_batch(detector, pairs, batch_size=8)
    nms, conv, fused, stem, silu = _counts()
    batches = detector.programs_run
    if batches < 2 or stem != batches or silu != n_epilogue * batches or \
            nms < batches or conv or fused:
        raise AssertionError(
            'bf16 main path: {} batches; launches nms {}, stem {} (want {}), '
            'bf16 epilogue {} (want {} x {}), int8 {} {}'.format(
                batches, nms, stem, batches, silu, n_epilogue, batches, conv,
                fused))
    n_det = _write_and_check(results, pairs, float_path, os.path.join(
        workdir, 'smoke_bf16.json'))
    start = time.time()
    load_and_run_detector_batch(detector, pairs, batch_size=8, quiet=True)
    torch.cuda.synchronize()
    rate = len(pairs) / (time.time() - start)
    fwd = _forward_ms(detector, batch)
    print('bf16 main path: 16 images, {} detections, {} device batches; stem '
          'kernel {} launches (1 x {}), bf16 epilogue {} ({} activated convs '
          'after l0 x {}), NMS {}; {:.3f} images/s through '
          'load_and_run_detector_batch (second pass); forward {:.3f} ms per '
          '960x1280 batch of 8 (uint8 in)'.format(
              n_det, batches, stem, batches, silu, n_epilogue, batches, nms,
              rate, fwd), flush=True)
    return stem, silu, rate, fwd, detector


def phase_int8_bf16_main_path(device, workdir, q_path, pairs, batch):
    """int8 with dtype bf16 (bf16 l0 and heads around the int8 chain)
    under both conv backends; returns {backend: images/s}, {backend:
    forward ms}."""

    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch
    from megadetector_tpu_torch.models.yolov5 import Bottleneck, QConv

    rates, forward_ms, detections = {}, {}, {}
    for backend in ('xla', 'pallas'):
        detector = load_detector(q_path, device=device, detector_options={
            'pad_batches_to': 8, 'conv_backend': backend,
            'dtype': 'bfloat16'})
        modules = list(detector.model.modules())
        n_qconv = sum(isinstance(m, QConv) for m in modules)
        n_bottleneck = sum(isinstance(m, Bottleneck) for m in modules)
        if backend == 'pallas':
            want_conv, want_fused = n_qconv - 2 * n_bottleneck, n_bottleneck
        else:
            want_conv, want_fused = n_qconv, 0
        detector.programs_run = 0
        _reset_counts()
        results = load_and_run_detector_batch(detector, pairs, batch_size=8)
        nms, conv, fused, stem, silu = _counts()
        batches = detector.programs_run
        if batches < 2 or (conv, fused, stem, silu) != (
                want_conv * batches, want_fused * batches, batches, 0) or \
                nms < batches:
            raise AssertionError(
                'int8 + bf16 {}: {} batches; launches conv {} (want {} x '
                '{}), bottleneck {} (want {} x {}), stem {}, bf16 epilogue {}'
                ', nms {}'.format(backend, batches, conv, want_conv, batches,
                                  fused, want_fused, batches, stem, silu,
                                  nms))
        n_det = _write_and_check(results, pairs, q_path, os.path.join(
            workdir, 'smoke_int8_bf16_{}.json'.format(backend)))
        detections[backend] = results
        start = time.time()
        load_and_run_detector_batch(detector, pairs, batch_size=8,
                                    quiet=True)
        torch.cuda.synchronize()
        rates[backend] = len(pairs) / (time.time() - start)
        forward_ms[backend] = _forward_ms(detector, batch)
        print('int8 + bf16 main path, conv_backend={}: {} detections, {} '
              'batches; stem {} launches, conv {}, bottleneck {}, bf16 '
              'epilogue {}; {:.3f} images/s (second pass); forward {:.3f} ms '
              'per 960x1280 batch of 8'.format(
                  backend, n_det, batches, stem, conv, fused, silu,
                  rates[backend], forward_ms[backend]), flush=True)
        del detector
        torch.cuda.empty_cache()
    if detections['xla'] != detections['pallas']:
        raise AssertionError('int8 + bf16 detections differ between the '
                             'conv backends')
    return rates, forward_ms


def _exact_canvas_images(rng, n=8):
    """n seeded uint8 images of exactly 960x1280, the auto canvas of a
    4:3 image at 1280 px: the device-preprocess identity path."""

    import numpy as np

    images = []
    for i in range(n):
        yy = np.linspace(0, 255, 960, dtype=np.float32)[:, None, None]
        img = yy + rng.randint(-30, 30, (960, 1280, 3)) + 10 * i
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def phase_device_preprocess(device, workdir, float_path, pairs,
                            image_size=1280, stride=64):
    """preprocess_mode=device for float32 and bf16; returns {dtype:
    images/s}."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch
    from megadetector_tpu_torch.ops import boxes, preprocess_device

    # The device letterbox against the host letterbox's canvas
    worst = 0.0
    canvases = []
    for shape in sorted({img.shape[:2] for _, img in pairs}):
        imgs = [img for _, img in pairs if img.shape[:2] == shape]
        staged, sizes = preprocess_device.stage_images(imgs, multiple=256)
        canvas = boxes.auto_target_shape(shape, image_size, stride=stride)
        canvases.append('{}x{}'.format(*canvas))
        with torch.inference_mode():
            out = preprocess_device.letterbox_batch(
                torch.from_numpy(staged).to(device),
                torch.from_numpy(sizes).to(device), canvas,
                scale_target=image_size).cpu().numpy() * 255.0
        for img, got in zip(imgs, out):
            host = boxes.letterbox(img, (image_size, image_size),
                                   stride=stride, auto=True)[0]
            if host.shape != got.shape:
                raise AssertionError('device canvas {} vs host {}'.format(
                    got.shape, host.shape))
            worst = max(worst, float(np.abs(got - host).max()))
    if worst > 2.0:
        raise AssertionError('device letterbox vs host letterbox: max |d| '
                             '{} levels (limit 2)'.format(worst))
    print('device letterbox vs host letterbox canvases ({}): max |d| {:.3f} '
          'of 255 (limit 2; cv2 rounds its bilinear to uint8)'.format(
              ', '.join(canvases), worst), flush=True)

    exact = _exact_canvas_images(np.random.RandomState(7))
    all_pairs = pairs + [('smoke/exact_{:02d}.jpg'.format(i), img)
                         for i, img in enumerate(exact)]
    rates = {}
    for dtype in ('float32', 'bfloat16'):
        detector = load_detector(float_path, device=device, detector_options={
            'pad_batches_to': 8, 'preprocess_mode': 'device',
            'dtype': dtype})
        n_act = _n_activated_convs(detector.model)
        detector.programs_run = detector.identity_programs_run = 0
        _reset_counts()
        results = load_and_run_detector_batch(detector, all_pairs,
                                              batch_size=8)
        nms, conv, fused, stem, silu = _counts()
        batches = detector.programs_run
        want_silu = n_act * batches if dtype == 'bfloat16' else 0
        if batches < 3 or detector.identity_programs_run < 1 or stem or \
                silu != want_silu or nms < batches:
            raise AssertionError(
                'device preprocess {}: {} batches ({} identity); launches '
                'stem {} (want 0), bf16 epilogue {} (want {}), nms {}'.format(
                    dtype, batches, detector.identity_programs_run, stem,
                    silu, want_silu, nms))
        n_det = _write_and_check(results, all_pairs, float_path,
                                 os.path.join(workdir, 'smoke_device_{}.json'
                                              .format(dtype)))
        start = time.time()
        load_and_run_detector_batch(detector, all_pairs, batch_size=8,
                                    quiet=True)
        torch.cuda.synchronize()
        rates[dtype] = len(all_pairs) / (time.time() - start)
        print('device preprocess, {}: 24 images, {} detections, {} batches '
              '({} on the identity path); bf16 epilogue {} launches, stem {}, '
              'NMS {}; {:.3f} images/s through load_and_run_detector_batch '
              '(second pass)'.format(dtype, n_det, batches,
                                     detector.identity_programs_run, silu,
                                     stem, nms, rates[dtype]), flush=True)
        del detector
        torch.cuda.empty_cache()
    return rates


def phase_bf16_card_vs_cpu(detector, config, params):
    import numpy as np
    import torch

    from megadetector_tpu_torch.models.yolov5 import YoloV5

    x = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 320, 320, 3), dtype=np.uint8))
    cpu_model = YoloV5(config).load_params(params).set_compute_dtype(
        torch.bfloat16, fused_stem=True).eval()
    with torch.inference_mode():
        ref = cpu_model(x, decode=True).numpy()
        got = detector.model(x.to(detector.device),
                             decode=True).cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError('bf16 forward: shape {} vs {} or non-finite'
                             .format(got.shape, ref.shape))
    d_score = np.percentile(np.abs(got[..., 4:5] * got[..., 5:] -
                                   ref[..., 4:5] * ref[..., 5:]), 99)
    d_xy = np.percentile(np.abs(got[..., :2] - ref[..., :2]), 99)
    if not (d_score < 0.02 and d_xy < 2.0):
        raise AssertionError('bf16 card vs CPU: score p99 {} (limit 0.02), '
                             'xy p99 {} px (limit 2)'.format(d_score, d_xy))
    print('bf16 card vs CPU yolov5l6 at 320 px: decoded score p99 |d| '
          '{:.3e} (limit 0.02), xy p99 |d| {:.3e} px (limit 2)'.format(
              d_score, d_xy), flush=True)


def phase_profile(detector, buckets):
    """torch.profiler over one device program (forward, selection, NMS)
    on a 960x1280 batch of 8: device time by kernel and the idle share."""

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = np.stack([info['img_processed']
                      for info in buckets[(960, 1280)]])
    detector.run_program(batch, 0.005, 0.45)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.time()
        detector.run_program(batch, 0.005, 0.45)
        torch.cuda.synchronize()
        wall_ms = (time.time() - start) * 1e3

    from torch.autograd import DeviceType

    def device_us(e):
        return getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0.0))

    # Device activities only (kernels, copies): the host ops that launch
    # them carry the same time again, and the profiler's own buffer
    # requests are not work of the program
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0 and
              not e.key.startswith('Activity Buffer')]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    print('profile, bf16 device program on a 960x1280 batch of 8: wall '
          '{:.3f} ms (profiler on), device busy {:.3f} ms, idle share '
          '{:.3f}'.format(wall_ms, busy_ms, 1.0 - busy_ms / wall_ms),
          flush=True)
    for e in sorted(events, key=device_us, reverse=True)[:16]:
        print('  {:>9.3f} ms  {:>5d} x  {}'.format(
            device_us(e) / 1e3, e.count, e.key[:90]), flush=True)


def _uniform(rng, device, shape, lo, hi):
    import numpy as np
    import torch

    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
        np.float32)).to(device)


def phase_exp_kernels(device):
    """The experiments' conv (E1-E4) and GEMM (E5, E6) kernels vs their
    plain versions on the card; returns {label: record} without launches."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.experiments import _harness
    from megadetector_tpu_torch.ops import conv_int8, gemm_int8

    rng = np.random.RandomState(14)
    epilogues = sorted(conv_int8.EXP_EPILOGUES)
    conv_ms, conv_err, conv_lib = {}, {}, {}
    for h, w, c in ((120, 160, 128), (60, 80, 256), (30, 40, 512)):
        x = _int8_input(rng, device, (8, h, w, c))
        w_hwio = torch.from_numpy(rng.randint(-127, 128, (3, 3, c, c))
                                  .astype(np.int8))
        wk = conv_int8.prepare_weight(w_hwio).to(device)
        w_hwio = w_hwio.to(device)
        level = '[8,{},{},{}]'.format(h, w, c)
        for scales in ((1e-6, 4e-6), (1e-4, 4e-4)):
            scale = _uniform(rng, device, (c,), *scales)
            bias = _uniform(rng, device, (c,), -0.5, 0.5)
            for ratio in (0.8531, 1.0):
                for epilogue in epilogues:
                    args = (x, wk, scale, bias, ratio, 0.043, epilogue)
                    got = conv_int8.conv3x3_int8_exp(*args)
                    torch.cuda.synchronize()
                    ref = conv_int8.conv3x3_int8_exp_reference(*args)
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            'experiments\' conv kernel disagrees with its '
                            'plain version on {} {} in_ratio {} scales {}: '
                            '{} of {} elements differ'.format(
                                level, epilogue, ratio, scales,
                                int((got != ref).sum()), got.numel()))
                    conv_err[epilogue] = max(conv_err.get(epilogue, 0), int(
                        (got.int() - ref.int()).abs().max()))
                    if scales[0] == 1e-4:
                        conv_ms[(level, epilogue, ratio)] = (
                            _time_ms(lambda: conv_int8.conv3x3_int8_exp(
                                *args), reps=10),
                            _time_ms(lambda: conv_int8.
                                     conv3x3_int8_exp_reference(*args),
                                     reps=2, warmup=1))
        # yardsticks at the experiments' scales, f32 at in_ratio 0.8531
        args = (x, w_hwio, scale, bias, 0.8531, 0.043, 'f32')
        im2col_ms = _time_ms(lambda: _harness.im2col_conv_exp(*args),
                             reps=5)
        b2_ms = _time_ms(lambda: conv_int8.conv_int8(
            conv_int8.requant_input_reference(x, 0.8531), wk, scale, bias,
            (1, 1), (1, 1, 1, 1), 0.043), reps=5)
        patches = _harness.im2col_patches(x)
        w2d = w_hwio.reshape(9 * c, c)
        conv_lib[level] = _time_ms(lambda: torch._int_mm(patches, w2d),
                                   reps=10)
        for ratio in (0.8531, 1.0):
            print('exp conv kernel == plain on {} in_ratio {}: {}'.format(
                level, ratio, ', '.join(
                    '{} {:.4f} ms (plain {:.4f})'.format(
                        e, *conv_ms[(level, e, ratio)]) for e in epilogues)),
                flush=True)
        print('  yardsticks on {}: im2col + torch._int_mm + plain f32 '
              'epilogue {:.4f} ms, requant pass + B2 {:.4f} ms, torch._int_mm '
              'of the materialized patches alone {:.4f} ms'.format(
                  level, im2col_ms, b2_ms, conv_lib[level]), flush=True)
        del x, wk, w_hwio, got, ref, patches
        torch.cuda.empty_cache()

    gemm, gemm_err = {}, {}
    for m, k, n in ((65536, 1152, 1152), (38400, 2304, 256)):
        a = _int8_input(rng, device, (m, k))
        b = _int8_input(rng, device, (k, n))
        times = {}
        for requant in (None, 3e-4):
            got = gemm_int8.gemm_int8(a, b, requant)
            torch.cuda.synchronize()
            ref = gemm_int8.gemm_int8_reference(a, b, requant)
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                raise AssertionError(
                    'GEMM kernel disagrees with its plain version at {}x{}x{}'
                    ' ({}): {} of {} elements differ'.format(
                        m, k, n, 'int32' if requant is None else 'int8',
                        int((got != ref).sum()), got.numel()))
            gemm_err[(m, k, n)] = max(gemm_err.get((m, k, n), 0), int(
                (got.long() - ref.long()).abs().max()))
            times[requant] = (
                _time_ms(lambda: gemm_int8.gemm_int8(a, b, requant), reps=10),
                _time_ms(lambda: gemm_int8.gemm_int8_reference(a, b, requant),
                         reps=2, warmup=1))
            del got, ref
        lib_ms = _time_ms(lambda: torch._int_mm(a, b), reps=10)
        gemm[(m, k, n)] = (times, lib_ms)
        print('GEMM kernel == plain at {}x{}x{}: int32 {:.4f} ms (plain '
              '{:.4f}), fused int8 {:.4f} ms (plain {:.4f}); torch._int_mm '
              '{:.4f} ms'.format(m, k, n, *times[None], *times[3e-4], lib_ms),
              flush=True)
        del a, b
        torch.cuda.empty_cache()

    records = {}
    # conv: int8 x, w in, scale, bias; int8 out; 2 ops per int8 MAC
    pixels = 8 * 120 * 160
    conv_bound = _bound(pixels * 128 * 2 + 9 * 128 * 128 + 128 * 8,
                        2 * pixels * 128 * 128 * 9, INT8_OPS_PER_MS)
    for label in ('E1', 'E2', 'E3', 'E4'):
        name, source, replaces, (epilogue, ratio), _ = EXPERIMENTS[label]
        ms, plain_ms = conv_ms[('[8,120,160,128]', epilogue, ratio)]
        records[label] = {
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None,
            'max_abs_err': float(conv_err[epilogue]), 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': conv_bound[0],
            'bound_by': conv_bound[1],
            'library_ms': conv_lib['[8,120,160,128]']}
    for label, (m, k, n) in (('E5', (65536, 1152, 1152)),
                             ('E6', (38400, 2304, 256))):
        name, source, replaces, _, _ = EXPERIMENTS[label]
        times, lib_ms = gemm[(m, k, n)]
        bound = _bound(m * k + k * n + m * n * 4, 2.0 * m * k * n,
                       INT8_OPS_PER_MS)
        records[label] = {
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None,
            'max_abs_err': float(gemm_err[(m, k, n)]), 'ms': times[None][0], 'plain_ms': times[None][1],
            'bound_ms': bound[0], 'bound_by': bound[1], 'library_ms': lib_ms}
    fused_bound = _bound(65536 * 1152 * 2 + 1152 * 1152,
                         2.0 * 65536 * 1152 * 1152, INT8_OPS_PER_MS)
    print('experiment bounds: conv 3x3 [8,120,160,128]->128 {:.4f} ms ({}); '
          'GEMM 65536x1152x1152 int32 {:.4f} ms ({}), fused int8 {:.4f} ms '
          '({}); 38400x2304x256 int32 {:.4f} ms ({}); library call: '
          'torch._int_mm (for the conv: of the materialized im2col patches, '
          'no epilogue)'.format(
              conv_bound[0], conv_bound[1], records['E5']['bound_ms'],
              records['E5']['bound_by'], fused_bound[0], fused_bound[1],
              records['E6']['bound_ms'], records['E6']['bound_by']),
          flush=True)
    return records


def phase_experiments():
    """The six experiment entry points through main() at batch 8; returns
    {label: launches of its kernel}."""

    import importlib

    import torch

    from megadetector_tpu_torch.experiments import _harness
    from megadetector_tpu_torch.ops import (bottleneck_int8, cuda_nms,
                                            l0_fused, silu_bf16)

    launches = {}
    for label, (_, source, _, _, module_name) in EXPERIMENTS.items():
        module = importlib.import_module(
            'megadetector_tpu_torch.experiments.' + module_name)
        kernel = 'gemm_int8' if source == GEMM_SOURCE else 'conv3x3_int8_exp'
        _reset_counts()
        result = module.main(['--batch', '8', '--chain', '2', '--iters', '2'])
        torch.cuda.synchronize()
        totals = _harness.launch_counts()
        others = (cuda_nms.launches, bottleneck_int8.launches,
                  l0_fused.launches, silu_bf16.launches)
        for rec in result['records']:
            want = {k: rec['calls'] * rec['expect'].get(k, 0)
                    for k in _harness.KERNELS}
            if rec['launches'] != want:
                raise AssertionError('{} {}: launches {}, expected {}'.format(
                    label, rec['name'], rec['launches'], want))
        summed = {k: sum(r['launches'][k] for r in result['records'])
                  for k in _harness.KERNELS}
        if summed != totals or any(others) or totals[kernel] == 0:
            raise AssertionError(
                '{}: launches {} in the run, {} in its variants, others {}'
                .format(label, totals, summed, others))
        launches[label] = totals[kernel]
        print('{} entry point {}: {} variants, launches {} (each variant '
              'exactly its declared kernels once per step)'.format(
                  label, module_name, len(result['records']), totals),
              flush=True)
    return launches


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this '
              'smoke run needs a CUDA card', file=sys.stderr)
        return 1

    from megadetector_tpu_torch.device import get_device, set_float32_exact
    from megadetector_tpu_torch.models.yolov5 import (YoloV5Config,
                                                      init_params)
    from megadetector_tpu_torch.ops import _build

    # 1. device
    device = get_device('cuda')
    set_float32_exact()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    import importlib.util
    print('device: torch {} CUDA {} python {}; {} (count {}); {}; cv2 {}'
          .format(torch.__version__, torch.version.cuda,
                  sys.version.split()[0], torch.cuda.get_device_name(0),
                  torch.cuda.device_count(), card,
                  'present' if importlib.util.find_spec('cv2')
                  else 'absent (numpy letterbox)'), flush=True)

    # 2. build
    start = time.time()
    _build.load_library()
    print('build: {:.1f} s (nvcc {:.1f} s) -> {}'.format(
        time.time() - start, _build.build_seconds or 0.0,
        os.path.relpath(_build.library_path())), flush=True)
    for line in _build.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'smem' in line:
            print('  ptxas: ' + line.strip())

    # 3. kernel vs plain
    record = phase_kernel(device)

    config = YoloV5Config('yolov5l6', num_classes=3)
    params = init_params(config, seed=0)
    with tempfile.TemporaryDirectory() as workdir:
        # 4. main path
        launches, e2e, device_rate, detector, buckets, float_path, pairs = \
            phase_main_path(device, workdir, config, params)
        record['launches'] = launches
        print('main path throughput on {}: {:.3f} images/s through '
              'load_and_run_detector_batch (host letterbox included), '
              '{:.3f} images/s through generate_detections_one_batch on '
              'letterboxed batches; 1280 px auto canvases, batch 8, '
              'float32'.format(card, e2e, device_rate), flush=True)
        batch, float_fwd = phase_breakdown(detector, buckets)

        # 5. card vs CPU
        phase_card_vs_cpu(detector, config, params)
        del detector
        torch.cuda.empty_cache()

        # 6. int8 kernels vs plain
        conv_record, bottleneck_record = phase_int8_kernels(device)

        # 7. int8 main path
        q_path, counts, rates, forward_ms, detector = phase_int8_main_path(
            device, workdir, float_path, pairs, batch)
        conv_record['launches'] = counts['xla'][0]
        bottleneck_record['launches'] = counts['pallas'][1]
        print('int8 main path throughput on {}: {:.3f} images/s '
              '(conv_backend xla), {:.3f} images/s (pallas) through '
              'load_and_run_detector_batch, float32 {:.3f}; forward per '
              '960x1280 batch of 8: int8 {:.3f} ms (xla), {:.3f} ms '
              '(pallas), float32 {:.3f} ms'.format(
                  card, rates['xla'], rates['pallas'], e2e,
                  forward_ms['xla'], forward_ms['pallas'], float_fwd),
              flush=True)

        # 8. int8 card vs CPU
        phase_int8_card_vs_cpu(q_path, detector)
        del detector
        torch.cuda.empty_cache()

        # 9. bf16 kernels vs plain
        stem_record, silu_record = phase_bf16_kernels(device, params)

        # 10. bf16 main path
        stem_launches, silu_launches, bf16_rate, bf16_fwd, detector = \
            phase_bf16_main_path(device, workdir, float_path, pairs, batch)
        stem_record['launches'] = stem_launches
        silu_record['launches'] = silu_launches

        # 11. int8 + bf16 main path
        int8_bf16_rates, int8_bf16_fwd = phase_int8_bf16_main_path(
            device, workdir, q_path, pairs, batch)

        # 12. device preprocessing
        device_rates = phase_device_preprocess(device, workdir, float_path,
                                               pairs)
        print('bf16 throughput on {}: {:.3f} images/s float bf16, {:.3f} / '
              '{:.3f} int8 + bf16 (xla / pallas), device preprocess {:.3f} '
              'float32 / {:.3f} bf16; forward per 960x1280 batch of 8: bf16 '
              '{:.3f} ms, int8 + bf16 {:.3f} / {:.3f} ms'.format(
                  card, bf16_rate, int8_bf16_rates['xla'],
                  int8_bf16_rates['pallas'], device_rates['float32'],
                  device_rates['bfloat16'], bf16_fwd, int8_bf16_fwd['xla'],
                  int8_bf16_fwd['pallas']), flush=True)

        # 13. bf16 card vs CPU
        phase_bf16_card_vs_cpu(detector, config, params)
        if '--profile' in sys.argv[1:]:
            phase_profile(detector, buckets)
        del detector
        torch.cuda.empty_cache()

    # 14. the experiments' kernels vs plain
    exp_records = phase_exp_kernels(device)

    # 15. the experiment entry points
    for label, n in phase_experiments().items():
        exp_records[label]['launches'] = n

    print(card)
    print(json.dumps({'kernels': [record, conv_record, bottleneck_record,
                                  stem_record, silu_record] +
                      [exp_records[label] for label in sorted(EXPERIMENTS)]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
