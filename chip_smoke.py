#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (megadetector_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

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
     order than the CPU, even with TF32 off).
Then one JSON line per kernel, and last the device line.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

NMS_SOURCE = 'megadetector_tpu_torch/csrc/nms.cu'
NMS_REPLACES = 'megadetector_tpu/ops/pallas_nms.py:26'


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
    return {'name': 'greedy_nms', 'route': 'cuda', 'source': NMS_SOURCE,
            'replaces': NMS_REPLACES, 'launches': None,
            'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms}


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


def phase_main_path(device, workdir, config, params):
    """The port's batch detection path on the card; returns
    (launches, images/s, detector)."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import (
        load_and_run_detector_batch, write_results_to_file)
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

    out_file = os.path.join(workdir, 'smoke_results.json')
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
    return launches, e2e, device_rate, detector, buckets


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

    # 4. main path
    config = YoloV5Config('yolov5l6', num_classes=3)
    params = init_params(config, seed=0)
    with tempfile.TemporaryDirectory() as workdir:
        launches, e2e, device_rate, detector, buckets = phase_main_path(
            device, workdir, config, params)
    record['launches'] = launches
    print('main path throughput on {}: {:.3f} images/s through '
          'load_and_run_detector_batch (host letterbox included), {:.3f} '
          'images/s through generate_detections_one_batch on letterboxed '
          'batches; 1280 px auto canvases, batch 8, float32'.format(
              card, e2e, device_rate), flush=True)
    phase_breakdown(detector, buckets)

    # 5. card vs CPU
    phase_card_vs_cpu(detector, config, params)

    print(card)
    print(json.dumps({'kernels': [record]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
