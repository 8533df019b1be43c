#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (megadetector_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: torch/CUDA versions and the card's name and power limit;
     TF32 off so float32 is float32;
  2. build: nvcc compiles megadetector_tpu_torch/csrc/*.cu; ptxas's
     register lines, and its C7520 / C7514 lines (a kernel whose wgmma it
     serialized), are printed: the GEMM kernel must have none;
  3. kernel vs plain: the greedy-NMS kernel against its plain PyTorch
     version on the card (B=8, K in 512/2048/8192, plus a suppression
     chain, exact duplicates and invalid slots); keep masks must be
     identical; ms per call of both, and the kernel's split between its
     mask pass and its sweep (torch.profiler, by kernel name);
  4. main path: yolov5l6 (MDv5a's architecture, nc=3, full width, random
     weights from seed 0) saved as .npz, load_detector on cuda,
     load_and_run_detector_batch over 16 synthetic 4:3 and 16:9 images
     (two auto canvases, batch 8), write_results_to_file; the MD JSON is
     checked and the NMS kernel's launch count must cover every device
     batch; images/s of a timed, replayed pass;
  5. card vs CPU: the same yolov5l6 forward on a 320 px batch of 2;
     heads agree to max |d| <= 1e-3 * max |ref| (cuDNN sums in another
     order than the CPU, even with TF32 off);
  6. int8 kernels vs plain on the card, at yolov5l6 shapes of a 960x1280
     canvas, batch 8: the conv kernel on l1's 3x3 s2 64->128, a 3x3 s1
     128->128 at 120x160 and a 1x1 512->256 at 120x160 (int32 and int8
     outputs), then on the most frequent shape of each chain-conv class
     (l1; a 3x3 s1 and a 1x1 per stride level, from the model's own
     geometry), with TOP/s and the share of the bound, and every one of
     the 130 chain convs' shapes timed alone, summed per forward, under
     the tiling ops/conv_int8.conv_tiling picks and under every other
     16-byte tiling (each held to the picked one's output); the
     bottleneck kernel on every distinct bottleneck shape of a 960x1280
     and a 768x1280 batch of 8 (C 64 to 512), with and without the
     residual, against its plain version and the unfused pair of conv
     kernels (residual in torch), with kernel and unfused ms, TOP/s, the
     bound's share, the tiling bottleneck_tiling picks or 'unfused', and
     the routed sum over each canvas's 42 bottlenecks; outputs must be
     identical; ms per call of both, and of torch._int_mm on the 1x1
     int32 case (the same function: the conv kernel's library
     yardstick);
  7. int8 main path: the port's quantize_checkpoint on phase 4's
     yolov5l6 (calibrated on two 320 px uniform images from
     RandomState(1)), load_detector on cuda with conv_backend xla, then
     pallas, load_and_run_detector_batch over the same 16 images and
     write_results_to_file; the MD JSON is checked, the conv kernel must
     launch once per chain conv of each of the two batches (260) under
     xla; under pallas the bottleneck kernel once per bottleneck that
     bottleneck_tiling fuses (r = 36 of 42 a batch at both canvases) and
     the conv kernel 260 - 4 r times; the two backends' detections must
     be identical; images/s of a timed, replayed pass of each, and both
     backends' forward ms side by side;
  8. card vs CPU, int8 forward at 320 px, batch 2: decoded obj*cls
     scores p99 |d| < 0.02 and xy p99 |d| < 2 px (the bounds of the JAX
     package's int8-vs-float test);
  9. bf16 kernels vs plain on the card at yolov5l6 shapes of a 960x1280
     batch of 8: the fused stem on u8 [8,960,1280,3] -> [8,480,640,64]
     with the model's l0 weights, the bf16 epilogue (bias + SiLU) on l1's
     output [8,128,240,320] and on a [8,1024,15,20] tensor, both
     channels_last; the epilogue must be bit-identical, the stem (whose
     tensor cores sum the taps in another order) within
     ops/l0_fused.plain_bar: 1 bf16 ulp or 1e-5, on at most 1e-3 of the
     elements, with the count that differs printed; ms of kernel, plain
     version and the library yardstick (cuDNN's bf16 conv of the
     normalized batch for the stem, F.silu for the epilogue);
 10. bf16 main path: phase 4's yolov5l6 with dtype bf16 through
     load_and_run_detector_batch over the same 16 images, batch 8; the
     stem must launch once per batch and the bf16 epilogue once per
     activated conv after l0 per batch; images/s of a replayed pass and the
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
     int8 range; the GEMM (E5, E6) at 65536x1152x1152, 38400x2304x256
     and 4096x2048x2048, int32 and fused int8, with each one's tiles,
     bound and share of the bound (of its device time, replayed from a
     CUDA graph); outputs must be identical; ms of kernel, plain version
     and the yardsticks (im2col + torch._int_mm + plain epilogue, requant
     pass + B2; torch._int_mm);
 15. the six experiment entry points (megadetector_tpu_torch/experiments)
     through their main() at batch 8 with a chain of 2: every variant
     launches exactly the kernels it declares, once per step;
 16. the program cache (models/program_cache.py), after phases 4, 7 (both
     backends) and 10: on a 960x1280 batch of 8 the program eager and
     replayed from its CUDA graphs must be identical; forward and
     selection + NMS ms eager and replayed, the whole program's wall ms
     both ways, the peak device memory; after phase 4 also the host copy
     of that batch, pageable against pinned;
 17. test-time augmentation, after phase 13: augment=True over the 16
     images for float32, int8 (pallas) and bf16, launches per TTA pass
     exact, replay identical to eager, the augment program's ms against
     the plain one's, TTA on the card against the CPU at 320 px;
 18. the folder run, after phase 17: 64 JPEGs written to disk (32 at
     1536x2048, 32 at 1080x1920, quality 90) through
     load_and_run_detector_batch's loader pool with yolov5l6 at 1280 px,
     batch 8: bf16 under thread 1/4/8, process 8 and, where g++ and
     jpeglib.h exist, the native loader in thread 8 and process 8; int8
     pallas and float32 under thread 8; a capture pass, then a timed
     replayed pass per mode; images/s beside the ceiling (the replayed
     program on the letterboxed batches in memory) and the host's CPU
     count; detections identical across the PIL modes, the native
     loader's geometry equal to PIL's and its canvases within 3 levels
     (mean < 0.5) with no image handed to PIL, and a rotated, a grayscale
     and a corrupt file as on the serial path in every mode;
 19. load_and_run_detector (bf16, batch 1) on two synthetic JPEGs: results
     equal to generate_detections_one_image, a rendered file each,
     launches exact (one device program an image);
 20. run_tiled_inference on two synthetic 4000x3000 JPEGs (24 tiles of
     1280x1280 each, three full batches of 8 on the square canvas) and a
     1024x768 one run whole, bf16 and int8 pallas: launches exact, the
     JSON equal to one assembled from generate_detections_one_batch on
     tiles cut with get_patch_boundaries, remapped and deduplicated with
     in_place_nms; a run interrupted at its second image and resumed from
     its checkpoint equal to an unbroken one; tiles/s and images/s;
 21. process_videos (bf16, frame_batch_size 8) on two 1920x1080 mp4v
     videos (30 fps, 60 and 45 frames) and a corrupt file, frame_sample 4
     and time_sample 0.5: frames_processed, launches exact, each frame's
     detections equal to generate_detections_one_batch on cv2's frames,
     the corrupt video a failure record, the file valid; frames/s; then
     process_video_folder_via_frames with the same frame numbers and
     frame rates. Phases 19-21 print the reserved memory after each run.
 22. the other detector families, at full width and depth with random
     weights from seed 0 (the port's init_params, saved as .npz with the
     JAX converter's metadata): yolov8l (the MDv1000 architecture, nc 3,
     1280 px auto canvases), rfdetr_base (image_size 560) and detr_base
     (image_size 448), each in float32 and bf16 through
     load_and_run_detector_batch over the 16 images at batch 8: an eager
     and a replayed pass, each with exact launches (NMS once per selection
     program; no int8 kernel, no stem; the bias + SiLU epilogue once per
     activated conv of yolov8l in bf16, counted from its config), their
     detections identical, the MD JSON checked; images/s of a replayed
     pass; forward and program ms eager and replayed on the family's 4:3
     batch of 8, peak memory; the card against the CPU on a uint8 batch
     of 2 at 256 px (yolov8l) or 224 px, rows matched by query (RF-DETR's
     top-Q tokens): float32 every query the same, within rtol 1e-4 and
     atol 1e-4 * max|ref|; bf16 no more queries missing and no larger
     errors than the CPU's bf16 against its float32, plus that atol; the
     largest differences printed.
     Phase 22's NMS and bias + SiLU launches join those kernels' records.
Phases 4, 7 and 10-12 count two passes over the images: the first runs
each program eagerly (its first call), the second captures the programs
into CUDA graphs and replays them; launches must be equal and detections
identical; images/s come from a third pass, all replays (the driver's
loader threads, whose images it takes in input order).
With --profile: torch.profiler over one device program on a 960x1280
batch of 8 (device time by kernel, idle share), int8 under both backends
in phase 7 and bf16 after phase 13, each replayed and eager; each window
runs the program twice and reads the second, and the port's kernels
there must show exactly the launches their wrappers counted.
Then one JSON line with every kernel's record (time, plain time, bound,
library yardstick, launches on the main path), and last the device line.
"""

import json
import os
import re
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

# The port's kernel functions (csrc/*.cu), for the profile's sums
PORT_KERNELS = ('nms_mask_kernel', 'nms_sweep_kernel', 'conv_int8_kernel',
                'bottleneck_int8_kernel', 'l0_fused_kernel',
                'silu_bf16_vec8_kernel', 'silu_bf16_kernel',
                'gemm_int8_kernel')

# The GEMM shapes of phase 14: E5's (M = 1024 x batch 64, K = N = 1152),
# E6's conv-as-matmul (M = 4800 x batch 8, K = 2304, N = 256) and E6's
# square-ish 4096x2048x2048
GEMM_SHAPES = ((65536, 1152, 1152), (38400, 2304, 256), (4096, 2048, 2048))

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


def _gemm_bound(m, k, n, requant):
    """_bound of [M, K] s8 @ [K, N] s8: a and b read once, the int32 (or,
    with a requant, int8) output written once, 2 MKN int8 operations."""

    out_bytes = 4 if requant is None else 1
    return _bound(m * k + k * n + m * n * out_bytes, 2.0 * m * k * n,
                  INT8_OPS_PER_MS)


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


def _graph_ms(fn, reps=10):
    """Mean device ms per call of fn(): [reps] calls captured in a CUDA
    graph and replayed (CUDA events), so the host's work per call (the
    wrapper's checks, allocations, tensor maps, launches) is not timed."""

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='relaxed'):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


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


def _nms_split(boxes, valid, thresh, reps=5):
    """(mask pass ms, sweep ms) per call of the NMS kernel, from
    torch.profiler's device time by kernel name; None where the profiler
    saw no device time."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from megadetector_tpu_torch.ops import cuda_nms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cuda_nms.greedy_nms_keep(boxes, valid, thresh)
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0.0))
        for name in ('nms_mask_kernel', 'nms_sweep_kernel'):
            if re.search(r'(^|[\s:]){}[<(]'.format(name), e.key):
                split[name] = split.get(name, 0.0) + us / 1e3 / reps
    if not split:
        return None
    return split.get('nms_mask_kernel', 0.0), split.get('nms_sweep_kernel',
                                                        0.0)


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
            split = _nms_split(boxes, valid, thresh)
            line += ('; mask pass {:.4f} ms, sweep {:.4f} ms (profiler)'
                     .format(*split) if split else
                     '; mask / sweep split not measured (the profiler saw no '
                     'device time)')
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
    from megadetector_tpu_torch.models.convert_weights import \
        save_checkpoint

    model_path = os.path.join(workdir, 'md_smoke_{}.npz'.format(config.arch))
    save_checkpoint(params, model_path, {
        'arch': config.arch, 'model_type': 'yolov5', 'num_classes': 3,
        'class_names': ['animal', 'person', 'vehicle'], 'image_size': 1280})
    detector = load_detector(model_path, detector_options={
        'pad_batches_to': 8}, device=device)

    rng = np.random.RandomState(1)
    pairs = [('smoke/img_{:02d}.jpg'.format(i), img)
             for i, img in enumerate(_synthetic_images(rng))]

    results, counts, batches, e2e = _eager_then_replayed(
        detector, pairs, 'float32 main path')
    launches = counts[0]

    n_det = _write_and_check(results, pairs, model_path,
                             os.path.join(workdir, 'smoke_results.json'))
    if batches < 2 or launches < batches:
        raise AssertionError('{} device batches but {} NMS kernel '
                             'launches'.format(batches, launches))
    truncated = sum(1 for im in results if 'pre_nms_truncation' in im)
    print('main path: 16 images, {} detections, {} device batches, {} NMS '
          'kernel launches, {} images past the 8192 capacity'.format(
              n_det, batches, launches, truncated), flush=True)

    # The device program alone on letterboxed batches (replayed)
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


def _conv_key(d):
    return (d['h'], d['w'], d['cin'], d['cout'], d['k'], d['stride'],
            d['pads'])


def _conv_classes(chain):
    """The int8 main path's chain convs by class: l1 (3x3 s2), then a 3x3
    s1 and a 1x1 at each stride level; {class: most frequent shape key}
    in forward order."""

    import collections

    members = {}
    for d in chain:
        if d['name'] == 'l1':
            order, name = (0, 0), 'l1 3x3 s2'
        elif d['stride'] == 1:
            level = 960 // d['h']
            order = (level, -d['k'])
            name = '{0}x{0} s1 at stride {1}'.format(d['k'], level)
        else:
            continue
        members.setdefault((order, name), []).append(_conv_key(d))
    return collections.OrderedDict(
        (name, collections.Counter(keys).most_common(1)[0][0])
        for (_, name), keys in sorted(members.items()))


def _conv_int8_ops(key, batch=8):
    """(bytes, operations) of one chain conv: x, w, scale and bias read
    once, the int8 output written once; 2 operations per int8 MAC."""

    h, w, cin, cout, k, stride, pads = key
    ho = (h + pads[0] + pads[1] - k) // stride + 1
    wo = (w + pads[2] + pads[3] - k) // stride + 1
    macs = batch * ho * wo * cout * k * k * cin
    return (batch * h * w * cin + cout * k * k * cin + 8 * cout +
            batch * ho * wo * cout, 2 * macs)


def _sweep_tilings(x, w, scale, bias, key):
    """Every 16-byte tiling of the conv kernel on one chain conv, each
    held to the wrapper's output and timed through the C entry point (no
    Python wrapper between launches: a 1x1 at 15x20 takes ~0.02 ms):
    (conv_tiling's pick, {(bm, bn, bk): ms}), printed."""

    import itertools

    import torch

    from megadetector_tpu_torch.ops import _build, conv_int8

    h, w_, cin, cout, k, stride, pads = key
    ho = (h + pads[0] + pads[1] - k) // stride + 1
    wo = (w_ + pads[2] + pads[3] - k) // stride + 1
    want = conv_int8.conv_int8(x, w, scale, bias, (stride, stride), pads,
                               0.02)
    out = torch.empty_like(want)
    lib = _build.load_library()
    times = {}
    for bm, bn, bk in itertools.product((64, 128), (64, 128), (64, 128)):
        if cin % bk:
            continue
        code = (conv_int8.INST_VEC16 |
                (conv_int8.INST_BK128 if bk == 128 else 0) |
                (conv_int8.INST_BM128 if bm == 128 else 0) |
                (conv_int8.INST_BN128 if bn == 128 else 0))

        def call():
            _build.check_launch(lib, lib.md_conv_int8(
                x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), 8, h, w_, cin, cout, k, k,
                stride, stride, pads[0], pads[2], ho, wo, 0.02, 1, code,
                torch.cuda.current_stream().cuda_stream), 'md_conv_int8')
        call()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError('conv tiling {} differs on {}'.format(
                (bm, bn, bk), key))
        times[(bm, bn, bk)] = _time_ms(call, reps=20)
    pick = tuple(conv_int8.conv_tiling(8 * ho * wo, cin, cout)[:3])
    print('  tilings of [8,{},{},{}]->{} {}x{} s{} (bm/bn/bk ms): {}; '
          'conv_tiling picks {}'.format(
              h, w_, cin, cout, k, k, stride, ', '.join(
                  '{}/{}/{} {:.4f}'.format(*t, ms)
                  for t, ms in sorted(times.items())), pick), flush=True)
    return pick, times


def _bottleneck_ops(key, batch=8):
    """(bytes, operations) of one bottleneck [batch, h, w, c]: x, w1, w2
    and the four float vectors read once, out written once; 10 C^2 MACs
    a pixel, 2 operations each."""

    h, w, c = key
    pixels = batch * h * w
    return pixels * c * 2 + 10 * c * c + 16 * c, 2 * pixels * 10 * c * c


def _bottleneck_counts(config, height, width, batch=8):
    """{(h, w, c): bottlenecks of that shape} of one [batch, height,
    width] forward, from the model's own geometry (each bottleneck's cv1
    is a 1x1 C->C)."""

    import collections

    from megadetector_tpu_torch.models.yolov5 import activated_conv_shapes

    return collections.Counter(
        (d['h'], d['w'], d['cin'])
        for d in activated_conv_shapes(config, height, width, batch)
        if '.m' in d['name'] and d['name'].endswith('cv1'))


def _fused_per_batch(config, canvases, batch=8):
    """Bottlenecks that routing (bottleneck_tiling) fuses in one batch at
    each canvas: {canvas: (fused, all)}."""

    from megadetector_tpu_torch.ops import bottleneck_int8

    out = {}
    for height, width in canvases:
        counts = _bottleneck_counts(config, height, width, batch)
        out[(height, width)] = (
            sum(n for (h, w, c), n in counts.items()
                if bottleneck_int8.bottleneck_tiling(batch, h, w, c)),
            sum(counts.values()))
    return out


def _bottleneck_shapes(rng, device, config):
    """The bottleneck kernel on every distinct yolov5l6 bottleneck shape of
    a 960x1280 and a 768x1280 batch of 8, with and without the residual:
    identical to its plain version and to the unfused pair of conv kernels
    (with the residual requant in torch); ms of both, the bound, the
    tiling bottleneck_tiling picks (or 'unfused'), and over the 42
    bottlenecks of each canvas the sum of the routed times. Returns
    ({(h, w, c): (kernel ms, plain ms or None)}, max |err|)."""

    import torch

    from megadetector_tpu_torch.ops import bottleneck_int8, conv_int8

    canvases = ((960, 1280), (768, 1280))
    counts = {hw: _bottleneck_counts(config, *hw) for hw in canvases}
    keys = sorted({k for cnt in counts.values() for k in cnt},
                  key=lambda k: (k[2], -k[0]))
    times, err = {}, 0
    for key in keys:
        h, w_, c = key
        x = _int8_input(rng, device, (8, h, w_, c))
        w1, s1, b1 = _int8_conv_case(rng, device, c, c, 1)
        w2, s2, b2 = _int8_conv_case(rng, device, c, c, 3)
        plain_h2 = bottleneck_int8.bottleneck_int8_reference(
            x, w1, s1, b1, 0.021, w2, s2, b2, 0.033, 0.007, False)[0]

        def unfused(shortcut):
            h1 = conv_int8.conv_int8(x, w1, s1, b1, (1, 1), (0, 0, 0, 0),
                                     0.021)
            h2 = conv_int8.conv_int8(h1, w2, s2, b2, (1, 1), (1, 1, 1, 1),
                                     0.033)
            if not shortcut:
                return h2
            return bottleneck_int8.residual_requant(x, 0.007, h2, 0.033)[0]
        for shortcut in (True, False):
            args = (x, w1, s1, b1, 0.021, w2, s2, b2, 0.033, 0.007,
                    shortcut)
            got, got_scale = bottleneck_int8.bottleneck_int8(*args)
            torch.cuda.synchronize()
            ref = plain_h2 if not shortcut else \
                bottleneck_int8.residual_requant(x, 0.007, plain_h2,
                                                 0.033)[0]
            err = max(err, int((got.long() - ref.long()).abs().max()))
            name = 'C={} [8,{},{}] shortcut={}'.format(c, h, w_, shortcut)
            if got_scale != ((0.007 + 0.033) if shortcut else 0.033) or \
                    not torch.equal(got, ref):
                raise AssertionError(
                    'bottleneck kernel disagrees with its plain version on '
                    '{}: {} of {} elements differ'.format(
                        name, int((got != ref).sum()), got.numel()))
            if not torch.equal(unfused(shortcut), got):
                raise AssertionError('fused and unfused kernels differ on '
                                     '{}'.format(name))
        args = (x, w1, s1, b1, 0.021, w2, s2, b2, 0.033, 0.007, True)
        ms = _time_ms(lambda: bottleneck_int8.bottleneck_int8(*args),
                      reps=20)
        unfused_ms = _time_ms(lambda: unfused(True), reps=20)
        plain_ms = None
        if key == (60, 80, 256):
            plain_ms = _time_ms(
                lambda: bottleneck_int8.bottleneck_int8_reference(*args),
                reps=2, warmup=1)
        times[key] = (ms, plain_ms, unfused_ms)
        n_bytes, n_ops = _bottleneck_ops(key)
        bound = _bound(n_bytes, n_ops, INT8_OPS_PER_MS)
        tiling = bottleneck_int8.bottleneck_tiling(8, h, w_, c)
        print('bottleneck kernel == plain == unfused conv pair (both '
              'residuals) on C={} [8,{},{}]: kernel {:.4f} ms ({:.1f} '
              'TOP/s, {:.3f} of the {:.4f} ms bound, {}), unfused {:.4f} ms'
              '{}; {} blocks; routed {}'.format(
                  c, h, w_, ms, n_ops / ms / 1e9, bound[0] / ms, bound[0],
                  bound[1], unfused_ms,
                  '' if plain_ms is None else
                  ', plain {:.4f} ms'.format(plain_ms),
                  bottleneck_int8.bottleneck_grid(8, h, w_),
                  'fused (bn {}, vec {})'.format(tiling.bn, tiling.vec)
                  if tiling else 'unfused'), flush=True)
        del x, w1, w2, got, ref, plain_h2
        torch.cuda.empty_cache()
    for hw, cnt in counts.items():
        routed = sum(n * (times[k][0] if bottleneck_int8.bottleneck_tiling(
            8, *k) else times[k][2]) for k, n in cnt.items())
        fused = sum(n * times[k][0] for k, n in cnt.items())
        unfused = sum(n * times[k][2] for k, n in cnt.items())
        print('bottleneck sum over the {} bottlenecks of a {}x{} batch of '
              '8, each shape timed alone: routed {:.3f} ms ({} fused), all '
              'fused {:.3f} ms, all unfused {:.3f} ms'.format(
                  sum(cnt.values()), hw[0], hw[1], routed,
                  sum(n for k, n in cnt.items()
                      if bottleneck_int8.bottleneck_tiling(8, *k)),
                  fused, unfused), flush=True)
    return {k: (v[0], v[1]) for k, v in times.items()}, err


def phase_int8_kernels(device, config):
    """Conv and bottleneck kernels vs their plain versions on the card at
    yolov5l6 shapes (960x1280 canvas, batch 8); returns their records."""

    import collections

    import numpy as np
    import torch

    from megadetector_tpu_torch.models.yolov5 import activated_conv_shapes
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
    conv_ms, conv_err = {}, 0
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
        n_bytes, n_ops = _conv_int8_ops(shape[1:3] + (shape[3], cout, k,
                                                      stride[0], pads))
        bound = _bound(n_bytes, n_ops, INT8_OPS_PER_MS)
        print('conv kernel == plain (int32 and int8) on {}: kernel {:.4f} '
              'ms ({:.1f} TOP/s, {:.3f} of the {:.4f} ms bound), plain '
              '{:.4f} ms per call'.format(name, ms, n_ops / ms / 1e9,
                                          bound[0] / ms, bound[0], plain_ms),
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
            # int32 out: 4 bytes an output instead of 1
            m_out = x2d.shape[0] * cout
            int32_bound = _bound(n_bytes + 3 * m_out - 8 * cout, n_ops,
                                 INT8_OPS_PER_MS)
            print('  int32 on {}: kernel {:.4f} ms ({:.1f} TOP/s, {:.3f} of '
                  'the {:.4f} ms bound, {}), torch._int_mm (same function, '
                  'identical) {:.4f} ms'.format(
                      name, int32_ms, n_ops / int32_ms / 1e9,
                      int32_bound[0] / int32_ms, int32_bound[0],
                      int32_bound[1], lib_ms), flush=True)
            del x2d, w2d, lib
        del x, w, got, ref
        torch.cuda.empty_cache()

    # Every chain conv shape of a 960x1280 batch of 8 (l0 stays float):
    # the kernel's ms per shape under every tiling, and per class TOP/s
    # and the bound's share after an identity check against the plain
    # version
    chain = activated_conv_shapes(config, 960, 1280, 8)[1:]
    counts = collections.Counter(_conv_key(d) for d in chain)
    classes = _conv_classes(chain)
    shape_ms, best_ms = {}, {}
    for key in counts:
        h, w_, cin, cout, k, stride, pads = key
        x = _int8_input(rng, device, (8, h, w_, cin))
        w, scale, bias = _int8_conv_case(rng, device, cin, cout, k)
        for name, class_key in classes.items():
            if class_key != key:
                continue
            got = conv_int8.conv_int8(x, w, scale, bias, (stride, stride),
                                      pads, 0.02)
            torch.cuda.synchronize()
            ref = conv_int8.conv_int8_reference(x, w, scale, bias,
                                                (stride, stride), pads, 0.02)
            conv_err = max(conv_err, int((got.long() - ref.long()).abs()
                                         .max()))
            if not torch.equal(got, ref):
                raise AssertionError(
                    'conv kernel disagrees with its plain version on the '
                    'class {} {}: {} of {} elements differ'.format(
                        name, key, int((got != ref).sum()), got.numel()))
        pick, times = _sweep_tilings(x, w, scale, bias, key)
        shape_ms[key] = times[pick]
        best_ms[key] = min(times.values())
        del x, w
    for name, key in classes.items():
        h, w_, cin, cout, k, stride, pads = key
        n_bytes, n_ops = _conv_int8_ops(key)
        bound = _bound(n_bytes, n_ops, INT8_OPS_PER_MS)
        ms = shape_ms[key]
        print('conv kernel == plain, class {} ({} of the 130 chain convs): '
              '[8,{},{},{}]->{} {}x{} s{}: {:.4f} ms, {:.1f} TOP/s, bound '
              '{:.4f} ms ({}), {:.3f} of the bound'.format(
                  name, counts[key], h, w_, cin, cout, k, k, stride, ms,
                  n_ops / ms / 1e9, bound[0], bound[1], bound[0] / ms),
              flush=True)
    total_ms = sum(counts[key] * ms for key, ms in shape_ms.items())
    total_ops = sum(counts[key] * _conv_int8_ops(key)[1] for key in counts)
    kinds = collections.OrderedDict()
    for key, ms in shape_ms.items():
        kind = '{0}x{0} s{1}'.format(key[4], key[5])
        n, t, ops = kinds.get(kind, (0, 0.0, 0))
        kinds[kind] = (n + counts[key], t + counts[key] * ms,
                       ops + counts[key] * _conv_int8_ops(key)[1])
    print('conv kernel over the 130 chain convs of one 960x1280 batch of 8 '
          '({} shapes, each timed alone at the tiling conv_tiling picks): '
          '{:.3f} ms, {:.1f} TOP/s ({}); at the best tiling of each shape '
          '{:.3f} ms'.format(
              len(counts), total_ms, total_ops / total_ms / 1e9, ', '.join(
                  '{} {} convs {:.3f} ms, {:.1f} TOP/s'.format(
                      kind, n, t, ops / t / 1e9)
                  for kind, (n, t, ops) in kinds.items()),
              sum(counts[key] * ms for key, ms in best_ms.items())),
          flush=True)
    torch.cuda.empty_cache()

    bottleneck_ms, bottleneck_err = _bottleneck_shapes(rng, device, config)

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
    ms, plain_ms = bottleneck_ms[(60, 80, 256)]
    fused_bound = _bound(*_bottleneck_ops((60, 80, 256)), INT8_OPS_PER_MS)
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


def _int8_launches(detector, backend):
    """The exact (conv, bottleneck) kernel launches of the int8 chain over
    the main path's two batches (a 960x1280 and a 768x1280 canvas): under
    pallas, r fused bottlenecks a batch (bottleneck_tiling) launch the
    bottleneck kernel r times and take 2 r convs off the conv kernel's 130
    a batch; under xla every chain conv runs the conv kernel. Returns
    (want, a note on the routing)."""

    from megadetector_tpu_torch.models.yolov5 import QConv

    n_qconv = sum(isinstance(m, QConv) for m in detector.model.modules())
    per_batch = _fused_per_batch(detector.config, ((960, 1280), (768, 1280)))
    fused = sum(r for r, _ in per_batch.values()) if backend != 'xla' else 0
    note = ', '.join('{}x{}: {} of {} bottlenecks fused'.format(
        h, w, r if backend != 'xla' else 0, n)
        for (h, w), (r, n) in per_batch.items())
    return (2 * n_qconv - 2 * fused, fused), note


def phase_int8_main_path(device, workdir, float_path, pairs, batch,
                         profile=False):
    """The int8 chain through the port's entry points on the card, under
    both conv backends, and the forward's CUDA-event ms on [batch] (one
    960x1280 batch of 8); returns (int8 checkpoint path, {backend: (conv
    launches, bottleneck launches)}, {backend: images/s}, {backend:
    forward ms}, last detector)."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.models.convert_weights import \
        quantize_checkpoint

    q_path = os.path.join(workdir, 'md_smoke_int8.npz')
    start = time.time()
    calib = np.random.RandomState(1).uniform(
        0, 1, (2, 320, 320, 3)).astype(np.float32)
    quantize_checkpoint(float_path, q_path, calibration_images=calib,
                        device=device)
    print('int8 checkpoint: quantize_checkpoint calibrated on the card in '
          '{:.1f} s'.format(time.time() - start), flush=True)

    launches, rates, forward_ms, detections = {}, {}, {}, {}
    for backend in ('xla', 'pallas'):
        torch.cuda.reset_peak_memory_stats()
        detector = load_detector(q_path, device=device, detector_options={
            'pad_batches_to': 8, 'conv_backend': backend})
        want, routing = _int8_launches(detector, backend)

        results, counts, batches, rates[backend] = _eager_then_replayed(
            detector, pairs, 'int8 {}'.format(backend))
        got = counts[1:3]
        if batches != 2 or got != want:
            raise AssertionError(
                'int8 {}: {} batches (want 2), kernel launches (conv, '
                'bottleneck) {}, expected {} ({})'.format(
                    backend, batches, got, want, routing))
        launches[backend] = got
        n_det = _write_and_check(results, pairs, q_path, os.path.join(
            workdir, 'smoke_int8_{}.json'.format(backend)))
        detections[backend] = results
        with torch.inference_mode():
            x = torch.from_numpy(batch).to(device).float() / 255.0
            forward_ms[backend] = _time_ms(
                lambda: detector.model(x, decode=False), reps=5)
        print('int8 main path, conv_backend={}: 16 images, {} detections, '
              '{} device batches; conv kernel {} launches, bottleneck '
              'kernel {} ({}); {:.3f} images/s through '
              'load_and_run_detector_batch (third pass, replayed); forward '
              '{:.3f} ms per 960x1280 batch of 8 (eager)'.format(
                  backend, n_det, batches, got[0], got[1], routing,
                  rates[backend], forward_ms[backend]), flush=True)
        phase_program_cache(detector, batch, 'int8 ' + backend)
        if profile:
            _profile_both(detector, batch, 'int8 ' + backend)
    if detections['xla'] != detections['pallas']:
        raise AssertionError('int8 detections differ between the conv '
                             'backends')
    print('int8 detections identical under conv_backend xla and pallas',
          flush=True)
    return q_path, launches, rates, forward_ms, detector


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
    if tuple(got.shape) != (8, 480, 640, 64):
        raise AssertionError('stem kernel shape {}'.format(tuple(got.shape)))
    stem_differ, stem_err, stem_outside = l0_fused.plain_bar(got, ref)
    if stem_outside or stem_differ > l0_fused.DIFF_SHARE * got.numel():
        raise AssertionError(
            'stem kernel outside its bar against the plain version: {} of {} '
            'elements differ (at most {:g} allowed), {} by more than 1 bf16 '
            'ulp and {:g}; max |d| {:.3e}'.format(
                stem_differ, got.numel(), l0_fused.DIFF_SHARE * got.numel(),
                stem_outside, l0_fused.ABS_FLOOR, stem_err))
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
    print('stem kernel within its bar of plain on u8 [8,960,1280,3] -> '
          '[8,480,640,64] bf16: {} of {} elements differ ({:.2e}; max |d| '
          '{:.3e}, none beyond 1 bf16 ulp or {:g}); kernel {:.4f} ms, plain '
          '{:.4f} ms, cuDNN bf16 conv of the normalized batch {:.4f} ms, '
          'bound {:.4f} ms ({}; {:.1f} G MAC)'.format(
              stem_differ, got.numel(), stem_differ / got.numel(), stem_err,
              l0_fused.ABS_FLOOR, stem_ms, stem_plain_ms, stem_lib_ms,
              stem_bound[0], stem_bound[1], macs / 1e9), flush=True)
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


def _eager_then_replayed(detector, pairs, label):
    """
    load_and_run_detector_batch over [pairs] at batch 8, three times. The
    first pass is each program's first call (eager), the second captures
    every program into a CUDA graph and replays it, and both are counted:
    their kernel launches (_counts) and device batches must be equal and
    their results identical. The third pass, all replays, is timed.
    Returns (results, launches, device batches, images/s of the third).
    """

    import torch

    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch

    passes = []
    for _ in range(2):
        detector.programs_run = 0
        _reset_counts()
        results = load_and_run_detector_batch(detector, pairs, batch_size=8,
                                              quiet=True)
        passes.append((results, _counts(), detector.programs_run))
    (eager, eager_counts, batches), (replayed, counts, replayed_batches) = \
        passes
    if (counts, replayed_batches) != (eager_counts, batches):
        raise AssertionError(
            '{}: launches (nms, conv, bottleneck, stem, silu) and batches '
            'eager {} {}, replayed {} {}'.format(
                label, eager_counts, batches, counts, replayed_batches))
    if replayed != eager:
        raise AssertionError('{}: the replayed programs\' detections differ '
                             'from the eager programs\''.format(label))
    if detector._programs.replays == 0:
        raise AssertionError('{}: no program was replayed'.format(label))
    start = time.time()
    load_and_run_detector_batch(detector, pairs, batch_size=8, quiet=True)
    torch.cuda.synchronize()
    rate = len(pairs) / (time.time() - start)
    print('{}: replayed programs identical to eager over {} images ({} '
          'graphs captured, {} replays); launches equal in both passes'
          .format(label, len(pairs), detector._programs.captures,
                  detector._programs.replays), flush=True)
    return eager, eager_counts, batches, rate


def _copy_ms(batch):
    """(pageable, pinned) ms of the host -> device copy of [batch]."""

    import torch

    pageable = torch.from_numpy(batch)
    pinned = torch.empty(pageable.shape, dtype=pageable.dtype,
                         pin_memory=True)
    pinned.copy_(pageable)
    dst = torch.empty(pageable.shape, dtype=pageable.dtype, device='cuda')
    return (_time_ms(lambda: dst.copy_(pageable), reps=10),
            _time_ms(lambda: dst.copy_(pinned, non_blocking=True), reps=10))


def phase_program_cache(detector, batch, label):
    """
    16. The program cache on [batch] (a 960x1280 batch of 8; phase 22
    gives each family's own canvas), after the configuration's main path:
    the device program eager (_cuda_graphs off) and replayed must give
    identical outputs at the same capacity; CUDA-event ms of the forward
    and of selection + NMS at that capacity, eager and replayed (the graph
    alone); wall ms of the whole program (copy in, escalation read,
    outputs read) both ways; the peak device memory since the
    configuration's detector was loaded. Returns those numbers.
    """

    import numpy as np
    import torch

    b, h, w = batch.shape[:3]
    detector._cuda_graphs = False
    eager, topk = detector.run_program(batch, 0.005, 0.45)
    detector._cuda_graphs = True
    for _ in range(3):
        replayed, capacity = detector.run_program(batch, 0.005, 0.45)
        if capacity != topk or sorted(replayed) != sorted(eager) or any(
                not np.array_equal(replayed[k], eager[k]) for k in eager):
            raise AssertionError('{}: the replayed program differs from '
                                 'the eager one'.format(label))

    def program_ms(graphs, reps=5):
        detector._cuda_graphs = graphs
        detector.run_program(batch, 0.005, 0.45)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            detector.run_program(batch, 0.005, 0.45)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3 / reps

    key = ('forward', b, h, w, detector._fused_decode)
    forward = detector._programs.entries[key]
    select = detector._programs.entries[key + ('select', topk, 0.005, 0.45)]
    x = torch.from_numpy(batch).to(detector.device)
    with torch.inference_mode():
        heads = detector._forward(x)
        numbers = {
            'forward_eager': _time_ms(lambda: detector._forward(x), reps=5),
            'forward_replay': _time_ms(forward.graph.replay, reps=5),
            'select_eager': _time_ms(lambda: detector._select_and_suppress(
                topk, 0.005, 0.45, *heads), reps=5),
            'select_replay': _time_ms(select.graph.replay, reps=5)}
    del heads, x
    numbers['program_eager'] = program_ms(False)
    numbers['program_replay'] = program_ms(True)
    numbers['peak_allocated_gb'] = torch.cuda.max_memory_allocated() / 1e9
    numbers['peak_reserved_gb'] = torch.cuda.max_memory_reserved() / 1e9
    print('program cache, {}, {}x{} batch of {} (capacity {}): replay '
          'identical to eager; forward {:.3f} ms eager, {:.3f} replayed; '
          'select + NMS {:.3f} / {:.3f}; whole program (copy in, reads) '
          '{:.3f} ms eager, {:.3f} replayed; {} graphs; peak device memory '
          '{:.2f} GB allocated, {:.2f} GB reserved'.format(
              label, h, w, b, topk, numbers['forward_eager'],
              numbers['forward_replay'], numbers['select_eager'],
              numbers['select_replay'], numbers['program_eager'],
              numbers['program_replay'], detector._programs.captures,
              numbers['peak_allocated_gb'], numbers['peak_reserved_gb']),
          flush=True)
    return numbers


def _pass_launches(detector):
    """Per-model-call launch deltas of an eager program (forward hooks on
    the network; a replay runs no hook)."""

    from megadetector_tpu_torch.models import program_cache

    calls = []
    before = []

    def pre(module, inputs):
        before.append(program_cache.read_counters())

    def post(module, inputs, output):
        calls.append([a - b for a, b in zip(program_cache.read_counters(),
                                            before.pop())])

    hooks = [detector.model.register_forward_pre_hook(pre),
             detector.model.register_forward_hook(post)]
    return calls, hooks


def phase_tta(device, workdir, float_path, q_path, pairs, batch,
              canvases=((960, 1280), (768, 1280))):
    """
    17. Test-time augmentation: augment=True through
    load_and_run_detector_batch over the 16 images, yolov5l6 at full
    width, float32, int8 under pallas and bf16: an eager pass whose model
    calls are counted pass by pass (each kernel's launches per TTA pass
    exact: NMS once a batch on the merged candidates; the int8 kernels per
    pass canvas as routing fuses; the stem on pass 1 only, the bf16
    epilogue after every activated conv but pass 1's l0), then a replayed
    pass with the same launches and identical detections; the MD JSON is
    checked; wall ms of the augment program against the plain program on
    [batch], both replayed; then TTA on the card against the CPU at 320
    px, batch 2, within phase 5's bar (float32) and phases 8 and 13's
    (int8, bf16). [canvases]: the canvases of [pairs]' two batches, in the
    order they run.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch
    from megadetector_tpu_torch.models.detector import (
        tta_concatenated_predictions, tta_passes)
    from megadetector_tpu_torch.models.yolov5 import QConv

    configs = (('float32', float_path, {}),
               ('int8 pallas', q_path, {'conv_backend': 'pallas'}),
               ('bf16', float_path, {'dtype': 'bfloat16'}))
    ms = {}
    for label, path, options in configs:
        torch.cuda.reset_peak_memory_stats()
        detector = load_detector(path, device=device, detector_options=dict(
            options, pad_batches_to=8))
        model = detector.model
        n_qconv = sum(isinstance(m, QConv) for m in model.modules())
        n_act = _n_activated_convs(model)
        # Expected launches a model call, by pass canvas: (nms, conv,
        # bottleneck, stem, silu)
        want = {}
        for h, w in canvases:
            for i, (_, _, _, _, ph, pw) in enumerate(
                    tta_passes(h, w, detector.letterbox_stride)):
                fused = 0
                if label.startswith('int8'):
                    fused = _fused_per_batch(detector.config,
                                             ((ph, pw),))[(ph, pw)][0]
                bf16 = label == 'bf16'
                want[(h, w, i)] = (
                    0, n_qconv - 2 * fused, fused, int(bf16 and i == 0),
                    (n_act - (i == 0)) if bf16 else 0)
        calls, hooks = _pass_launches(detector)
        detector.programs_run = 0
        _reset_counts()
        eager = load_and_run_detector_batch(detector, pairs, batch_size=8,
                                            quiet=True, augment=True)
        eager_counts = _counts()
        for hook in hooks:
            hook.remove()
        got = [tuple(c[i] for i in (0, 1, 3, 4, 5)) for c in calls]
        expected = [want[(h, w, i)] for h, w in canvases for i in range(3)]
        if detector.programs_run != 2 or got != expected or \
                eager_counts[0] != 2:
            raise AssertionError(
                'TTA {}: {} programs; launches per pass (nms, conv, '
                'bottleneck, stem, silu) {}, expected {}; NMS {}'.format(
                    label, detector.programs_run, got, expected,
                    eager_counts[0]))
        _reset_counts()
        replayed = load_and_run_detector_batch(detector, pairs, batch_size=8,
                                               quiet=True, augment=True)
        if _counts() != eager_counts or replayed != eager:
            raise AssertionError('TTA {}: replayed launches {} vs eager {}, '
                                 'or detections differ'.format(
                                     label, _counts(), eager_counts))
        n_det = _write_and_check(eager, pairs, path, os.path.join(
            workdir, 'smoke_tta_{}.json'.format(label.replace(' ', '_'))))

        def wall(augment, reps=3):
            detector.run_program(batch, 0.005, 0.45, augment=augment)
            detector.run_program(batch, 0.005, 0.45, augment=augment)
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(reps):
                detector.run_program(batch, 0.005, 0.45, augment=augment)
            torch.cuda.synchronize()
            return (time.perf_counter() - start) * 1e3 / reps

        ms[label] = (wall(True), wall(False))
        print('TTA {}: 16 images, {} detections, 2 augment programs; '
              'launches per pass (nms, conv, bottleneck, stem, silu) at '
              '{}x{}: {}, at {}x{}: {}, NMS once a batch; replayed identical '
              'to eager; augment program {:.3f} ms, plain program {:.3f} ms '
              '(x{:.2f}) on a {}x{} batch of {}, replayed; peak device '
              'memory {:.2f} GB allocated, {:.2f} GB reserved'.format(
                  label, n_det, *canvases[0], expected[:3], *canvases[1],
                  expected[3:], ms[label][0],
                  ms[label][1], ms[label][0] / ms[label][1],
                  *batch.shape[1:3], batch.shape[0],
                  torch.cuda.max_memory_allocated() / 1e9,
                  torch.cuda.max_memory_reserved() / 1e9), flush=True)

        # Card against the CPU at 320 px, batch 2
        x = torch.from_numpy(np.random.RandomState(2).randint(
            0, 256, (2, 320, 320, 3), dtype=np.uint8))
        cpu = load_detector(path, device='cpu', detector_options=options)
        dtype = detector.compute_dtype
        with torch.inference_mode():
            ref = tta_concatenated_predictions(
                detector.config, cpu.model, x, 320, 320, 64, dtype).numpy()
            got_pred = tta_concatenated_predictions(
                detector.config, model, x.to(device), 320, 320, 64,
                dtype).cpu().numpy()
        if got_pred.shape != ref.shape or not np.isfinite(got_pred).all():
            raise AssertionError('TTA {} card vs CPU: shape {} vs {} or '
                                 'non-finite'.format(label, got_pred.shape,
                                                     ref.shape))
        score = (lambda p: p[..., 4:5] * p[..., 5:])
        d_score = np.abs(score(got_pred) - score(ref))
        d_xy = np.abs(got_pred[..., :2] - ref[..., :2])
        if label == 'float32':
            worst = max(d_score.max() / np.abs(score(ref)).max(),
                        d_xy.max() / np.abs(ref[..., :2]).max())
            if worst > 1e-3:
                raise AssertionError('TTA float32 card vs CPU: max |d| / '
                                     'max |ref| {} (limit 1e-3)'.format(worst))
            note = 'max |d| / max |ref| {:.3e} (limit 1e-3)'.format(worst)
        else:
            p_score = np.percentile(d_score, 99)
            p_xy = np.percentile(d_xy, 99)
            if not (p_score < 0.02 and p_xy < 2.0):
                raise AssertionError('TTA {} card vs CPU: score p99 {} '
                                     '(limit 0.02), xy p99 {} px (limit 2)'
                                     .format(label, p_score, p_xy))
            note = 'score p99 |d| {:.3e} (limit 0.02), xy p99 |d| {:.3e} ' \
                'px (limit 2)'.format(p_score, p_xy)
        print('TTA {} card vs CPU at 320 px, batch 2 (decoded, three '
              'passes): {}'.format(label, note), flush=True)
        del detector, model, cpu
        torch.cuda.empty_cache()


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

    torch.cuda.reset_peak_memory_stats()
    detector = load_detector(float_path, device=device, detector_options={
        'pad_batches_to': 8, 'dtype': 'bfloat16'})
    n_epilogue = _n_activated_convs(detector.model) - 1
    results, counts, batches, rate = _eager_then_replayed(
        detector, pairs, 'bf16 main path')
    nms, conv, fused, stem, silu = counts
    if batches < 2 or stem != batches or silu != n_epilogue * batches or \
            nms < batches or conv or fused:
        raise AssertionError(
            'bf16 main path: {} batches; launches nms {}, stem {} (want {}), '
            'bf16 epilogue {} (want {} x {}), int8 {} {}'.format(
                batches, nms, stem, batches, silu, n_epilogue, batches, conv,
                fused))
    n_det = _write_and_check(results, pairs, float_path, os.path.join(
        workdir, 'smoke_bf16.json'))
    fwd = _forward_ms(detector, batch)
    print('bf16 main path: 16 images, {} detections, {} device batches; stem '
          'kernel {} launches (1 x {}), bf16 epilogue {} ({} activated convs '
          'after l0 x {}), NMS {}; {:.3f} images/s through '
          'load_and_run_detector_batch (third pass, replayed); forward '
          '{:.3f} ms per 960x1280 batch of 8 (uint8 in, eager)'.format(
              n_det, batches, stem, batches, silu, n_epilogue, batches, nms,
              rate, fwd), flush=True)
    phase_program_cache(detector, batch, 'bf16')
    return stem, silu, rate, fwd, detector


def phase_int8_bf16_main_path(device, workdir, q_path, pairs, batch):
    """int8 with dtype bf16 (bf16 l0 and heads around the int8 chain)
    under both conv backends; returns {backend: images/s}, {backend:
    forward ms}."""

    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector

    rates, forward_ms, detections = {}, {}, {}
    for backend in ('xla', 'pallas'):
        detector = load_detector(q_path, device=device, detector_options={
            'pad_batches_to': 8, 'conv_backend': backend,
            'dtype': 'bfloat16'})
        (want_conv, want_fused), routing = _int8_launches(detector,
                                                          backend)
        results, counts, batches, rates[backend] = _eager_then_replayed(
            detector, pairs, 'int8 + bf16 {}'.format(backend))
        nms, conv, fused, stem, silu = counts
        if batches != 2 or (conv, fused, stem, silu) != (
                want_conv, want_fused, batches, 0) or nms < batches:
            raise AssertionError(
                'int8 + bf16 {}: {} batches (want 2); launches conv {} (want '
                '{}), bottleneck {} (want {}; {}), stem {}, bf16 epilogue {}'
                ', nms {}'.format(backend, batches, conv, want_conv, fused,
                                  want_fused, routing, stem, silu, nms))
        n_det = _write_and_check(results, pairs, q_path, os.path.join(
            workdir, 'smoke_int8_bf16_{}.json'.format(backend)))
        detections[backend] = results
        forward_ms[backend] = _forward_ms(detector, batch)
        print('int8 + bf16 main path, conv_backend={}: {} detections, {} '
              'batches; stem {} launches, conv {}, bottleneck {}, bf16 '
              'epilogue {}; {:.3f} images/s (third pass, replayed); forward '
              '{:.3f} ms per 960x1280 batch of 8 (eager)'.format(
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
        detector.identity_programs_run = 0
        results, counts, batches, rates[dtype] = _eager_then_replayed(
            detector, all_pairs, 'device preprocess {}'.format(dtype))
        nms, conv, fused, stem, silu = counts
        # The identity batch ran in both counted passes
        detector.identity_programs_run //= 2
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
        print('device preprocess, {}: 24 images, {} detections, {} batches '
              '({} on the identity path); bf16 epilogue {} launches, stem {}, '
              'NMS {}; {:.3f} images/s through load_and_run_detector_batch '
              '(third pass, replayed)'.format(dtype, n_det, batches,
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


def _profile_both(detector, batch, label):
    """phase_profile of the replayed program, then of the eager one."""

    phase_profile(detector, batch, label + ' (replayed)')
    detector._cuda_graphs = False
    try:
        phase_profile(detector, batch, label + ' (eager)')
    finally:
        detector._cuda_graphs = True


def phase_profile(detector, batch, label):
    """torch.profiler over one device program (forward, selection, NMS)
    on [batch] (a 960x1280 batch of 8): device time by kernel, the idle
    share, and the port's kernels, whose profiled launches must equal the
    launches their wrappers counted in that program.

    The window holds two runs of the program and only the second is read
    (the device activities that start inside its record_function range):
    in a process that has worked for minutes, the profiler drops the
    device activities of a window's first milliseconds (a one-kernel
    window records nothing; of two programs only the second one's stem
    and host-to-device copy), which is why earlier tables lacked the
    fused stem."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from megadetector_tpu_torch.ops import (bottleneck_int8, conv_int8,
                                            cuda_nms, l0_fused, silu_bf16)

    modules = {'nms_mask_kernel': cuda_nms, 'nms_sweep_kernel': cuda_nms,
               'conv_int8_kernel': conv_int8,
               'bottleneck_int8_kernel': bottleneck_int8,
               'l0_fused_kernel': l0_fused, 'silu_bf16': silu_bf16}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        detector.run_program(batch, 0.005, 0.45)
        torch.cuda.synchronize()
        before = {name: m.launches for name, m in modules.items()}
        with record_function('measured program'):
            start = time.time()
            detector.run_program(batch, 0.005, 0.45)
            torch.cuda.synchronize()
            wall_ms = (time.time() - start) * 1e3
    counted = {name: m.launches - before[name] for name, m in modules.items()}

    events = prof.events()
    window = next(e.time_range for e in events
                  if e.name == 'measured program' and
                  e.device_type == DeviceType.CPU)
    # Device activities (kernels, copies) of the measured program, by
    # name; the range's own device-side annotation and the profiler's
    # buffer requests are not work of it
    by_name = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and
                window.start <= e.time_range.start <= window.end and
                e.name != 'measured program' and
                not e.name.startswith('Activity Buffer')):
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    print('profile, {} device program on a 960x1280 batch of 8: wall '
          '{:.3f} ms (profiler on), device busy {:.3f} ms, idle share '
          '{:.3f}'.format(label, wall_ms, busy_ms, 1.0 - busy_ms / wall_ms),
          flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :16]:
        print('  {:>9.3f} ms  {:>5d} x  {}'.format(us / 1e3, n, name[:90]),
              flush=True)
    # The port's kernels, every instance of a template summed
    sums = {}
    for key, (us, n) in by_name.items():
        for name in PORT_KERNELS:
            if re.search(r'(^|[\s:]){}[<(]'.format(name), key):
                ms, count = sums.get(name, (0.0, 0))
                sums[name] = (ms + us / 1e3, count + n)
    print('  the port\'s kernels: {}'.format(', '.join(
        '{} {:.3f} ms over {} launches'.format(name, ms, n)
        for name, (ms, n) in sorted(sums.items()))), flush=True)
    # silu_bf16 launches one of its two kernels a call
    sums['silu_bf16'] = (0.0, sum(sums.get(name, (0.0, 0))[1] for name in (
        'silu_bf16_vec8_kernel', 'silu_bf16_kernel')))
    missing = {name: (n, sums.get(name, (0.0, 0))[1])
               for name, n in counted.items()
               if sums.get(name, (0.0, 0))[1] != n}
    if missing:
        raise AssertionError('{} profile: kernel launches counted vs '
                             'profiled {}'.format(label, missing))


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
    for m, k, n in GEMM_SHAPES:
        a = _int8_input(rng, device, (m, k))
        b = _int8_input(rng, device, (k, n))
        times, graph_ms = {}, {}
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
            graph_ms[requant] = _graph_ms(
                lambda: gemm_int8.gemm_int8(a, b, requant))
            del got, ref
        lib_ms = _time_ms(lambda: torch._int_mm(a, b), reps=10)
        gemm[(m, k, n)] = (times, lib_ms)
        bounds = {requant: _gemm_bound(m, k, n, requant)
                  for requant in (None, 3e-4)}
        tiling = gemm_int8.gemm_tiling(m, k, n)
        print('GEMM kernel == plain at {}x{}x{} ({} tiles of 128x128, grid '
              '{}), ms a call back to back (device ms replayed from a CUDA '
              'graph): int32 {:.4f} ({:.4f}; plain {:.4f}; bound {:.4f} ms '
              'of {}, share {:.3f} of the device ms), fused int8 {:.4f} '
              '({:.4f}; plain {:.4f}; bound {:.4f} ms of {}, share {:.3f}); '
              'torch._int_mm {:.4f} ms'.format(
                  m, k, n, tiling.tiles, tiling.grid, times[None][0],
                  graph_ms[None], times[None][1], *bounds[None],
                  bounds[None][0] / graph_ms[None], times[3e-4][0],
                  graph_ms[3e-4], times[3e-4][1], *bounds[3e-4],
                  bounds[3e-4][0] / graph_ms[3e-4], lib_ms), flush=True)
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
    for label, (m, k, n) in (('E5', GEMM_SHAPES[0]), ('E6', GEMM_SHAPES[1])):
        name, source, replaces, _, _ = EXPERIMENTS[label]
        times, lib_ms = gemm[(m, k, n)]
        bound = _gemm_bound(m, k, n, None)
        records[label] = {
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None,
            'max_abs_err': float(gemm_err[(m, k, n)]), 'ms': times[None][0], 'plain_ms': times[None][1],
            'bound_ms': bound[0], 'bound_by': bound[1], 'library_ms': lib_ms}
    fused_bound = _gemm_bound(*GEMM_SHAPES[0], 3e-4)
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


def _write_folder(folder, images, names, quality=90):
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    paths = []
    for img, name in zip(images, names):
        path = os.path.join(folder, name)
        Image.fromarray(img).save(path, quality=quality)
        paths.append(path)
    return paths


def _extra_folder(folder, rng):
    """One JPEG with EXIF orientation 6 (stored turned; 1536x2048 once
    rotated), one grayscale 1536x2048 JPEG and one file that is no
    JPEG: the native and PIL paths' rotation and failure cases. Returns
    the folder and the (height, width) both images load at."""

    import numpy as np
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    img = _synthetic_images(rng)[0]
    exif = Image.Exif()
    exif[274] = 6
    # PIL's orientation 6 turns the stored image by 270 degrees
    Image.fromarray(np.rot90(img, k=1).copy()).save(
        os.path.join(folder, 'rotated.jpg'), quality=90,
        exif=exif.tobytes())
    Image.fromarray(img[..., 1]).save(os.path.join(folder, 'gray.jpg'),
                                      quality=90)
    with open(os.path.join(folder, 'corrupt.jpg'), 'wb') as f:
        f.write(b'\xff\xd8 this is no jpeg')
    return folder, img.shape[:2]


def _folder_run_costs(detector, folder, buckets, infos, ceiling):
    """Where phase 18's bf16 time goes, each printed: the ceiling's batch
    against run_program alone (the rest is the host's stack and MD
    emission), thread x8 with cv2's own thread pool cut to one thread,
    the 64 decoded images as in-memory pairs (letterbox only) on one and
    eight threads, a call's fixed cost against its cost an image (the
    folder once and three times over) in thread and process mode, and
    process mode's fixed costs (a spawned pool of 8 answering 64 trivial
    calls; a worker's imports; one image's info pickled)."""

    import multiprocessing
    import pickle
    from concurrent.futures import ProcessPoolExecutor

    import cv2
    import numpy as np
    import torch

    from megadetector_tpu_torch.detection import run_detector_batch as rdb

    canvas = max(buckets)
    batch = np.stack([info['img_processed'] for info in buckets[canvas][:8]])
    detector.run_program(batch, 0.005, 0.45)
    torch.cuda.synchronize()
    start = time.time()
    for _ in range(5):
        detector.run_program(batch, 0.005, 0.45)
    torch.cuda.synchronize()
    program_ms = (time.time() - start) * 1e3 / 5
    print('folder run bf16: ceiling {:.3f} ms a batch of 8 through '
          'generate_detections_one_batch; run_program alone (copy in, '
          'replayed program, reads) {:.3f} ms on a {}x{} batch'.format(
              8e3 / ceiling, program_ms, *canvas), flush=True)

    def rate(items, warm=True, **kwargs):
        if warm:
            rdb.load_and_run_detector_batch(detector, items, batch_size=8,
                                            quiet=True, **kwargs)
        torch.cuda.synchronize()
        start = time.time()
        rdb.load_and_run_detector_batch(detector, items, batch_size=8,
                                        quiet=True, **kwargs)
        torch.cuda.synchronize()
        return len(items) / (time.time() - start)

    cv2_threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        one = rate(folder, loader_workers=8)
    finally:
        cv2.setNumThreads(cv2_threads)
    print('folder run bf16, thread x8 with cv2.setNumThreads(1) (default '
          '{}; torch intra-op threads {}): {:.3f} images/s'.format(
              cv2_threads, torch.get_num_threads(), one), flush=True)
    pairs = [(info['file'], info['img_original']) for info in infos]
    print('folder run bf16, the 64 images decoded in memory (letterbox '
          'only): {:.3f} images/s on one loader thread, {:.3f} on '
          'eight'.format(rate(pairs, loader_workers=1),
                         rate(pairs, loader_workers=8)), flush=True)
    del pairs

    # A call's fixed cost against its cost an image: the folder three
    # times over (192 images) beside the 64
    paths = [info['file'] for info in infos]
    for label, kwargs in (('thread x8', dict(loader_workers=8)),
                          ('process x8', dict(loader_workers=8,
                                              loader_pool_type='process'))):
        t64 = len(paths) / rate(paths, warm=False, **kwargs)
        t192 = 3 * len(paths) / rate(paths * 3, warm=False, **kwargs)
        per_image = (t192 - t64) / (2 * len(paths))
        print('folder run bf16, {}: 64 images in {:.3f} s, 192 in {:.3f} '
              's: {:.3f} ms an image ({:.3f} images/s) after a fixed {:.3f} '
              's a call'.format(label, t64, t192, per_image * 1e3,
                                1 / per_image, t64 - len(paths) * per_image),
              flush=True)
    code = ('import time; t = time.time(); import numpy, cv2, PIL.Image; '
            'import megadetector_tpu_torch.detection._loader_worker; '
            'print(time.time() - t)')
    imports_s = float(subprocess.run(
        [sys.executable, '-c', code], capture_output=True, text=True,
        check=True).stdout.strip())
    start = time.time()
    with ProcessPoolExecutor(max_workers=8, mp_context=multiprocessing
                             .get_context('spawn')) as pool:
        list(pool.map(abs, range(64)))
    pool_s = time.time() - start
    blob = pickle.dumps(('x', infos[0], False), protocol=-1)
    start = time.time()
    for _ in range(5):
        pickle.loads(pickle.dumps(('x', infos[0], False), protocol=-1))
    trip_ms = (time.time() - start) * 1e3 / 5
    print('folder run: process mode\'s fixed costs: a spawned pool of 8 '
          'answering 64 trivial calls {:.3f} s; a worker\'s imports '
          '(numpy, cv2, PIL, _loader_worker) {:.3f} s; one {}x{} image\'s '
          'info pickles to {:.1f} MB (canvas and full-size original), '
          'pickled and loaded in {:.3f} ms'.format(
              pool_s, imports_s, *infos[0]['scaling_shape'][:2],
              len(blob) / 1e6, trip_ms), flush=True)


def phase_folder_run(device, workdir, float_path, q_path, card):
    """
    18. The folder run: 64 JPEGs (quality 90; 32 at 1536x2048, 32 at
    1080x1920, from _synthetic_images with seed 18: four full batches of
    8 per canvas, so no tail bucket depends on arrival order) on disk,
    through load_and_run_detector_batch with yolov5l6 at full width (1280
    px auto canvases, batch 8). bf16 under every loader mode (thread 1, 4
    and 8; process 8; native thread 8 and native process 8), int8 pallas
    and float32 under thread 8. Each mode runs a pass that captures the
    programs, then a timed pass that replays them (their detections must
    be identical); its images/s is printed beside the ceiling: the
    replayed program's images/s on the same canvases with the letterboxed
    batches already in memory. Checks: PIL-decode detections identical
    across thread 1/4/8 and process 8 (and native thread against native
    process); the native loader's geometry (target_shape, ratio, pad)
    equal to PIL's, its canvases within 3 levels of PIL's with a mean
    under 0.5, no image handed to PIL; a rotated, a grayscale and a
    corrupt file give the serial path's failures and sizes in every mode.
    The native sub-phase runs when g++ and jpeglib.h are present, and is
    skipped with the reason otherwise.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch import native
    from megadetector_tpu_torch.detection import _loader_worker
    from megadetector_tpu_torch.detection import run_detector_batch as rdb
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image

    rng = np.random.RandomState(18)
    images = [img for _ in range(4) for img in _synthetic_images(rng)]
    folder = os.path.join(workdir, 'folder')
    start = time.time()
    paths = _write_folder(folder, images,
                          ['img_{:02d}.jpg'.format(i)
                           for i in range(len(images))])
    extra, (extra_h, extra_w) = _extra_folder(
        os.path.join(workdir, 'extra'), rng)
    del images
    print('folder run: wrote {} JPEGs (quality 90) in {:.1f} s'.format(
        len(paths), time.time() - start), flush=True)

    problem = native.toolchain_problem()
    if problem is None:
        start = time.time()
        native.load_library()
        print('folder run: native JPEG loader built in {:.1f} s'.format(
            time.time() - start), flush=True)
    else:
        print('folder run: native sub-phase skipped: {}'.format(problem),
              flush=True)
    host = 'os.cpu_count() {}, sched_getaffinity {}'.format(
        os.cpu_count(), len(os.sched_getaffinity(0)))

    modes = [('thread x1', dict(loader_workers=1)),
             ('thread x4', dict(loader_workers=4)),
             ('thread x8', dict(loader_workers=8)),
             ('process x8', dict(loader_workers=8,
                                 loader_pool_type='process'))]
    if problem is None:
        modes += [('native thread x8', dict(loader_workers=8,
                                            use_native_loader=True)),
                  ('native process x8', dict(loader_workers=8,
                                             loader_pool_type='process',
                                             use_native_loader=True))]
    configs = [('bf16', float_path, {'dtype': 'bfloat16'}, modes),
               ('int8 pallas', q_path, {'conv_backend': 'pallas'},
                modes[2:3]),
               ('float32', float_path, {}, modes[2:3])]

    infos = None
    numbers = {}
    for label, path, options, config_modes in configs:
        detector = load_detector(path, device=device, detector_options=dict(
            options, pad_batches_to=8))
        if infos is None:
            # The ceiling's letterboxed batches, and the serial host cost
            start = time.time()
            infos = [detector.preprocess_image(np.asarray(load_image(p)),
                                               image_id=p) for p in paths]
            pil_ms = (time.time() - start) * 1e3 / len(paths)
            buckets = {}
            for info in infos:
                buckets.setdefault(tuple(info['target_shape']),
                                   []).append(info)
            if sorted(len(b) for b in buckets.values()) != [32, 32]:
                raise AssertionError('canvases of the 64 JPEGs: {}'.format(
                    {k: len(b) for k, b in buckets.items()}))
        results = {}
        for mode, kwargs in config_modes:
            rdb.native_fallbacks = 0
            capture = rdb.load_and_run_detector_batch(
                detector, folder, batch_size=8, quiet=True, **kwargs)
            torch.cuda.synchronize()
            start = time.time()
            timed = rdb.load_and_run_detector_batch(
                detector, folder, batch_size=8, quiet=True, **kwargs)
            torch.cuda.synchronize()
            rate = len(paths) / (time.time() - start)
            if timed != capture:
                raise AssertionError('folder run {} {}: the timed pass\'s '
                                     'detections differ from the capture '
                                     'pass\'s'.format(label, mode))
            if any('failure' in r for r in timed) or \
                    sorted(r['file'] for r in timed) != sorted(paths):
                raise AssertionError('folder run {} {}: failures or missing '
                                     'images'.format(label, mode))
            if kwargs.get('use_native_loader') and rdb.native_fallbacks:
                raise AssertionError('folder run {} {}: {} images fell back '
                                     'to PIL'.format(label, mode,
                                                     rdb.native_fallbacks))
            results[mode] = timed
            numbers[(label, mode)] = rate

        # The ceiling: the same canvases, letterboxed, replayed
        def ceiling_pass():
            for bucket in buckets.values():
                for i in range(0, len(bucket), 8):
                    detector.generate_detections_one_batch(
                        bucket[i:i + 8], detection_threshold=0.005)
            torch.cuda.synchronize()

        ceiling_pass()
        start = time.time()
        ceiling_pass()
        ceiling = len(infos) / (time.time() - start)
        for mode, _ in config_modes:
            rate = numbers[(label, mode)]
            print('folder run {} on {}, {}: {:.3f} images/s through '
                  'load_and_run_detector_batch over 64 JPEGs; ceiling '
                  '{:.3f} images/s (the replayed program on the letterboxed '
                  'batches in memory); share {:.3f}; host {}'.format(
                      label, card, mode, rate, ceiling, rate / ceiling,
                      host), flush=True)
        numbers[(label, 'ceiling')] = ceiling

        pil_modes = [m for m, _ in config_modes if 'native' not in m]
        for mode in pil_modes[1:]:
            if results[mode] != results[pil_modes[0]]:
                raise AssertionError('folder run {}: detections under {} '
                                     'differ from {}'.format(
                                         label, mode, pil_modes[0]))
        if 'native thread x8' in results and \
                results['native thread x8'] != results['native process x8']:
            raise AssertionError('folder run {}: native thread and process '
                                 'detections differ'.format(label))

        if label == 'bf16':
            # The rotated, grayscale and corrupt files in every mode
            def sizes(res):
                return sorted((os.path.basename(r['file']), r.get('failure'),
                               r.get('height'), r.get('width')) for r in res)

            serial = sizes(rdb.load_and_run_detector_batch(
                detector, extra, batch_size=8, quiet=True, loader_workers=1,
                include_image_size=True))
            want = [('corrupt.jpg', 'image access failure', None, None),
                    ('gray.jpg', None, extra_h, extra_w),
                    ('rotated.jpg', None, extra_h, extra_w)]
            if serial != want:
                raise AssertionError('extra files, serial: {}'.format(serial))
            for mode, kwargs in config_modes:
                got = sizes(rdb.load_and_run_detector_batch(
                    detector, extra, batch_size=8, quiet=True,
                    include_image_size=True, **kwargs))
                if got != serial:
                    raise AssertionError('extra files under {}: {} against '
                                         'the serial {}'.format(mode, got,
                                                                serial))
            print('folder run: the rotated, grayscale and corrupt files give '
                  'the serial path\'s failures and sizes under every mode; '
                  'PIL-decode detections identical across {}'.format(
                      ', '.join(pil_modes)), flush=True)
            _folder_run_costs(detector, folder, buckets, infos, ceiling)
            native_args = rdb._worker_args(detector, None, True)
        del detector
        torch.cuda.empty_cache()

    if problem is None:
        # The native loader's canvases against PIL's
        worst, mean_sum = 0, 0.0
        start = time.time()
        for info in infos:
            _, got, fell_back = _loader_worker.load_and_letterbox(
                (info['file'],) + native_args)
            if fell_back or isinstance(got, str):
                raise AssertionError('native loader: {} fell back'.format(
                    info['file']))
            if tuple(got['target_shape']) != tuple(info['target_shape']) or \
                    tuple(got['letterbox_ratio']) != \
                    tuple(info['letterbox_ratio']) or \
                    tuple(got['letterbox_pad']) != \
                    tuple(info['letterbox_pad']):
                raise AssertionError(
                    'native geometry of {}: {} {} {} against PIL\'s {} {} '
                    '{}'.format(info['file'], got['target_shape'],
                                got['letterbox_ratio'], got['letterbox_pad'],
                                info['target_shape'],
                                info['letterbox_ratio'],
                                info['letterbox_pad']))
            diff = np.abs(got['img_processed'].astype(np.int16) -
                          info['img_processed'].astype(np.int16))
            worst = max(worst, int(diff.max()))
            mean_sum += float(diff.mean())
        native_ms = (time.time() - start) * 1e3 / len(infos)
        mean = mean_sum / len(infos)
        if worst > 3 or mean >= 0.5:
            raise AssertionError('native canvases against PIL\'s: max |d| '
                                 '{}, mean {:.4f} (bars 3, 0.5)'.format(
                                     worst, mean))
        print('folder run: native loader geometry equal to PIL\'s on all 64 '
              'JPEGs, canvases max |d| {} mean {:.4f} (bars 3, 0.5); host '
              'ms per image on one thread: PIL decode + letterbox {:.1f}, '
              'native {:.1f}'.format(worst, mean, pil_ms, native_ms),
              flush=True)
    else:
        print('folder run: host ms per image on one thread: PIL decode + '
              'letterbox {:.1f}'.format(pil_ms), flush=True)
    return numbers


#%% Phases 19-21: the single-image, tiled and video entry points


def _select_calls(detector):
    """Selection + NMS programs run so far (each launches the NMS kernel
    once; escalation runs a second one in the same device program)."""

    return sum(entry.calls for key, entry in
               detector._programs.entries.items() if 'select' in key)


def _memory_line(label):
    """Print the reserved memory and the peak allocated since the last
    call (or since the phase began), then reset the peak."""

    import torch

    torch.cuda.synchronize()
    print('{}: {:.2f} GB reserved, {:.2f} GB peak allocated'.format(
        label, torch.cuda.memory_reserved() / 1e9,
        torch.cuda.max_memory_allocated() / 1e9), flush=True)
    torch.cuda.reset_peak_memory_stats()


def _counted(detector, fn):
    """fn() with the launch counters at 0 just before; returns (its
    value, (nms, conv, bottleneck, stem, silu), device programs run,
    selection programs run)."""

    programs, selects = detector.programs_run, _select_calls(detector)
    _reset_counts()
    out = fn()
    return (out, _counts(), detector.programs_run - programs,
            _select_calls(detector) - selects)


def _check_launches(label, detector, counts, programs, selects,
                    forwards):
    """The launches [forwards] implies, exactly: [forwards] is
    {(batch, height, width): device programs of that shape}. NMS once a
    selection program; under dtype bf16 the stem once and the epilogue
    once per activated conv after l0 a program; under the int8 chain with
    conv_backend pallas the bottleneck kernel once per bottleneck that
    bottleneck_tiling fuses and the conv kernel on every other chain
    conv."""

    import torch

    from megadetector_tpu_torch.models.yolov5 import QConv
    from megadetector_tpu_torch.ops import bottleneck_int8

    nms, conv, fused, stem, silu = counts
    n = sum(forwards.values())
    n_qconv = sum(isinstance(m, QConv) for m in detector.model.modules())
    bf16 = detector.compute_dtype == torch.bfloat16
    want_fused = 0
    if n_qconv and detector.conv_backend != 'xla':
        for (b, h, w), k in forwards.items():
            want_fused += k * sum(
                m for (bh, bw, c), m in _bottleneck_counts(
                    detector.config, h, w, b).items()
                if bottleneck_int8.bottleneck_tiling(b, bh, bw, c))
    want = (selects, n * n_qconv - 2 * want_fused, want_fused,
            n if bf16 else 0,
            n * (_n_activated_convs(detector.model) - 1)
            if bf16 and not n_qconv else 0)
    if programs != n or (nms, conv, fused, stem, silu) != want or \
            not n <= selects <= 2 * n:
        raise AssertionError(
            '{}: {} device programs (want {}), {} selection programs; '
            'launches (nms, conv, bottleneck, stem, silu) {}, want {}'
            .format(label, programs, n, selects, counts, want))
    print('{}: {} device programs {}, launches (nms, conv, bottleneck, '
          'stem, silu) {} as they imply ({} selection programs: NMS once '
          'each, escalation included)'.format(
              label, n, sorted(forwards.items()), counts, selects),
          flush=True)


def phase_single_image(device, workdir, float_path, card):
    """
    19. load_and_run_detector, the single-image driver, with yolov5l6 in
    bf16 (1280 px auto canvases, batch 1) on two synthetic JPEGs (1536x2048
    and 1080x1920): each image is one device program; its results equal
    generate_detections_one_image on the same decoded image, a rendered
    file exists for each, and the launches are exact.
    """

    import numpy as np

    from megadetector_tpu_torch.detection import run_detector
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image

    images = _synthetic_images(np.random.RandomState(19))[:2]
    files = _write_folder(os.path.join(workdir, 'single'), images,
                          ['single_{}.jpg'.format(i) for i in range(2)])
    out_dir = os.path.join(workdir, 'single_rendered')
    detector = run_detector.load_detector(float_path, device=device,
                                          detector_options={
                                              'dtype': 'bfloat16'})
    start = time.time()
    results, counts, programs, selects = _counted(
        detector, lambda: run_detector.load_and_run_detector(
            detector, files, out_dir))
    seconds = time.time() - start
    _check_launches('phase 19, load_and_run_detector', detector, counts,
                    programs, selects, {(1, 960, 1280): 1,
                                        (1, 768, 1280): 1})
    for path, r in zip(files, results):
        want = detector.generate_detections_one_image(
            load_image(path), path, detection_threshold=0.005)
        if r != want or not r['detections']:
            raise AssertionError('{}: load_and_run_detector gave {} '
                                 'detections, generate_detections_one_'
                                 'image {}'.format(
                                     path, len(r['detections'] or []),
                                     len(want['detections'] or [])))
        rendered = os.path.join(out_dir, os.path.splitext(
            os.path.basename(path))[0] + '_detections.jpg')
        if not os.path.isfile(rendered):
            raise AssertionError('no rendered file {}'.format(rendered))
    print('phase 19 on {}: load_and_run_detector (bf16, first calls, '
          'rendering included) {:.3f} s for 2 images, {} and {} '
          'detections; equal to generate_detections_one_image; 2 rendered '
          'files'.format(card, seconds, len(results[0]['detections']),
                         len(results[1]['detections'])), flush=True)
    _memory_line('phase 19')


def _large_image(rng, h, w):
    """A seeded uint8 image of [h, w]: gradients, blocks and noise, as
    _synthetic_images makes them."""

    import numpy as np

    yy = np.linspace(0, 255, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 255, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = xx
    img[..., 1] = yy
    img[..., 2] = 96
    for _ in range(24):
        y0, x0 = rng.randint(0, h - h // 8), rng.randint(0, w - w // 8)
        img[y0:y0 + h // 10, x0:x0 + w // 10] = rng.randint(0, 255, 3)
    img += rng.randint(-20, 20, (h, w, 1))
    return np.clip(img, 0, 255).astype(np.uint8)


def _tiled_reference(detector, folder, names, out_file):
    """
    What run_tiled_inference should write, assembled here: tiles cut with
    get_patch_boundaries (1280x1280, half overlap; an image smaller than a
    tile whole), generate_detections_one_batch on 8 at a time, each box
    remapped through pixels and rounded, then in_place_nms and
    write_results_to_file. Returns (the dict written, seconds spent in
    each step: decode, batches, remap, nms).
    """

    import torch

    import numpy as np

    from megadetector_tpu_torch.detection import run_detector_batch
    from megadetector_tpu_torch.detection.run_tiled_inference import (
        get_patch_boundaries, in_place_nms)
    from megadetector_tpu_torch.utils import ct_utils
    from megadetector_tpu_torch.visualization.visualization_utils import \
        load_image

    seconds = dict.fromkeys(('decode', 'batches', 'remap', 'nms'), 0.0)
    images = []
    for name in names:
        start = time.time()
        im = np.asarray(load_image(os.path.join(folder, name)))
        seconds['decode'] += time.time() - start
        h, w = im.shape[:2]
        if w < 1280 or h < 1280:
            tiles = [((0, 0), im)]
        else:
            tiles = [((x, y), im[y:y + 1280, x:x + 1280])
                     for x, y in get_patch_boundaries((w, h), (1280, 1280))]
        results = []
        start = time.time()
        for i in range(0, len(tiles), 8):
            results += detector.generate_detections_one_batch(
                [t for _, t in tiles[i:i + 8]],
                ['{}__{}'.format(name, j) for j in range(i, i + 8)][
                    :len(tiles[i:i + 8])], detection_threshold=0.005)
        torch.cuda.synchronize()
        seconds['batches'] += time.time() - start
        start = time.time()
        detections = []
        for ((x0, y0), tile), r in zip(tiles, results):
            th, tw = tile.shape[:2]
            for d in r['detections']:
                x, y, bw, bh = d['bbox']
                detections.append({
                    'category': d['category'],
                    'conf': ct_utils.round_float(d['conf'], 3),
                    'bbox': ct_utils.round_float_array(
                        [(x0 + x * tw) / w, (y0 + y * th) / h, bw * tw / w,
                         bh * th / h], 4)})
        images.append({'file': name, 'detections': detections})
        seconds['remap'] += time.time() - start
    start = time.time()
    in_place_nms({'images': images})
    seconds['nms'] = time.time() - start
    return run_detector_batch.write_results_to_file(images,
                                                    out_file), seconds


def phase_tiled(device, workdir, float_path, q_path, card):
    """
    20. run_tiled_inference with yolov5l6 (bf16, then int8 with
    conv_backend pallas) on two synthetic 4000x3000 JPEGs and one 1024x768
    JPEG: default 1280x1280 tiles at 0.5 overlap, 6 x 4 = 24 tiles an
    image in three full batches of 8 on the square canvas; the small image
    runs whole (batch 1, 960x1280 canvas). Launches exact; the JSON equals
    _tiled_reference's; a run interrupted at its second image and resumed
    from its checkpoint writes the unbroken run's JSON; tiles/s and
    images/s of a replayed run.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_tiled_inference import \
        run_tiled_inference

    rng = np.random.RandomState(20)
    folder = os.path.join(workdir, 'tiled')
    names = ['large_0.jpg', 'large_1.jpg', 'small.jpg']
    _write_folder(folder, [_large_image(rng, 3000, 4000),
                           _large_image(rng, 3000, 4000),
                           _large_image(rng, 768, 1024)], names)
    forwards = {(8, 1280, 1280): 6, (1, 960, 1280): 1}
    n_tiles = 6 * 8 + 1
    for label, path, options in (
            ('bf16', float_path, {'dtype': 'bfloat16'}),
            ('int8 pallas', q_path, {'conv_backend': 'pallas'})):
        detector = load_detector(path, device=device,
                                 detector_options=options)

        def run(out_name, **kwargs):
            return run_tiled_inference(
                detector, folder, None, os.path.join(workdir, out_name),
                **kwargs)

        first, counts, programs, selects = _counted(
            detector, lambda: run('tiled_first.json'))
        _check_launches('phase 20, tiled {}'.format(label), detector,
                        counts, programs, selects, forwards)
        want, parts = _tiled_reference(detector, folder, names,
                                       os.path.join(workdir,
                                                    'tiled_reference.json'))
        if first['images'] != want['images']:
            raise AssertionError('tiled {}: run_tiled_inference differs '
                                 'from the assembled reference'.format(
                                     label))
        n_det = [len(im['detections']) for im in first['images']]
        if not all(n_det):
            raise AssertionError('tiled {}: detections {}'.format(label,
                                                                  n_det))

        # Interrupted at the second image's first batch, then resumed
        checkpoint = os.path.join(workdir, 'tiled_checkpoint.json')
        real = detector.generate_detections_one_batch

        def interrupt(images, ids, **kwargs):
            if ids[0].startswith('large_1.jpg'):
                raise KeyboardInterrupt('interrupted')
            return real(images, ids, **kwargs)

        detector.generate_detections_one_batch = interrupt
        try:
            run('tiled_broken.json', checkpoint_path=checkpoint,
                checkpoint_frequency=1)
            raise AssertionError('the interrupted run ran to its end')
        except KeyboardInterrupt:
            pass
        finally:
            detector.generate_detections_one_batch = real
        with open(checkpoint) as f:
            saved = [im['file'] for im in json.load(f)['checkpoint']]
        resumed = run('tiled_resumed.json', checkpoint_path=checkpoint,
                      checkpoint_frequency=1)
        if saved != ['large_0.jpg'] or os.path.isfile(checkpoint) or \
                resumed['images'] != first['images']:
            raise AssertionError('tiled {}: checkpoint held {}; the resumed '
                                 'run differs from the unbroken one'.format(
                                     label, saved))

        torch.cuda.synchronize()
        start = time.time()
        timed = run('tiled_timed.json')
        torch.cuda.synchronize()
        seconds = time.time() - start
        if timed['images'] != first['images']:
            raise AssertionError('tiled {}: the replayed run differs'.format(
                label))
        print('phase 20 on {}: tiled {} equal to the assembled reference '
              '({} detections an image after NMS across tiles); resumed '
              'from a checkpoint after 1 image = unbroken; replayed run '
              '{:.3f} s: {:.3f} tiles/s, {:.3f} images/s ({} tiles, 3 '
              'images, decode included)'.format(
                  card, label, n_det, seconds, n_tiles / seconds,
                  3 / seconds, n_tiles), flush=True)
        print('phase 20, tiled {}: where a replayed run\'s time goes (the '
              'reference\'s steps, s): JPEG decode {:.3f}, the 7 batches '
              'through generate_detections_one_batch {:.3f} ({:.1f} ms a '
              'full batch of 8 tiles), remap {:.3f}, NMS across tiles '
              '{:.3f}'.format(label, parts['decode'], parts['batches'],
                              1e3 * parts['batches'] / 7, parts['remap'],
                              parts['nms']), flush=True)
        _memory_line('phase 20, tiled {}'.format(label))
        del detector
        torch.cuda.empty_cache()


def _write_videos(folder, rng):
    """Two 1920x1080 mp4v videos at 30 fps (60 and 45 frames: a synthetic
    scene sliding 24 px a frame) and one corrupt file."""

    import cv2
    import numpy as np

    os.makedirs(folder, exist_ok=True)
    base = _large_image(rng, 1080, 1920)
    for name, n_frames in (('clip_a.mp4', 60), ('clip_b.mp4', 45)):
        out = cv2.VideoWriter(os.path.join(folder, name),
                              cv2.VideoWriter_fourcc(*'mp4v'), 30.0,
                              (1920, 1080))
        if not out.isOpened():
            raise AssertionError('cv2.VideoWriter cannot write mp4v')
        for i in range(n_frames):
            out.write(np.ascontiguousarray(np.roll(base, 24 * i,
                                                   axis=1)[..., ::-1]))
        out.release()
    with open(os.path.join(folder, 'corrupt.mp4'), 'wb') as f:
        f.write(b'not a video')


def _decoded_frames(path, every):
    import cv2

    cap = cv2.VideoCapture(path)
    frames, n = [], 0
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        if n % every == 0:
            frames.append((n, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)))
        n += 1
    cap.release()
    return frames


def phase_video(device, workdir, float_path, card):
    """
    21. process_videos with yolov5l6 in bf16 on a folder of two 1920x1080
    videos (30 fps, 60 and 45 frames) and a corrupt file, frame_batch_size
    8, under frame_sample 4 and time_sample 0.5: frames_processed as the
    sampling gives, launches exact (each video's frames in batches of 8
    and its own tail), each frame's detections equal to
    generate_detections_one_batch on the same frames decoded with cv2 in
    the same batches, the corrupt video a failure record, the file valid
    under validate_batch_results; frames/s of a replayed run. Then
    process_video_folder_via_frames (frames to JPEGs, then the batch
    driver) gives the same videos, frame numbers and frame rates.
    """

    import torch

    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise AssertionError('phase 21 needs cv2 to decode video: '
                             '{}'.format(e))
    import numpy as np

    from megadetector_tpu_torch.detection import process_video
    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.postprocessing.validate_batch_results \
        import validate_batch_results
    from megadetector_tpu_torch.workflows import manage_video_batch

    folder = os.path.join(workdir, 'videos')
    _write_videos(folder, np.random.RandomState(21))
    detector = load_detector(float_path, device=device,
                             detector_options={'dtype': 'bfloat16'})
    lengths = {'clip_a.mp4': 60, 'clip_b.mp4': 45}
    records = {}
    for sampling, value, every in (('frame_sample', 4, 4),
                                   ('time_sample', 0.5, 15)):
        options = process_video.ProcessVideoOptions()
        options.model_file = detector
        options.input_video_file = folder
        options.output_json_file = os.path.join(
            workdir, 'video_{}.json'.format(sampling))
        options.frame_batch_size = 8
        setattr(options, sampling, value)
        out, counts, programs, selects = _counted(
            detector, lambda: process_video.process_videos(options))
        forwards = {}
        for name, n in lengths.items():
            n_sampled = len(range(0, n, every))
            for i in range(0, n_sampled, 8):
                key = (min(8, n_sampled - i), 768, 1280)
                forwards[key] = forwards.get(key, 0) + 1
        _check_launches('phase 21, process_videos {} {}'.format(
            sampling, value), detector, counts, programs, selects,
            forwards)
        by_file = {im['file']: im for im in out['images']}
        corrupt = by_file.pop('corrupt.mp4')
        if corrupt['detections'] is not None or \
                corrupt['frame_rate'] != -1.0 or \
                not corrupt['failure'].startswith('Failure processing'):
            raise AssertionError('the corrupt video: {}'.format(corrupt))
        for name, n in lengths.items():
            im = by_file[name]
            if im['frames_processed'] != list(range(0, n, every)) or \
                    abs(im['frame_rate'] - 30.0) > 0.01:
                raise AssertionError('{}: frames {}, frame rate {}'.format(
                    name, im['frames_processed'], im['frame_rate']))
            frames = _decoded_frames(os.path.join(folder, name), every)
            for i in range(0, len(frames), 8):
                chunk = frames[i:i + 8]
                results = detector.generate_detections_one_batch(
                    [f for _, f in chunk], ['f'] * len(chunk),
                    detection_threshold=0.005)
                for (n_frame, _), r in zip(chunk, results):
                    got = [{k: v for k, v in d.items()
                            if k != 'frame_number'}
                           for d in im['detections']
                           if d['frame_number'] == n_frame]
                    if sorted(got, key=json.dumps) != sorted(
                            r['detections'], key=json.dumps) or not got:
                        raise AssertionError(
                            '{} frame {}: {} detections, {} from '
                            'generate_detections_one_batch'.format(
                                name, n_frame, len(got),
                                len(r['detections'])))
        errors = validate_batch_results(options.output_json_file)[
            'validation_results']['validation_errors']
        if errors:
            raise AssertionError('validate_batch_results: {}'.format(
                errors[:3]))
        records[sampling] = by_file
        n_frames = sum(len(im['frames_processed'])
                       for im in by_file.values())
        torch.cuda.synchronize()
        start = time.time()
        timed = process_video.process_videos(options)
        torch.cuda.synchronize()
        seconds = time.time() - start
        if timed['images'] != out['images']:
            raise AssertionError('process_videos: the replayed run '
                                 'differs')
        print('phase 21 on {}: process_videos {} {}: {} frames of 2 '
              'videos equal to generate_detections_one_batch on cv2\'s '
              'frames; corrupt video a failure record; valid; replayed run '
              '{:.3f} s, {:.3f} frames/s (decode included)'.format(
                  card, sampling, value, n_frames, seconds,
                  n_frames / seconds), flush=True)
        # Where the replayed run's time goes, step by step
        parts = {'decode': 0.0, 'batches': 0.0}
        for name in lengths:
            start = time.time()
            frames = _decoded_frames(os.path.join(folder, name), every)
            parts['decode'] += time.time() - start
            start = time.time()
            for i in range(0, len(frames), 8):
                detector.generate_detections_one_batch(
                    [f for _, f in frames[i:i + 8]],
                    ['f'] * len(frames[i:i + 8]), detection_threshold=0.005)
            torch.cuda.synchronize()
            parts['batches'] += time.time() - start
        print('phase 21, {}: cv2 decode of every frame of both videos '
              '{:.3f} s, the replayed batches through '
              'generate_detections_one_batch {:.3f} s'.format(
                  sampling, parts['decode'], parts['batches']), flush=True)

    options = manage_video_batch.VideoBatchOptions()
    options.model_file = float_path
    options.input_video_folder = folder
    options.frame_folder = os.path.join(workdir, 'video_frames')
    options.output_json_file = os.path.join(workdir, 'video_frames.json')
    options.every_n_frames = 4
    options.detector_options = {'dtype': 'bfloat16'}
    options.device = device
    start = time.time()
    frames_out = manage_video_batch.process_video_folder_via_frames(options)
    seconds = time.time() - start
    direct = records['frame_sample']
    got = {im['file']: (im['frame_rate'], im['frames_processed'])
           for im in frames_out['images']}
    want = {name: (im['frame_rate'], im['frames_processed'])
            for name, im in direct.items()}
    if got != want or any(im['detections'] is None
                          for im in frames_out['images']):
        raise AssertionError('process_video_folder_via_frames: {}, the '
                             'direct path {}'.format(got, want))
    print('phase 21 on {}: process_video_folder_via_frames (frames to '
          'JPEGs, then the batch driver, first calls) {:.3f} s; the same '
          'videos, frame numbers and frame rates as process_videos'.format(
              card, seconds), flush=True)
    _memory_line('phase 21')
    del detector
    torch.cuda.empty_cache()


#%% Phase 22: the other detector families


# (arch, model_type, image_size, card-vs-CPU canvas): yolov8l is the JAX
# converter's arch for a 64-channel ultralytics stem (the MDv1000 models)
FAMILY_MODELS = (('yolov8l', 'ultralytics', 1280, (256, 256)),
                 ('rfdetr_base', 'rfdetr', 560, (224, 224)),
                 ('detr_base', 'detr', 448, (224, 224)))


def _family_checkpoint(workdir, arch, model_type, image_size):
    """A full-width, full-depth [arch] model, random weights from seed 0
    through the port's init_params, saved as .npz with the metadata the
    JAX converter writes (DETR, which no converter writes: the metadata of
    the JAX package's DETR tests). Returns (path, config, params)."""

    from megadetector_tpu_torch.models import detector as detector_module
    from megadetector_tpu_torch.models import detr, rfdetr, yolov8
    from megadetector_tpu_torch.models.convert_weights import \
        save_checkpoint

    metadata = {'metadata_format_version': 1.0, 'arch': arch,
                'model_type': model_type, 'num_classes': 3,
                'class_names': ['animal', 'person', 'vehicle'],
                'image_size': image_size}
    config = detector_module.model_config(arch, model_type, metadata)
    module = {'ultralytics': yolov8, 'rfdetr': rfdetr,
              'detr': detr}[model_type]
    if model_type == 'ultralytics':
        metadata.update(model_version_string='v1000.0.0-redwood',
                        strides=list(config.strides))
    params = module.init_params(config, seed=0)
    path = os.path.join(workdir, 'md_smoke_{}.npz'.format(arch))
    save_checkpoint(params, path, metadata)
    return path, config, params


def _family_forward(model, x):
    """(decoded [B, Q, 5+nc] float32, query identity [B, Q]) of [model] on
    the uint8 batch [x]: RF-DETR's rows are its two-stage top-Q memory
    tokens (their indices), every other family's rows are fixed (their
    positions)."""

    import torch

    from megadetector_tpu_torch.models import rfdetr
    from megadetector_tpu_torch.models.yolov5 import network_input

    with torch.inference_mode():
        out = model(x).float().cpu().numpy()
        if isinstance(model, rfdetr.RFDetr):
            dtype = model.compute_dtype
            tokens, shapes = rfdetr.pyramid(
                model.config, model.params, network_input(x, dtype), dtype)
            ident = rfdetr.select_queries(model.config, model.params,
                                          tokens, shapes)[2].cpu().numpy()
        else:
            ident = torch.arange(out.shape[1]).expand(
                out.shape[0], -1).numpy()
    return out, ident


def _family_cpu_outputs(config, params, canvas):
    """The port's forward on the CPU for a seeded uint8 batch of 2 at
    [canvas]: (images, {dtype name: _family_forward's pair})."""

    import numpy as np
    import torch

    from megadetector_tpu_torch.models.detector import NETWORKS

    x = torch.from_numpy(np.random.RandomState(22).randint(
        0, 256, (2,) + canvas + (3,), dtype=np.uint8))
    outputs = {}
    for name, dtype in (('float32', torch.float32),
                        ('bfloat16', torch.bfloat16)):
        model = NETWORKS[type(config)](config).load_params(
            params).set_compute_dtype(dtype).eval()
        outputs[name] = _family_forward(model, x)
        del model
    return x, outputs


def _matched_rows(a, b):
    """Rows of two _family_forward results with the same query identity:
    (identities of a missing from b, [|d| of the matched rows' boxes,
    scores])."""

    import numpy as np

    (out_a, id_a), (out_b, id_b) = a, b
    missing, d_box, d_score = 0, [], []
    for i in range(out_a.shape[0]):
        common, pos_a, pos_b = np.intersect1d(id_a[i], id_b[i],
                                              return_indices=True)
        missing += out_a.shape[1] - len(common)
        d = np.abs(out_a[i, pos_a] - out_b[i, pos_b])
        d_box.append(d[:, :4])
        d_score.append(d[:, 5:])
    return missing, [np.concatenate(d_box), np.concatenate(d_score)]


def _family_card_vs_cpu(detector, dtype_name, x, cpu):
    """
    The card's forward against the CPU's on the same batch, rows matched
    by query identity (_family_forward), within the CPU tests' bars:
    float32, every query the same and |d| <= 1e-4 |ref| + 1e-4 max|ref|
    (rtol 1e-4, atol 1e-4 * max|ref|); bf16, no more queries missing
    than between the CPU's bf16 and float32 (RF-DETR's top-Q can differ
    where two memory tokens score within a bf16 rounding), and box and
    score errors no larger than the CPU's bf16 against its float32 plus
    float32's atol. Returns (queries missing, max box |d| px, max score
    |d|).
    """

    import numpy as np

    got = _family_forward(detector.model, x.to(detector.device))
    ref = cpu[dtype_name]
    if got[0].shape != ref[0].shape or not np.isfinite(got[0]).all():
        raise AssertionError('card output shape {} vs CPU {}, or '
                             'non-finite'.format(got[0].shape, ref[0].shape))
    missing, diffs = _matched_rows(got, ref)
    worst = [float(d.max(initial=0.0)) for d in diffs]
    if dtype_name == 'float32':
        bar = 1e-4 * np.abs(ref[0]) + 1e-4 * np.abs(ref[0]).max()
        outside = int((np.abs(got[0] - ref[0]) > bar).sum())
        if missing or outside:
            raise AssertionError(
                'card vs CPU float32: {} queries missing, {} elements '
                'outside rtol 1e-4 / atol 1e-4 * max|ref| (max |d| boxes '
                '{:.3e}, scores {:.3e})'.format(missing, outside, *worst))
    else:
        own_missing, own = _matched_rows(ref, cpu['float32'])
        # The CPU's own bf16 error, plus float32's absolute allowance
        # (RF-DETR's random boxes are its anchors, the same in both dtypes)
        limit = [float(d.max(initial=0.0)) + 1e-4 * np.abs(ref[0]).max()
                 for d in own]
        if missing > own_missing or worst[0] > limit[0] or \
                worst[1] > limit[1]:
            raise AssertionError(
                'card vs CPU bf16: {} queries missing, max |d| boxes {:.3e} '
                'scores {:.3e}; limits (the CPU\'s own bf16 against float32 '
                '+ 1e-4 max|ref|): {}, {:.3e}, {:.3e}'.format(
                    missing, *worst, own_missing, *limit))
    return [missing] + worst


def phase_other_families(device, workdir, pairs, card):
    """
    22. The other detector families at full width: yolov8l (num_classes
    3, 1280 px auto canvases), rfdetr_base (image_size 560) and detr_base
    (image_size 448), random weights from seed 0 through the port's
    init_params, each in float32 and bf16 through
    load_and_run_detector_batch over the 16 images at batch 8: an eager
    pass and a replayed one, each counted (NMS once per selection
    program; no int8 kernel or stem; under yolov8 bf16 the bias + SiLU
    epilogue once per activated conv per program, the count from the
    config; none for the transformers), their launches equal and their
    detections identical; the MD JSON checked; a timed replayed pass
    (images/s); the program cache's eager and replayed ms on the family's
    4:3 batch of 8 (phase 16's numbers); the card against the CPU on a
    uint8 batch of 2. Returns the (NMS, bias + SiLU) launches of the eager
    passes.
    """

    import numpy as np
    import torch

    from megadetector_tpu_torch.detection.run_detector import load_detector
    from megadetector_tpu_torch.detection.run_detector_batch import \
        load_and_run_detector_batch
    from megadetector_tpu_torch.models import yolov8

    nms_launches = silu_launches = 0
    for arch, model_type, image_size, canvas in FAMILY_MODELS:
        start = time.time()
        path, config, params = _family_checkpoint(workdir, arch, model_type,
                                                  image_size)
        x_cpu, cpu = _family_cpu_outputs(config, params, canvas)
        n_silu = yolov8.activated_conv_count(config) \
            if model_type == 'ultralytics' else 0
        for dtype in ('float32', 'bfloat16'):
            label = '{} {}'.format(arch, dtype)
            torch.cuda.reset_peak_memory_stats()
            detector = load_detector(path, device=device, detector_options={
                'pad_batches_to': 8, 'dtype': dtype})
            # An eager pass, then a replayed one, each counted
            passes = [_counted(detector, lambda: load_and_run_detector_batch(
                detector, pairs, batch_size=8, quiet=True))
                for _ in range(2)]
            for i, (_, counts, programs, selects) in enumerate(passes):
                want = (selects, 0, 0, 0,
                        programs * n_silu if dtype == 'bfloat16' else 0)
                if counts != want or programs != 2 or \
                        not programs <= selects <= 2 * programs:
                    raise AssertionError(
                        'phase 22, {}, pass {}: {} device programs (want '
                        '2), {} selection programs; launches (nms, conv, '
                        'bottleneck, stem, silu) {}, want {}'.format(
                            label, i + 1, programs, selects, counts, want))
            (eager, counts, programs, selects), (replayed, *rest) = passes
            if replayed != eager or tuple(rest) != (counts, programs,
                                                    selects):
                raise AssertionError('phase 22, {}: the replayed pass '
                                     'differs from the eager one'.format(
                                         label))
            if detector._programs.replays == 0:
                raise AssertionError('phase 22, {}: no program was '
                                     'replayed'.format(label))
            nms_launches += counts[0]
            silu_launches += counts[4]
            n_det = _write_and_check(eager, pairs, path, os.path.join(
                workdir, 'smoke_{}_{}.json'.format(arch, dtype)))
            torch.cuda.synchronize()
            t0 = time.time()
            load_and_run_detector_batch(detector, pairs, batch_size=8,
                                        quiet=True)
            torch.cuda.synchronize()
            rate = len(pairs) / (time.time() - t0)
            print('phase 22 on {}: {}: 16 images, {} detections; eager and '
                  'replayed passes identical, each 2 device programs, {} '
                  'selection programs, launches (nms, conv, bottleneck, '
                  'stem, silu) {} as they imply ({} bias + SiLU convs a '
                  'forward); {:.3f} images/s through '
                  'load_and_run_detector_batch (replayed)'.format(
                      card, label, n_det, selects, counts, n_silu, rate),
                  flush=True)

            infos = [detector.preprocess_image(img, image_id=name)
                     for name, img in pairs[0::2]]
            batch = np.stack([info['img_processed'] for info in infos])
            numbers = phase_program_cache(detector, batch, label)
            diffs = _family_card_vs_cpu(detector, dtype, x_cpu, cpu)
            print('phase 22 on {}: {}: {}x{} batch of 8: forward {:.3f} ms '
                  'eager, {:.3f} replayed; program {:.3f} ms eager, {:.3f} '
                  'replayed; peak {:.2f} GB allocated, {:.2f} GB reserved; '
                  'card vs CPU at {}x{}, batch 2: {} queries missing, max '
                  '|d| boxes {:.3e} px, scores {:.3e}'.format(
                      card, label, batch.shape[1], batch.shape[2],
                      numbers['forward_eager'], numbers['forward_replay'],
                      numbers['program_eager'], numbers['program_replay'],
                      numbers['peak_allocated_gb'],
                      numbers['peak_reserved_gb'], canvas[0], canvas[1],
                      *diffs), flush=True)
            del detector
            torch.cuda.empty_cache()
        del params
        print('phase 22, {}: {:.1f} s'.format(arch, time.time() - start),
              flush=True)
    return nms_launches, silu_launches


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
    serialized = []
    for line in _build.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'smem' in line:
            print('  ptxas: ' + line.strip())
        if 'C7520' in line or 'C7514' in line:
            # ptxas serialized a kernel's wgmma (issued in divergent code,
            # or accumulators read between issue and wait)
            print('  ptxas: ' + line.strip())
            serialized.append(line)
    if any('gemm_int8' in line for line in serialized):
        raise AssertionError('ptxas serialized the GEMM kernel\'s wgmma')

    # 3. kernel vs plain
    record = phase_kernel(device)

    config = YoloV5Config('yolov5l6', num_classes=3)
    params = init_params(config, seed=0)
    with tempfile.TemporaryDirectory() as workdir:
        # 4. main path
        torch.cuda.reset_peak_memory_stats()
        launches, e2e, device_rate, detector, buckets, float_path, pairs = \
            phase_main_path(device, workdir, config, params)
        record['launches'] = launches
        print('main path throughput on {}: {:.3f} images/s through '
              'load_and_run_detector_batch (host letterbox included), '
              '{:.3f} images/s through generate_detections_one_batch on '
              'letterboxed batches; 1280 px auto canvases, batch 8, '
              'float32'.format(card, e2e, device_rate), flush=True)
        batch, float_fwd = phase_breakdown(detector, buckets)

        # 16. the program cache (float32; the other configurations after
        # their main paths), and the host copy
        phase_program_cache(detector, batch, 'float32')
        pageable_ms, pinned_ms = _copy_ms(batch)
        print('host -> device copy of the uint8 960x1280 batch of 8 ({:.1f} '
              'MB): {:.3f} ms pageable, {:.3f} ms pinned'.format(
                  batch.nbytes / 1e6, pageable_ms, pinned_ms), flush=True)

        # 5. card vs CPU
        phase_card_vs_cpu(detector, config, params)
        del detector
        torch.cuda.empty_cache()

        # 6. int8 kernels vs plain
        conv_record, bottleneck_record = phase_int8_kernels(device, config)

        # 7. int8 main path
        q_path, counts, rates, forward_ms, detector = phase_int8_main_path(
            device, workdir, float_path, pairs, batch,
            profile='--profile' in sys.argv[1:])
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
            _profile_both(detector, batch, 'bf16')
        del detector
        torch.cuda.empty_cache()

        # 17. test-time augmentation
        phase_tta(device, workdir, float_path, q_path, pairs, batch)

        # 18. the folder run: JPEGs on disk through the loader pool
        start = time.time()
        phase_folder_run(device, workdir, float_path, q_path, card)
        print('folder run: phase 18 took {:.1f} s'.format(
            time.time() - start), flush=True)

        # 19-21. the single-image, tiled and video entry points
        torch.cuda.reset_peak_memory_stats()
        for label, run in (
                ('19', lambda: phase_single_image(device, workdir,
                                                  float_path, card)),
                ('20', lambda: phase_tiled(device, workdir, float_path,
                                           q_path, card)),
                ('21', lambda: phase_video(device, workdir, float_path,
                                           card))):
            start = time.time()
            run()
            print('phase {} took {:.1f} s'.format(label,
                                                  time.time() - start),
                  flush=True)

        # 22. the other detector families
        start = time.time()
        nms_launches, silu_launches = phase_other_families(
            device, workdir, pairs, card)
        record['launches'] += nms_launches
        silu_record['launches'] += silu_launches
        print('phase 22 took {:.1f} s'.format(time.time() - start),
              flush=True)

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
