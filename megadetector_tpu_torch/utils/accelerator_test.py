"""
Accelerator diagnostics: the port's counterpart of
megadetector_tpu/utils/accelerator_test.py (which probes the JAX backend).
Checks torch and CUDA, lists the cards with their power limits, builds the
port's kernels (ops/_build.py) and launches one of them, the greedy NMS
kernel (B1) on a few hundred boxes, against its plain version.

    python -m megadetector_tpu_torch.utils.accelerator_test [--device cpu]

The card is the default; without one the report says so and the CLI exits
non-zero. device='cpu' runs the plain version alone on the CPU.
"""

import argparse
import subprocess
import sys
import time

# The smoke test's NMS case: boxes a batch row, rows, IoU threshold
SMOKE_BOXES = 384
SMOKE_ROWS = 2
SMOKE_IOU = 0.45


def _power_limits():
    """['<name>, <power limit>', ...] from nvidia-smi, or None where it
    cannot be run."""

    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _smoke_case(device):
    """Seeded score-sorted, class-offset xyxy boxes [rows, K, 4] and their
    valid mask on [device]."""

    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    shape = (SMOKE_ROWS, SMOKE_BOXES)
    xy = rng.uniform(0, 640, shape + (2,)).astype(np.float32)
    wh = rng.uniform(8, 160, shape + (2,)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    boxes += rng.randint(0, 3, shape)[..., None].astype(np.float32) * 8192
    valid = rng.rand(*shape) > 0.1
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device))


def accelerator_test(verbose=True, *, device=None):
    """
    Probe torch and the card. Returns a dict: torch_ok, torch_version,
    cuda_version, platform ('gpu', or 'cpu' when asked for), n_devices,
    devices (names), power_limits (nvidia-smi's name and limit lines, or
    None), smoke_test_ok, smoke_test_seconds (the kernels' build included
    on a card), smoke_test (what ran), error; prints a report when
    verbose. [device] (keyword only): None or 'cuda[:N]' for the card,
    'cpu' for the plain version on the CPU.
    """

    result = {'torch_ok': False, 'torch_version': None,
              'cuda_version': None, 'platform': None, 'n_devices': 0,
              'devices': [], 'power_limits': None, 'smoke_test_ok': False,
              'smoke_test_seconds': None, 'smoke_test': None, 'error': None}

    def report(msg):
        if verbose:
            print(msg)

    try:
        import torch
        from megadetector_tpu_torch.device import get_device
        result['torch_version'] = torch.__version__
        result['cuda_version'] = torch.version.cuda
        result['torch_ok'] = True
        report('Torch {} (CUDA {})'.format(torch.__version__,
                                           torch.version.cuda))
        target = get_device(device)
    except Exception as e:
        result['error'] = str(e)
        report('Accelerator check failed: {}'.format(e))
        return result

    if target.type == 'cuda':
        result['platform'] = 'gpu'
        result['n_devices'] = torch.cuda.device_count()
        result['devices'] = [torch.cuda.get_device_name(i)
                             for i in range(result['n_devices'])]
        result['power_limits'] = _power_limits()
    else:
        result['platform'] = 'cpu'
    report('Platform: {}, {} device(s)'.format(result['platform'],
                                               result['n_devices']))
    for line in result['power_limits'] or result['devices']:
        report('  ' + line)

    try:
        from megadetector_tpu_torch.ops import _build, cuda_nms
        start = time.time()
        if target.type == 'cuda':
            _build.load_library()
        boxes, valid = _smoke_case(target)
        keep = cuda_nms.greedy_nms_keep(boxes, valid, SMOKE_IOU)
        want = cuda_nms.greedy_nms_keep_reference(boxes.cpu(), valid.cpu(),
                                                  SMOKE_IOU)
        same = bool(torch.equal(keep.cpu(), want))
        result['smoke_test_seconds'] = time.time() - start
        result['smoke_test'] = '{} on {} x {} boxes against its plain ' \
            'version'.format('the greedy NMS kernel' if target.type ==
                             'cuda' else 'the plain greedy NMS',
                             SMOKE_ROWS, SMOKE_BOXES)
        result['smoke_test_ok'] = same and int(want.sum()) > 0
        report('Smoke test ({}) {} in {:.2f}s'.format(
            result['smoke_test'],
            'passed' if result['smoke_test_ok'] else 'FAILED',
            result['smoke_test_seconds']))
    except Exception as e:
        result['error'] = str(e)
        report('Smoke test failed: {}'.format(e))

    return result


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Check torch, the card and the port\'s kernels')
    parser.add_argument('--device', default=None,
                        help='cuda, cuda:N or cpu (default: cuda, which '
                             'needs a card)')
    args = parser.parse_args(argv)
    result = accelerator_test(verbose=True, device=args.device)
    sys.exit(0 if result['smoke_test_ok'] else 1)


if __name__ == '__main__':
    main()
