"""
Shared harness of the int8 experiment entry points in this package, the
port's counterparts of experiments/exp_pallas_conv3x3*.py,
exp_pallas_int8_chain.py and exp_pallas_int8_matmul.py:

- the command line every entry point takes (--check, --device, --batch,
  --chain, --iters);
- seeded numpy inputs moved to the device: int8 in [-127, 127], scales
  U(1e-4, 4e-4), biases U(-0.5, 0.5), as the originals draw them;
- chained steps (y = step(y) --chain times per timed call, as the
  originals chain inside one program), timed with CUDA events on the card
  and by the host clock on the CPU (labelled so: a CPU time is no device
  number), with TOP/s from the operations a step needs;
- the launches of each port kernel during a variant's calls, beside the
  launches the variant declares per step, so a caller can hold the two
  equal;
- the yardsticks the originals compared against XLA with, in PyTorch
  (im2col + torch._int_mm + the plain epilogue). They time PyTorch calls
  beside the port's kernels; nothing in the port uses them.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from megadetector_tpu_torch.device import get_device, set_float32_exact
from megadetector_tpu_torch.ops import conv_int8, gemm_int8

# Port kernels whose launches a record counts: name -> (module, counter)
KERNELS = {'conv3x3_int8_exp': (conv_int8, 'exp_launches'),
           'conv_int8': (conv_int8, 'launches'),
           'gemm_int8': (gemm_int8, 'launches')}


def launch_counts():
    """{kernel name: launches so far} over KERNELS."""

    return {name: getattr(module, counter)
            for name, (module, counter) in KERNELS.items()}


def parse_args(argv, description, iters=4):
    """The entry points' command line; --device becomes a torch.device
    ('cuda' raises without a card)."""

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('--check', action='store_true',
                        help='hold the kernels against their plain versions '
                        'at the original\'s check shapes, then stop')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default; raises without a card) "
                        "or 'cpu', where the kernels' wrappers run their "
                        'plain versions')
    parser.add_argument('--batch', type=int, default=64,
                        help='batch of the conv shapes (and the GEMM rows '
                        'that scale with it)')
    parser.add_argument('--chain', type=int, default=8,
                        help='steps chained per timed call')
    parser.add_argument('--iters', type=int, default=iters,
                        help='timed calls per variant')
    args = parser.parse_args(argv)
    args.device = get_device(args.device)
    if args.device.type == 'cuda':
        set_float32_exact()
        print('device: {} ({} card(s))'.format(
            torch.cuda.get_device_name(args.device),
            torch.cuda.device_count()), flush=True)
    else:
        print('device: cpu (host-clock times; the kernels run their plain '
              'versions)', flush=True)
    return args


class Inputs:
    """Seeded numpy draws (RandomState(0)), moved to [device]."""

    def __init__(self, device):
        self.rng = np.random.RandomState(0)
        self.device = device

    def int8(self, shape):
        return torch.from_numpy(self.rng.randint(-127, 128, shape).astype(
            np.int8)).to(self.device)

    def uniform(self, shape, lo, hi):
        return torch.from_numpy(self.rng.uniform(lo, hi, shape).astype(
            np.float32)).to(self.device)

    def conv_layer(self, c, cout):
        """(HWIO weight, the kernels' [Cout, 3, 3, Cin] weight, scale,
        bias) of a 3x3 layer."""

        w_hwio = self.int8((3, 3, c, cout))
        return (w_hwio, conv_int8.prepare_weight(w_hwio.cpu()).to(
            self.device), self.uniform((cout,), 1e-4, 4e-4),
            self.uniform((cout,), -0.5, 0.5))


def im2col_patches(x_q):
    """[B, H, W, C] -> the 3x3 SAME patches [B*H*W, 9*C], columns ordered
    (dy, dx, c), as an HWIO weight reshapes to [9*C, Cout]."""

    b, h, w, c = x_q.shape
    xp = F.pad(x_q, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w, :]
                      for dy in range(3) for dx in range(3)],
                     dim=-1).reshape(b * h * w, 9 * c)


def im2col_int_mm(x_q, w_hwio):
    """int32 3x3 SAME conv as im2col_patches times torch._int_mm: the
    experiments' im2col mode in PyTorch calls."""

    b, h, w, c = x_q.shape
    acc = torch._int_mm(im2col_patches(x_q), w_hwio.reshape(9 * c, -1))
    return acc.reshape(b, h, w, -1)


def im2col_conv_exp(x_q, w_hwio, scale, bias, in_ratio, y_scale, epilogue):
    """The experiments' conv in PyTorch calls: the input requant,
    im2col_int_mm and the plain epilogue."""

    acc = im2col_int_mm(conv_int8.requant_input_reference(x_q, in_ratio),
                        w_hwio)
    return conv_int8.exp_epilogue_reference(acc, scale, bias, y_scale,
                                            epilogue)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def bench(name, step, x, ops_per_step, args, expect, chain=None, warmup=1):
    """
    Time y = step(y, i) for i in range(chain), from y = x, over
    args.iters calls after [warmup] untimed ones.

    Args:
        expect: {kernel name: launches per step} of the port's kernels
            (KERNELS) the variant runs; {} for a yardstick

    Returns:
        {'name', 'ms_per_step', 'tops', 'clock', 'calls' (steps run),
         'launches' ({kernel: launches during the calls}), 'expect'}
    """

    chain = args.chain if chain is None else chain

    def run():
        y = x
        for i in range(chain):
            y = step(y, i)
        return y

    before = launch_counts()
    for _ in range(warmup):
        run()
    _sync(args.device)
    if args.device.type == 'cuda':
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            run()
        end.record()
        torch.cuda.synchronize(args.device)
        ms = start.elapsed_time(end) / args.iters
        clock = 'cuda events'
    else:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        ms = (time.perf_counter() - t0) * 1e3 / args.iters
        clock = 'host clock, cpu'
    after = launch_counts()
    per_step = ms / chain
    record = {'name': name, 'ms_per_step': per_step,
              'tops': ops_per_step / (per_step * 1e-3) / 1e12,
              'clock': clock, 'calls': (warmup + args.iters) * chain,
              'launches': {k: after[k] - before[k] for k in KERNELS},
              'expect': dict(expect)}
    print('{:58s}: {:9.4f} ms/step {:8.2f} TOP/s ({})'.format(
        name, per_step, record['tops'], clock), flush=True)
    return record


def assert_identical(name, got, want):
    """Raise unless the two int tensors are equal; print the check."""

    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.equal(got, want):
        n = int((got.long() != want.long()).sum()) \
            if got.shape == want.shape else got.numel()
        raise AssertionError('{}: kernel and plain version differ on {} of '
                             '{} elements'.format(name, n, want.numel()))
    print('check OK {}: identical ({} elements)'.format(
        name, want.numel()), flush=True)


def count_differing(got, want):
    """(elements that differ, largest difference) of two int tensors."""

    diff = (got.long() - want.long()).abs()
    return int((diff > 0).sum()), int(diff.max()) if diff.numel() else 0
