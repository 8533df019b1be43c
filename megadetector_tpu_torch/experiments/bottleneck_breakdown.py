"""
Where the fused int8 bottleneck kernel (csrc/bottleneck_int8.cu) spends
its time on the card: builds variants of its source with one part
removed, each alone with nvcc, and times them beside the kernel as
committed at the yolov5l6 bottleneck shapes of a 960x1280 batch of 8.

    python -m megadetector_tpu_torch.experiments.bottleneck_breakdown

Variants (their outputs are wrong by design; they only attribute time):
    kernel          the source as it is
    cheap_epilogue  both float epilogues (affine, SiLU, requant) replaced
                    by an int cast; the residual stays
    no_phase1       phase 1 (the 1x1 on the halo, into h1) skipped
    no_phase2       phase 2 (the 3x3, its epilogue and the stores) skipped
Needs a CUDA card and nvcc; prints the card, each variant's registers and
ms per call (CUDA events).
"""

import argparse
import ctypes
import os
import subprocess
import tempfile

import numpy as np
import torch

from megadetector_tpu_torch.ops import _build, bottleneck_int8

SHAPES = ((240, 320, 64), (120, 160, 128), (60, 80, 256), (30, 40, 384))

_EPILOGUE = '''      const int8_t v0 =
          md_requant(md_silu(md_affine(acc[4 * j + 2 * h], sc0, bi0)),
                     y_scale);
      const int8_t v1 =
          md_requant(md_silu(md_affine(acc[4 * j + 2 * h + 1], sc1, bi1)),
                     y_scale);'''
_CHEAP = '''      const int8_t v0 = (int8_t)(acc[4 * j + 2 * h] + (int)sc0 +
                                 (int)bi0 + (int)y_scale);
      const int8_t v1 = (int8_t)(acc[4 * j + 2 * h + 1] + (int)sc1 +
                                 (int)bi1);'''
_PHASE1 = '  run_stages<G::kSlots1>(2 * nn, nk, acc, load1, mma1, epilogue1);'
_PHASE2 = '''  run_stages<G::kSlots2>(nn, (units + G::kUnits2 - 1) / G::kUnits2, acc,
                         load2, mma2, epilogue2);'''

VARIANTS = {'kernel': (), 'cheap_epilogue': ((_EPILOGUE, _CHEAP),),
            'no_phase1': ((_PHASE1, ''),), 'no_phase2': ((_PHASE2, ''),)}


def build(workdir):
    """{variant: (C entry point, ptxas register lines)}, all compiled at
    once."""

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise _build.KernelError('nvcc not found')
    with open(os.path.join(_build.CSRC_DIR, 'bottleneck_int8.cu')) as f:
        source = f.read()
    jobs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError('variant {}: the kernel source changed; '
                                 'update its edit'.format(name))
            text = text.replace(old, new)
        src = os.path.join(workdir, name + '.cu')
        with open(src, 'w') as f:
            f.write(text)
        lib = os.path.join(workdir, name + '.so')
        cmd = [nvcc] + _build.NVCC_FLAGS + ['-I', _build.CSRC_DIR, '-shared',
                                            '-o', lib, src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise _build.KernelError('{}: nvcc failed\n{}'.format(name, log))
        fn = ctypes.CDLL(lib).md_bottleneck_int8
        fn.argtypes = _build._FUNCTIONS['md_bottleneck_int8']
        out[name] = (fn, [line.split(':', 1)[1].strip()
                          for line in log.splitlines() if 'Used' in line])
    return out


def _conv(rng, device, c, k):
    """int8 weight [c, k, k, c], and a scale that puts acc * scale at
    about unit std (as chip_smoke.py draws them), plus a bias."""

    w = rng.randint(-127, 128, (c, k, k, c)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, c) / (np.sqrt(c * k * k) * 127.0 * 127.0 /
                                        3.0)
    bias = rng.uniform(-0.5, 0.5, c)
    return (torch.from_numpy(w).to(device),
            torch.from_numpy(scale.astype(np.float32)).to(device),
            torch.from_numpy(bias.astype(np.float32)).to(device))


def time_ms(fn, reps=20):
    for _ in range(2):
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


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split('\n\n')[1]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise RuntimeError('bottleneck_breakdown needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as workdir:
        variants = build(workdir)
        for name, (_, regs) in variants.items():
            print('{}: {}'.format(name, '; '.join(regs)))
        rng = np.random.RandomState(6)
        device = torch.device('cuda')
        for h, w, c in SHAPES:
            x = torch.from_numpy(rng.randint(-127, 128, (8, h, w, c)).astype(
                np.int8)).to(device)
            (w1, s1, b1), (w2, s2, b2) = [_conv(rng, device, c, k)
                                          for k in (1, 3)]
            out = torch.empty_like(x)
            code = bottleneck_int8.kernel_tiling(c).code
            row = []
            for name, (fn, _) in variants.items():
                def call():
                    err = fn(x.data_ptr(), w1.data_ptr(), s1.data_ptr(),
                             b1.data_ptr(), 0.021, w2.data_ptr(),
                             s2.data_ptr(), b2.data_ptr(), 0.033, 0.007,
                             0.04, 1, out.data_ptr(), 8, h, w, c, code,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise _build.KernelError('{} launch failed ({})'
                                                 .format(name, err))
                row.append('{} {:.4f}'.format(name, time_ms(call)))
            print('C={} [8,{},{}] ms: {}'.format(c, h, w, ', '.join(row)),
                  flush=True)


if __name__ == '__main__':
    main()
