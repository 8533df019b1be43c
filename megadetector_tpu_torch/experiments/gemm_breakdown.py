"""
Where the int8 GEMM kernel (csrc/gemm_int8.cu, E5 and E6) spends its time
on the card: builds the source alone with -DMD_GEMM_BREAKDOWN, whose own
C entry (md_gemm_int8_breakdown) launches the kernel with one part left
out, and times each variant beside the kernel at the shapes of
chip_smoke.py's phase 14; the kernel's own output is held to the plain
version first.

    python -m megadetector_tpu_torch.experiments.gemm_breakdown

Variants (all but 'kernel' give wrong outputs by design; they only
attribute time):
    kernel       the call as gemm_int8 makes it
    prepass      the transpose (and pad) pre-passes alone
    no_mma       the consumers wait and release every stage, no wgmma
    no_stores    the epilogue stages its tiles but stores nothing
    no_epilogue  no staging and no stores
    no_loads     the producer signals each stage without a TMA load
Needs a CUDA card and nvcc; prints the card, the kernels' registers and
ms per call (CUDA events).
"""

import argparse
import ctypes
import os
import subprocess
import tempfile

import numpy as np
import torch

from megadetector_tpu_torch.experiments.bottleneck_breakdown import time_ms
from megadetector_tpu_torch.ops import _build, gemm_int8

# (M, K, N) of phase 14: E5, E6 and E6's square-ish shape
SHAPES = ((65536, 1152, 1152), (38400, 2304, 256), (4096, 2048, 2048))
REQUANT = 3e-4
VARIANTS = {'kernel': 0, 'prepass': -1, 'no_mma': 1, 'no_stores': 2,
            'no_epilogue': 3, 'no_loads': 4}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(workdir):
    """(md_gemm_int8_breakdown, ptxas register lines)."""

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise _build.KernelError('nvcc not found')
    lib = os.path.join(workdir, 'gemm_breakdown.so')
    cmd = [nvcc] + _build.NVCC_FLAGS + [
        '-DMD_GEMM_BREAKDOWN', '-I', _build.CSRC_DIR, '-shared', '-o', lib,
        os.path.join(_build.CSRC_DIR, 'gemm_int8.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise _build.KernelError('nvcc failed\n{}'.format(log))
    fn = ctypes.CDLL(lib).md_gemm_int8_breakdown
    fn.argtypes = [_P] * 5 + [_I] * 4 + [_F] + [_I] * 2 + [_P]
    fn.restype = _I
    return fn, [line.split(':', 1)[1].strip() for line in log.splitlines()
                if 'Used' in line]


def call(fn, a, b, out, requant, variant):
    """One launch of [variant]; scratch allocated here, as the wrapper
    does."""

    m, k = a.shape
    n = b.shape[1]
    tiling = gemm_int8.gemm_tiling(m, k, n, a.data_ptr() % 16 == 0)
    bt = torch.empty((n, tiling.kp), device=a.device, dtype=torch.int8)
    ap = (torch.empty((m, tiling.kp), device=a.device, dtype=torch.int8)
          if tiling.pad_a else None)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), bt.data_ptr(),
             None if ap is None else ap.data_ptr(), m, n, k,
             int(requant is not None), float(np.float32(requant or 0.0)),
             tiling.grid, variant, torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.KernelError('variant {} failed ({})'.format(variant,
                                                                err))


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split('\n\n')[1]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise RuntimeError('gemm_breakdown needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    device = torch.device('cuda')
    rng = np.random.RandomState(8)
    with tempfile.TemporaryDirectory() as workdir:
        fn, regs = build(workdir)
        print('registers: {}'.format('; '.join(regs)), flush=True)
        for m, k, n in SHAPES:
            a = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(
                np.int8)).to(device)
            b = torch.from_numpy(rng.randint(-128, 128, (k, n)).astype(
                np.int8)).to(device)
            for requant in (None, REQUANT):
                out = torch.empty((m, n), device=device, dtype=torch.int32
                                  if requant is None else torch.int8)
                call(fn, a, b, out, requant, 0)
                torch.cuda.synchronize()
                ref = gemm_int8.gemm_int8_reference(a, b, requant)
                if not torch.equal(out, ref):
                    raise AssertionError(
                        '{}x{}x{}: {} of {} elements differ from the plain '
                        'version'.format(m, k, n, int((out != ref).sum()),
                                         out.numel()))
                row = ['{} {:.4f}'.format(name, time_ms(
                    lambda: call(fn, a, b, out, requant, v)))
                       for name, v in VARIANTS.items()]
                print('{}x{}x{} {} ms: {}'.format(
                    m, k, n, 'int32' if requant is None else 'fused int8',
                    ', '.join(row)), flush=True)
            del a, b, out, ref
            torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
