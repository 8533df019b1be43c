"""
Where the greedy-NMS kernel (csrc/nms.cu) spends its time on the card:
builds variants of its source with one part of the sweep changed or
removed, each alone with nvcc, and times them beside the kernel as
committed on seeded boxes at B = 8 (the main path's batch) and K = 512,
2048, 8192 (8192 is the capacity random weights escalate to).

    python -m megadetector_tpu_torch.experiments.nms_sweep_breakdown

Variants (all but 'walk' give wrong keep masks by design; they only
attribute time; each is timed as the whole entry point, mask pass and
sweep):
    kernel       the source as it is
    walk         each chunk resolved by walking from one lowest alive bit
                 to the next with __ffsll, a shared-memory load a step
                 (identical keep masks; the design the kernel replaced)
    no_resolve   no chunk resolution: every alive row counts as kept
    no_apply     the kept rows' later words are never ORed into removed
    no_copies    the sweep's cp.async copies are never issued (its tiles
                 hold whatever shared memory held)
    no_sweep     the sweep is not launched: the mask pass alone
Needs a CUDA card and nvcc; prints the card, each variant's registers
(sweep kernel) and ms per call (CUDA events), and whether 'walk' kept
the kernel's boxes.
"""

import argparse
import ctypes
import os
import subprocess
import tempfile

import numpy as np
import torch

from megadetector_tpu_torch.experiments.bottleneck_breakdown import time_ms
from megadetector_tpu_torch.ops import _build, cuda_nms

KS = (512, 2048, 8192)
THRESH = 0.45

_RESOLVE = '''        const u64* diag = tile + (c - s0);
        u64 d[kWord];
#pragma unroll
        for (int r = 0; r < kWord; ++r) d[r] = diag[r * n];
        u64 kept = ~removed[c];
#pragma unroll
        for (int r = 0; r < kWord; ++r)
          if ((kept >> r) & 1ULL) kept &= ~d[r];'''
_WALK = '''        const u64* diag = tile + (c - s0);
        u64 alive = ~removed[c];
        u64 kept = 0ULL;
        while (alive) {
          const int r = __ffsll((long long)alive) - 1;
          const u64 bit = 1ULL << r;
          kept |= bit;
          alive &= ~(bit | diag[r * n]);
        }'''
_NO_RESOLVE = '        u64 kept = ~removed[c];'
_APPLY = '    if (kept) {\n      // Apply:'
_NO_APPLY = '    if (false) {\n      // Apply:'
_COPY = ('      md_cp_async16(dst0 + (uint32_t)((r * n + 2 * p) * 8), '
         'src + 2 * p, 16);')
_SWEEP = ('  nms_sweep_kernel<<<batch, kSweepThreads, smem, s>>>(mask, valid, k, '
          'words,\n' + ' ' * 54 + 'row_words, keep);')

VARIANTS = {'kernel': (), 'walk': ((_RESOLVE, _WALK),),
            'no_resolve': ((_RESOLVE, _NO_RESOLVE),),
            'no_apply': ((_APPLY, _NO_APPLY),),
            'no_copies': ((_COPY, '      ;'),), 'no_sweep': ((_SWEEP, ''),)}


def build(workdir):
    """{variant: (C entry point, ptxas lines of the sweep kernel)}, all
    compiled at once."""

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise _build.KernelError('nvcc not found')
    with open(os.path.join(_build.CSRC_DIR, 'nms.cu')) as f:
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
        fn = ctypes.CDLL(lib).md_greedy_nms
        fn.argtypes = _build._FUNCTIONS['md_greedy_nms']
        lines = log.splitlines()
        sweep = [i for i, line in enumerate(lines)
                 if 'Compiling' in line and 'nms_sweep_kernel' in line]
        regs = [line.split(':', 1)[1].strip() for i in sweep
                for line in lines[i:i + 4] if 'Used' in line]
        out[name] = (fn, regs)
    return out


def boxes_case(rng, b, k, n_classes=3, canvas=1280.0):
    """Seeded boxes [b, k, 4], class-offset, with ~10 % invalid slots (as
    chip_smoke.py's phase 3 draws them)."""

    xy = rng.uniform(0, canvas, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(8, 240, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    boxes += rng.randint(0, n_classes, (b, k, 1)).astype(np.float32) * 8192.0
    return boxes, rng.rand(b, k) > 0.1


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split('\n\n')[1]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise RuntimeError('nms_sweep_breakdown needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as workdir:
        variants = build(workdir)
        for name, (_, regs) in variants.items():
            print('{}: sweep kernel {}'.format(name, '; '.join(regs) or '-'))
        rng = np.random.RandomState(7)
        device = torch.device('cuda')
        m, m_hi, m_lo, tie_up = cuda_nms.threshold_split(THRESH)
        for k in KS:
            boxes, valid = [torch.from_numpy(a).to(device)
                            for a in boxes_case(rng, 8, k)]
            mask = torch.empty((8, k, cuda_nms.row_words(k)),
                               dtype=torch.int64, device=device)
            keeps, row = {}, []
            for name, (fn, _) in variants.items():
                keep = valid.clone()

                def call():
                    err = fn(boxes.data_ptr(), valid.data_ptr(),
                             mask.data_ptr(), keep.data_ptr(), 8, k, m, m_hi,
                             m_lo, int(tie_up),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise _build.KernelError('{} launch failed ({})'
                                                 .format(name, err))
                row.append('{} {:.4f}'.format(name, time_ms(call)))
                keeps[name] = keep
            same = torch.equal(keeps['walk'], keeps['kernel'])
            print('B=8 K={} ({} kept) ms: {}; walk keeps the same boxes: {}'
                  .format(k, int(keeps['kernel'].sum()), ', '.join(row), same),
                  flush=True)
            if not same:
                raise AssertionError('walk and kernel keep different boxes')


if __name__ == '__main__':
    main()
