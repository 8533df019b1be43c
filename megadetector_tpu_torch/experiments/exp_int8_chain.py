"""
E5: chained int8 GEMMs with a fixed-scale requant, on the card.

Port of experiments/exp_pallas_int8_chain.py: dependent chains of
[M, K] s8 @ [K, K] s8 steps (two weights, alternating), each followed by
the requant clamp(round(f32(acc) * 3e-4), -127, 127), through
ops/gemm_int8.py gemm_int8, with the requant as torch ops after the s32
kernel and fused into it. The original's XLA dot becomes torch._int_mm,
its bf16 dot a torch.matmul chain, and its XLA conv chain the port's
chain conv (B2) in its int32 mode plus the same requant: yardsticks.
The rows scale with --batch: M = 1024 * batch (65,536 at 64) at
K = 1152, and 512 * batch at K = 2304.

    python -m megadetector_tpu_torch.experiments.exp_int8_chain [--check]
        [--device cuda|cpu] [--batch 64] [--chain 8] [--iters 4]
"""

import torch

from megadetector_tpu_torch.experiments import _harness as H
from megadetector_tpu_torch.ops import conv_int8, gemm_int8

REQUANT = 3e-4
CHECK_SHAPE = (512, 1152, 512)
# (rows per image of the batch, K) of the two GEMM chains
MM_SHAPES = [(1024, 1152), (512, 2304)]
CONV_SHAPES = [(120, 160, 128), (60, 80, 256), (30, 40, 512)]


def requant(acc):
    """int32 -> int8 at the fixed scale, as the original's requant()."""

    return conv_int8.multiply_to_int8(acc.to(torch.float32), REQUANT)


def check(args):
    inputs = H.Inputs(args.device)
    m, k, n = CHECK_SHAPE
    a, b = inputs.int8((m, k)), inputs.int8((k, n))
    acc = gemm_int8.gemm_int8(a, b)
    name = 'E5 {}x{}x{}'.format(m, k, n)
    H.assert_identical(name + ' s32', acc, gemm_int8.gemm_int8_reference(
        a, b))
    H.assert_identical(name + ' vs torch._int_mm', acc, torch._int_mm(a, b))
    fused = gemm_int8.gemm_int8(a, b, REQUANT)
    H.assert_identical(name + ' fused', fused,
                       gemm_int8.gemm_int8_reference(a, b, REQUANT))
    H.assert_identical(name + ' fused vs s32 + requant', fused, requant(acc))


def main(argv=None):
    args = H.parse_args(argv, __doc__.strip().splitlines()[0])
    if args.check:
        check(args)
        return {'records': []}
    inputs = H.Inputs(args.device)
    records = []

    rows, k = MM_SHAPES[0]
    m = rows * args.batch
    ops = 2.0 * m * k * k
    x = inputs.int8((m, k))
    ws = [inputs.int8((k, k)) for _ in range(2)]
    records.append(H.bench(
        'torch._int_mm s8 chain [{}x{}x{}]'.format(m, k, k),
        lambda y, i: requant(torch._int_mm(y, ws[i % 2])), x, ops, args, {}))
    records.append(H.bench(
        'port gemm s8 chain [{}x{}x{}]'.format(m, k, k),
        lambda y, i: requant(gemm_int8.gemm_int8(y, ws[i % 2])), x, ops,
        args, {'gemm_int8': 1}))
    records.append(H.bench(
        'port gemm s8 fused-epilogue chain',
        lambda y, i: gemm_int8.gemm_int8(y, ws[i % 2], REQUANT), x, ops,
        args, {'gemm_int8': 1}))
    wsb = [w.to(torch.bfloat16) for w in ws]
    records.append(H.bench(
        'torch.matmul bf16 chain (reference)',
        lambda y, i: (torch.matmul(y, wsb[i % 2]).to(torch.float32) *
                      REQUANT).to(torch.bfloat16),
        x.to(torch.bfloat16), ops, args, {}))
    del x, ws, wsb

    rows, k = MM_SHAPES[1]
    m = rows * args.batch
    ops = 2.0 * m * k * k
    x = inputs.int8((m, k))
    ws = [inputs.int8((k, k)) for _ in range(2)]
    records.append(H.bench(
        'torch._int_mm s8 chain [{}x{}x{}]'.format(m, k, k),
        lambda y, i: requant(torch._int_mm(y, ws[i % 2])), x, ops, args, {}))
    records.append(H.bench(
        'port gemm s8 fused-epilogue chain [{}x{}x{}]'.format(m, k, k),
        lambda y, i: gemm_int8.gemm_int8(y, ws[i % 2], REQUANT), x, ops,
        args, {'gemm_int8': 1}))
    del x, ws

    for h, w, c in CONV_SHAPES:
        x = inputs.int8((args.batch, h, w, c))
        ws = [inputs.conv_layer(c, c)[1] for _ in range(2)]
        ops = 2.0 * args.batch * h * w * c * c * 9
        records.append(H.bench(
            'B2 conv int32 + requant chain {}x{} {}ch'.format(h, w, c),
            lambda y, i: requant(conv_int8.conv_int8(
                y, ws[i % 2], None, None, (1, 1), (1, 1, 1, 1), None)),
            x, ops, args, {'conv_int8': 1}))
    return {'records': records}


if __name__ == '__main__':
    main()
