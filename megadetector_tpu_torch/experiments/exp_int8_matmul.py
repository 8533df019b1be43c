"""
E6: where the int8 ceiling is, on the card.

Port of experiments/exp_pallas_int8_matmul.py: single [M, K] s8 @ [K, N]
s8 -> s32 products at conv-as-matmul shapes, through ops/gemm_int8.py
gemm_int8. The original's full-K and k-loop kernels are TPU schedules of
one function, run once here. Its XLA dot becomes torch._int_mm (cuBLASLt
on the int8 tensor cores), its XLA conv the port's chain conv (B2) in
its int32 mode, and its im2col + XLA dot an im2col + torch._int_mm:
yardsticks beside the port's kernel. The rows scale with --batch
(M = 4800 * batch, 307,200 at 64), but for the square-ish 4096x2048x2048.

    python -m megadetector_tpu_torch.experiments.exp_int8_matmul [--check]
        [--device cuda|cpu] [--batch 64] [--iters 6]
"""

import torch

from megadetector_tpu_torch.experiments import _harness as H
from megadetector_tpu_torch.ops import conv_int8, gemm_int8

CHECK_SHAPE = (1024, 1152, 256)
CONV_SHAPES = [(120, 160, 128), (60, 80, 256), (30, 40, 512)]
ONE_FUNCTION = ('full-K and k-loop are one function on Hopper: the port '
                'runs it once per shape')


def mm_shapes(batch):
    """(M, K, N, note) of the original's conv-as-matmul shapes."""

    return [(batch * 60 * 80, 1152, 256, 'conv3x3 128->256 @s16-like'),
            (batch * 60 * 80, 2304, 256, 'conv3x3 256->256 @s16-like'),
            (4096, 2048, 2048, 'square-ish')]


def check(args):
    inputs = H.Inputs(args.device)
    m, k, n = CHECK_SHAPE
    a, b = inputs.int8((m, k)), inputs.int8((k, n))
    got = gemm_int8.gemm_int8(a, b)
    name = 'E6 {}x{}x{}'.format(m, k, n)
    H.assert_identical(name, got, gemm_int8.gemm_int8_reference(a, b))
    H.assert_identical(name + ' vs torch._int_mm', got, torch._int_mm(a, b))
    print(ONE_FUNCTION, flush=True)


def main(argv=None):
    args = H.parse_args(argv, __doc__.strip().splitlines()[0], iters=6)
    if args.check:
        check(args)
        return {'records': []}
    print(ONE_FUNCTION, flush=True)
    inputs = H.Inputs(args.device)
    records = []
    for m, k, n, note in mm_shapes(args.batch):
        ops = 2.0 * m * k * n
        a, b = inputs.int8((m, k)), inputs.int8((k, n))
        records.append(H.bench(
            'torch._int_mm s8 {} [{}x{}x{}]'.format(note, m, k, n),
            lambda y, i: torch._int_mm(a, b), None, ops, args, {}, chain=1))
        records.append(H.bench(
            'port gemm s8 {}'.format(note),
            lambda y, i: gemm_int8.gemm_int8(a, b), None, ops, args,
            {'gemm_int8': 1}, chain=1))
        del a, b

    for h, w, c in CONV_SHAPES:
        x = inputs.int8((args.batch, h, w, c))
        w_hwio, wk, _, _ = inputs.conv_layer(c, c)
        ops = 2.0 * args.batch * h * w * c * c * 9
        records.append(H.bench(
            'B2 conv int32 {}x{} {}->{}'.format(h, w, c, c),
            lambda y, i: conv_int8.conv_int8(x, wk, None, None, (1, 1),
                                             (1, 1, 1, 1), None),
            None, ops, args, {'conv_int8': 1}, chain=1))
        records.append(H.bench(
            'im2col + torch._int_mm s8 {}x{} {}->{}'.format(h, w, c, c),
            lambda y, i: H.im2col_int_mm(x, w_hwio), None, ops, args, {},
            chain=1))
        del x
    return {'records': records}


if __name__ == '__main__':
    main()
