"""
E3: the int8 3x3 conv with a bf16 epilogue, and the card's ceilings.

Port of experiments/exp_pallas_conv3x3c.py. Its im2col and flat modes are
TPU schedules of one function (on Hopper, ops/conv_int8.py
conv3x3_int8_exp, run once per shape); its epilogue dtype is a second
function: 'f32', or 'bf16' (acc, scale and bias in bf16, the SiLU's
sigmoid rounded as XLA rounds it). The original's ceiling probes (a
chained 8192^3 bf16 dot and s8 dot) become torch.matmul and
torch._int_mm chains, yardsticks of what the card's tensor cores give
through a library call; so does im2col + torch._int_mm + the plain
epilogue beside the port's kernel.

    python -m megadetector_tpu_torch.experiments.exp_conv3x3c [--check]
        [--device cuda|cpu] [--batch 64] [--chain 8] [--iters 4]
"""

import torch

from megadetector_tpu_torch.experiments import _harness as H
from megadetector_tpu_torch.ops import conv_int8

RATIO = 0.8531
Y_SCALE = 0.043
CHECK_SHAPE = (2, 24, 40, 128)
SHAPES = [(120, 160, 128), (60, 80, 256), (30, 40, 512)]
CEILING = 8192
ONE_FUNCTION = ('im2col and flat are one function on Hopper: the port '
                'runs each epilogue once per shape')


def check(args):
    inputs = H.Inputs(args.device)
    b, h, w, c = CHECK_SHAPE
    x = inputs.int8((b, h, w, c))
    w_hwio, wk, scale, bias = inputs.conv_layer(c, c)
    out = {}
    for epilogue in ('f32', 'bf16'):
        got = conv_int8.conv3x3_int8_exp(x, wk, scale, bias, RATIO, Y_SCALE,
                                         epilogue)
        name = 'E3 {} {}'.format(epilogue, CHECK_SHAPE)
        H.assert_identical(name, got, conv_int8.conv3x3_int8_exp_reference(
            x, wk, scale, bias, RATIO, Y_SCALE, epilogue))
        H.assert_identical(name + ' vs im2col + torch._int_mm', got,
                           H.im2col_conv_exp(x, w_hwio, scale, bias, RATIO,
                                             Y_SCALE, epilogue))
        out[epilogue] = got
    # the original's drift bar of the bf16 epilogue against the f32 one
    n, worst = H.count_differing(out['bf16'], out['f32'])
    print('bf16 epilogue vs f32: {} of {} elements differ, max |d| {}'
          .format(n, out['f32'].numel(), worst), flush=True)
    if worst > 2 or n >= 0.05 * out['f32'].numel():
        raise AssertionError('bf16 epilogue drifts past the original\'s bar '
                             '(max |d| <= 2 on < 5% of elements)')
    print(ONE_FUNCTION, flush=True)


def main(argv=None):
    args = H.parse_args(argv, __doc__.strip().splitlines()[0])
    if args.check:
        check(args)
        return {'records': []}
    inputs = H.Inputs(args.device)
    records = []

    # ceiling probes (library calls only)
    m = CEILING
    ops = 2.0 * m * m * m
    xb = inputs.uniform((m, m), -1, 1).to(torch.bfloat16)
    wb = inputs.uniform((m, m), -1, 1).to(torch.bfloat16)
    records.append(H.bench('CEILING torch.matmul bf16 {m}x{m}x{m}'.format(
        m=m), lambda y, i: torch.matmul(y, wb), xb, ops, args, {}))
    del xb, wb
    xi, wi = inputs.int8((m, m)), inputs.int8((m, m))
    records.append(H.bench(
        'CEILING torch._int_mm s8 {m}x{m}x{m}'.format(m=m),
        lambda y, i: torch.clamp(torch._int_mm(y, wi) >> 12, -127,
                                 127).to(torch.int8),
        xi, ops, args, {}))
    del xi, wi

    print(ONE_FUNCTION, flush=True)
    for h, w, c in SHAPES:
        x = inputs.int8((args.batch, h, w, c))
        w_hwio, wk, scale, bias = inputs.conv_layer(c, c)
        ops = 2.0 * args.batch * h * w * c * c * 9
        for epilogue in ('f32', 'bf16'):
            records.append(H.bench(
                'port conv3x3 ep={} {}x{} {}ch'.format(epilogue, h, w, c),
                lambda y, i, e=epilogue: conv_int8.conv3x3_int8_exp(
                    y, wk, scale, bias, RATIO, Y_SCALE, e),
                x, ops, args, {'conv3x3_int8_exp': 1}))
            records.append(H.bench(
                'im2col + torch._int_mm + plain ep={} {}x{} {}ch'.format(
                    epilogue, h, w, c),
                lambda y, i, e=epilogue: H.im2col_conv_exp(
                    y, w_hwio, scale, bias, RATIO, Y_SCALE, e),
                x, ops, args, {}))
    return {'records': records}


if __name__ == '__main__':
    main()
