"""
E2: the int8 3x3 conv's variant sweep, on the card.

Port of experiments/exp_pallas_conv3x3b.py. Its variants rank3, flat
(taps as 2-D dots) and im2col (one dot at K = 9C), each at two band
heights, are TPU schedules of one function: on Hopper they are
ops/conv_int8.py conv3x3_int8_exp with epilogue 'f32', run once per
shape. Its nosilu variant is another function, epilogue 'f32_nosilu'
(what the SiLU costs). The im2col question (does one big GEMM beat the
taps?) is answered in PyTorch calls: im2col patches, torch._int_mm and
the plain epilogue, a yardstick.

    python -m megadetector_tpu_torch.experiments.exp_conv3x3b [--check]
        [--device cuda|cpu] [--batch 64] [--chain 8] [--iters 4]
"""

from megadetector_tpu_torch.experiments import _harness as H
from megadetector_tpu_torch.ops import conv_int8

RATIO = 0.8531
Y_SCALE = 0.043
CHECK_SHAPE = (2, 24, 40, 128)
SHAPES = [(120, 160, 128), (60, 80, 256), (30, 40, 512)]
ONE_FUNCTION = ('rank3, flat and im2col at every band height are one '
                'function on Hopper: the port runs it once per shape')


def check(args):
    inputs = H.Inputs(args.device)
    b, h, w, c = CHECK_SHAPE
    x = inputs.int8((b, h, w, c))
    w_hwio, wk, scale, bias = inputs.conv_layer(c, c)
    for epilogue in ('f32', 'f32_nosilu'):
        got = conv_int8.conv3x3_int8_exp(x, wk, scale, bias, RATIO, Y_SCALE,
                                         epilogue)
        name = 'E2 {} {}'.format(epilogue, CHECK_SHAPE)
        H.assert_identical(name, got, conv_int8.conv3x3_int8_exp_reference(
            x, wk, scale, bias, RATIO, Y_SCALE, epilogue))
        H.assert_identical(name + ' vs im2col + torch._int_mm', got,
                           H.im2col_conv_exp(x, w_hwio, scale, bias, RATIO,
                                             Y_SCALE, epilogue))
    print(ONE_FUNCTION, flush=True)


def main(argv=None):
    args = H.parse_args(argv, __doc__.strip().splitlines()[0])
    if args.check:
        check(args)
        return {'records': []}
    print(ONE_FUNCTION, flush=True)
    inputs = H.Inputs(args.device)
    records = []
    for h, w, c in SHAPES:
        x = inputs.int8((args.batch, h, w, c))
        w_hwio, wk, scale, bias = inputs.conv_layer(c, c)
        ops = 2.0 * args.batch * h * w * c * c * 9
        for epilogue in ('f32', 'f32_nosilu'):
            records.append(H.bench(
                'port conv3x3 {} {}x{} {}ch'.format(epilogue, h, w, c),
                lambda y, i, e=epilogue: conv_int8.conv3x3_int8_exp(
                    y, wk, scale, bias, RATIO, Y_SCALE, e),
                x, ops, args, {'conv3x3_int8_exp': 1}))
        records.append(H.bench(
            'im2col + torch._int_mm + plain f32 {}x{} {}ch'.format(h, w, c),
            lambda y, i: H.im2col_conv_exp(y, w_hwio, scale, bias, RATIO,
                                           Y_SCALE, 'f32'),
            x, ops, args, {}))
    return {'records': records}


if __name__ == '__main__':
    main()
