"""
E4: the int8 3x3 conv's bf16 and hybrid epilogues, on the card.

Port of experiments/exp_pallas_conv3x3d.py: no input requant; the
epilogue is 'f32' (E1's), 'bf16' (E3's) or 'hybrid' (f32 scale and bias,
only the sigmoid in bf16), through ops/conv_int8.py conv3x3_int8_exp.
The original's band height is a TPU schedule. --check holds each
epilogue against its plain version and the bf16 and hybrid drift against
f32 to the original's bar (max |d| <= 2).

    python -m megadetector_tpu_torch.experiments.exp_conv3x3d [--check]
        [--device cuda|cpu] [--batch 64] [--chain 8] [--iters 4]
"""

from megadetector_tpu_torch.experiments import _harness as H
from megadetector_tpu_torch.ops import conv_int8

Y_SCALE = 0.043
CHECK_SHAPE = (2, 24, 40, 128)
SHAPES = [(120, 160, 128), (60, 80, 256), (30, 40, 512)]
EPILOGUES = ('bf16', 'hybrid', 'f32')


def check(args):
    inputs = H.Inputs(args.device)
    b, h, w, c = CHECK_SHAPE
    x = inputs.int8((b, h, w, c))
    _, wk, scale, bias = inputs.conv_layer(c, c)
    out = {}
    for epilogue in EPILOGUES:
        out[epilogue] = conv_int8.conv3x3_int8_exp(x, wk, scale, bias, 1.0,
                                                   Y_SCALE, epilogue)
        H.assert_identical(
            'E4 {} {}'.format(epilogue, CHECK_SHAPE), out[epilogue],
            conv_int8.conv3x3_int8_exp_reference(x, wk, scale, bias, 1.0,
                                                 Y_SCALE, epilogue))
    for epilogue in ('bf16', 'hybrid'):
        n, worst = H.count_differing(out[epilogue], out['f32'])
        print('{} vs f32: {} of {} elements differ, max |d| {}'.format(
            epilogue, n, out['f32'].numel(), worst), flush=True)
        if worst > 2:
            raise AssertionError('{} epilogue drifts past the original\'s '
                                 'bar (max |d| <= 2)'.format(epilogue))


def main(argv=None):
    args = H.parse_args(argv, __doc__.strip().splitlines()[0])
    if args.check:
        check(args)
        return {'records': []}
    inputs = H.Inputs(args.device)
    records = []
    for h, w, c in SHAPES:
        x = inputs.int8((args.batch, h, w, c))
        _, wk, scale, bias = inputs.conv_layer(c, c)
        ops = 2.0 * args.batch * h * w * c * c * 9
        for epilogue in EPILOGUES:
            records.append(H.bench(
                'port conv3x3 {} {}x{} {}ch'.format(epilogue, h, w, c),
                lambda y, i, e=epilogue: conv_int8.conv3x3_int8_exp(
                    y, wk, scale, bias, 1.0, Y_SCALE, e),
                x, ops, args, {'conv3x3_int8_exp': 1}))
    return {'records': records}


if __name__ == '__main__':
    main()
