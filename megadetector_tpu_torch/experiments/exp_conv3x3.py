"""
E1: the int8 3x3 conv with its input requant fused, on the card.

Port of experiments/exp_pallas_conv3x3.py: the chained-int8 forward's 3x3
stride-1 SAME conv fused end to end (int8 x at the producer's scale ->
requant to x_scale in the kernel -> 9-tap int8 accumulation -> f32
dequant + bias + SiLU -> requant to y_scale -> int8), through
ops/conv_int8.py conv3x3_int8_exp (epilogue 'f32', in_ratio 0.8531).
The original compared it with XLA's step, which materializes the input
requant; here that step is a separate requant pass in PyTorch and the
chain conv kernel (B2), which requantizes by dividing by y_scale where E1
multiplies by f32(1 / y_scale), so the two may differ by 1 on rare
elements (--check counts them).

    python -m megadetector_tpu_torch.experiments.exp_conv3x3 [--check]
        [--device cuda|cpu] [--batch 64] [--chain 8] [--iters 4]
"""

from megadetector_tpu_torch.experiments import _harness as H
from megadetector_tpu_torch.ops import conv_int8

RATIO = 0.8531   # a representative producer -> x_scale ratio
Y_SCALE = 0.043
CHECK_SHAPES = [(2, 24, 40, 128, 128), (1, 30, 40, 256, 128),
                (1, 16, 16, 128, 256)]
SHAPES = [(120, 160, 128), (60, 80, 256), (30, 40, 512)]


def port_step(x, w, scale, bias):
    return conv_int8.conv3x3_int8_exp(x, w, scale, bias, RATIO, Y_SCALE,
                                      'f32')


def requant_pass_b2_step(x, w, scale, bias):
    """The original's XLA step: the input requant as its own pass, then
    the chain conv (B2)."""

    return conv_int8.conv_int8(conv_int8.requant_input_reference(x, RATIO),
                               w, scale, bias, (1, 1), (1, 1, 1, 1), Y_SCALE)


def check(args):
    inputs = H.Inputs(args.device)
    for b, h, w, c, cout in CHECK_SHAPES:
        x = inputs.int8((b, h, w, c))
        _, wk, scale, bias = inputs.conv_layer(c, cout)
        got = port_step(x, wk, scale, bias)
        H.assert_identical('E1 {}'.format((b, h, w, c, cout)), got,
                           conv_int8.conv3x3_int8_exp_reference(
                               x, wk, scale, bias, RATIO, Y_SCALE, 'f32'))
        n, worst = H.count_differing(
            requant_pass_b2_step(x, wk, scale, bias), got)
        print('  requant pass + B2 (divides by y_scale): {} of {} elements '
              'differ, by at most {}'.format(n, got.numel(), worst),
              flush=True)


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
        records.append(H.bench(
            'port conv3x3 s8 {}x{} {}ch'.format(h, w, c),
            lambda y, i: port_step(y, wk, scale, bias), x, ops, args,
            {'conv3x3_int8_exp': 1}))
        records.append(H.bench(
            'requant pass + B2 conv3x3 {}x{} {}ch'.format(h, w, c),
            lambda y, i: requant_pass_b2_step(y, wk, scale, bias), x, ops,
            args, {'conv_int8': 1}))
    return {'records': records}


if __name__ == '__main__':
    main()
