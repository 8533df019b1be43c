"""The whole step's share of the card's dense peak in the traced window,
in %: the model FLOPs of the images the traced batches completed (the
configuration's conv shapes at each canvas, 2 x MACs) over the traced
window's length, over the peak of the configuration's compute type (bf16
989 TFLOP/s, int8 1,979 TOP/s). Moves images_per_s."""

from benchmark import yardstick


def read(obs):
    window = yardstick.trace_window(obs)
    if window is None:
        return None
    _, lo, hi = window
    flops = sum(yardstick.model_flops(
        yardstick.walk_cached(obs['config'], n, *shape))
        for n, shape in yardstick.traced_batches(obs))
    if not flops:
        return None
    peak = yardstick.PEAKS[obs['config']['compute_dtype']]
    return 100.0 * flops / ((hi - lo) / 1e6) / peak
