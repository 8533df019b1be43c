"""E7 (bf16 bias + SiLU) against its roofline in the traced window, in %:
the sum over its launches of each launch's least time (bytes over the
HBM bandwidth, from the configuration's conv shapes at each batch's
canvas) over E7's traced kernel time. None where the E7 launch counter
disagrees with the walk's count. Moves images_per_s."""

from benchmark import yardstick


def read(obs):
    if obs.get('trace') is None:
        return None
    per_batch = yardstick.detector_e7(obs)
    batches = yardstick.traced_batches(obs)
    launches = nbytes = 0
    for _, shape in batches:
        n, b = per_batch(shape, obs['traffic']['batch_size'])
        launches += n
        nbytes += b
    if not launches or \
            yardstick.counter(obs, 'silu_bf16.launches') != launches:
        return None
    seconds = yardstick.kernel_seconds(obs['trace']['device'], 'silu_bf16')
    if seconds <= 0:
        return None
    return 100.0 * nbytes / yardstick.PEAKS['hbm_bytes'] / seconds
