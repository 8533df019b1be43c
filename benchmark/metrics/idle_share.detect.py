"""Share of the traced window in which nothing runs on the card, in %.
Moves images_per_s."""

from benchmark import yardstick


def read(obs):
    window = yardstick.trace_window(obs)
    if window is None:
        return None
    merged, lo, hi = window
    return 100.0 * (1.0 - sum(e - s for s, e in merged) / (hi - lo))
