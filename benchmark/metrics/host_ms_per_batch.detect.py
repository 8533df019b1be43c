"""Mean wall time inside generate_detections_one_batch less the device's
busy time within it (trace): the detector's serial host work a batch
(stack, stage, escalation read, emission). Moves images_per_s."""

from benchmark import yardstick


def read(obs):
    window = yardstick.trace_window(obs)
    if window is None:
        return None
    merged = window[0]
    spans = yardstick.traced_spans(obs, 'bench.generate_detections_one_batch')
    if not spans:
        return None
    host = [(e - s) - yardstick.busy_within(merged, s, e)
            for _, s, e in spans]
    return sum(host) / len(host) / 1000.0
