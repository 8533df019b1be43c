"""Mean host time between one return of generate_detections_one_batch and
the driver's next call to it, over the window (the benchmark's own
ranges around the calls): the driver's queue wait plus its own Python,
chunk starts included. Moves images_per_s."""


def read(obs):
    spans = obs.get('spans') or []
    gaps = [b[0] - a[1] for a, b in zip(spans, spans[1:])]
    return 1000.0 * sum(gaps) / len(gaps) if gaps else None
