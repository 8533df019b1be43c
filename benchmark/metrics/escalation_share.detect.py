"""Selection programs run above pre_nms_topk, per batch, over the window,
from the program cache's per-key calls, in %. Guards the traffic: with
the rescaled weights it should read near 0. Moves images_per_s."""


def read(obs):
    if not obs.get('batches'):
        return None
    return 100.0 * obs['escalated'] / obs['batches']
