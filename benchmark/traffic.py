"""
The benchmark's one traffic generator. A traffic file (benchmark/traffic/
<name>.json) holds only parameters; generate() reads them and makes the
cell's inputs from the seed, on the device, in a few large calls:

- items 'frames': a pool of synthetic camera-trap frames (gradients,
  flat blocks, per-pixel noise) per frame size, and an arrival order in
  runs from one camera (one frame size) at a time, cut into the driver
  calls' chunks. Every seed gets the same sizes and the same mix of runs,
  in another order; the pool is cycled.
"""

import numpy as np
import torch


def seed_generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def host_rng(seed, salt):
    return np.random.default_rng([int(seed) % (2 ** 63), salt])


def synthetic_frames(n, height, width, g, rng, blocks=6, noise=20):
    """[n, height, width, 3] uint8 frames on the generator's device:
    horizontal and vertical ramps, a flat third channel, [blocks] flat
    rectangles of a random colour, per-pixel noise in [-noise, noise)."""

    device = g.device
    yy = torch.linspace(0, 255, height, device=device)[:, None]
    xx = torch.linspace(0, 255, width, device=device)[None, :]
    img = torch.empty((n, height, width, 3), device=device)
    img[..., 0] = xx
    img[..., 1] = yy
    third = torch.randint(64, 192, (n, 1, 1), generator=g, device=device)
    img[..., 2] = third.float()
    colors = torch.randint(0, 255, (n, blocks, 3), generator=g,
                           device=device).float()
    bh, bw = height // 6, width // 6
    ys = rng.integers(0, height - height // 5, (n, blocks))
    xs = rng.integers(0, width - width // 5, (n, blocks))
    for i in range(n):
        for j in range(blocks):
            img[i, ys[i, j]:ys[i, j] + bh, xs[i, j]:xs[i, j] + bw] = \
                colors[i, j]
    img += torch.randint(-noise, noise, (n, height, width, 1), generator=g,
                         device=device).float()
    return img.clamp_(0, 255).to(torch.uint8)


def generate(traffic, seed, device):
    """The cell's inputs: a dict whose keys depend on traffic['items']."""

    if traffic['items'] == 'frames':
        return _frames(traffic, seed, device)
    raise ValueError('unknown traffic items {!r}'.format(traffic['items']))


def _frames(traffic, seed, device):
    """{'pool': {size index: [HWC uint8 numpy]}, 'sizes', 'runs': the size
    index of each run, an endless cycle's first [cycles] periods}."""

    g = seed_generator(seed, device)
    rng = host_rng(seed, 1)
    pool = {}
    for s, (h, w) in enumerate(traffic['frame_sizes']):
        frames = synthetic_frames(traffic['pool_per_size'], h, w, g, rng,
                                  traffic['blocks_per_frame'],
                                  traffic['noise'])
        pool[s] = list(frames.cpu().numpy())
    # One period of runs holds each size's share exactly; each period is
    # shuffled from the seed
    period = [s for s, k in enumerate(traffic['runs_per_period'])
              for _ in range(k)]
    return {'pool': pool, 'sizes': traffic['frame_sizes'],
            'period': period, 'rng': host_rng(seed, 2)}


def frame_chunks(inputs, traffic):
    """Endless driver chunks: lists of (image id, frame, pool key), runs
    of traffic['run_length'] frames of one size, cycling each size's
    pool."""

    rng = inputs['rng']
    cursor = {s: 0 for s in inputs['pool']}
    runs = []
    n_chunk = traffic['chunk']
    n_run = traffic['run_length']
    serial = 0
    while True:
        chunk = []
        while len(chunk) < n_chunk:
            if not runs:
                runs = list(rng.permutation(inputs['period']))
            s = int(runs.pop(0))
            frames = inputs['pool'][s]
            for _ in range(n_run):
                j = cursor[s] % len(frames)
                cursor[s] += 1
                chunk.append(('cam{}/img{:07d}.jpg'.format(s, serial),
                              frames[j], (s, j)))
                serial += 1
        yield chunk

