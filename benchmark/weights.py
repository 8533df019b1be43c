"""
Weights from the seed, made on the device in one draw per network, and
the checkpoint files the program loads (the .npz + metadata.json layout of
converted MegaDetector checkpoints, stored in float16 as the published
checkpoints are).

- YOLOv5 ('detector' recipe): He-normal convs, zero biases; then, on the
  plain reference forward in float32, every conv but the detect heads is
  rescaled in forward order so that its output has std 1 on one synthetic
  frame at a small canvas (random BatchNorm-free weights otherwise grow
  the activations until every box scores 1.0); then the detect heads per
  output channel on a few frames of each size at the full canvas: box
  outputs to std box_std, class logits to std logit_std, objectness to
  logit_std around an offset solved so that the reference keeps
  detections_per_image boxes an image, on average over the traffic's
  whole frame pool, above the driver's confidence floor. This is the
  recipe of chip_smoke.py's phase 28 (_workflow_checkpoint), with the
  offset solved instead of fixed.

Both sides get the same numbers: the reference reads the float16-rounded
tree that the checkpoint holds.
"""

import json
import math
import os

import numpy as np
import torch

from benchmark.reference import yolov5 as ref_yolov5
from benchmark.traffic import seed_generator


def _tree(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        keys = path.split('/')
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def _draw(shapes, g, device):
    """{path + '/w': tensor, path + '/b': zeros} from one normal draw (He
    std per conv)."""

    normal = list(shapes)
    sizes = [int(np.prod(shapes[p])) for p in normal]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    offset = 0
    for p, n in zip(normal, sizes):
        k0, k1, c_in, _ = shapes[p]
        std = math.sqrt(2.0 / (k0 * k1 * c_in))
        out[p + '/w'] = flat[offset:offset + n].view(shapes[p]) * std
        out[p + '/b'] = torch.zeros(shapes[p][-1], device=device)
        offset += n
    return out


def _half(flat):
    """Every leaf rounded to float16 and back to float32 (the stored
    checkpoint's numbers)."""

    return {k: v.half().float() for k, v in flat.items()}


def write_checkpoint(flat, metadata, path):
    """Save {path: tensor} as the converted-checkpoint .npz (float16) with
    its metadata.json beside it."""

    np.savez(path, **{k: v.half().cpu().numpy() for k, v in flat.items()})
    with open(os.path.splitext(path)[0] + '.metadata.json', 'w') as f:
        json.dump(metadata, f)
    return path


def detector_weights(config, seed, device, pool):
    """(float32 tree on [device], flat leaves) of the YOLOv5 recipe, rescaled
    on the first frame of the traffic's [pool] (the small canvas) and its
    first calibration_frames_per_size frames of each size (the heads)."""

    recipe = config['weights']
    g = seed_generator(seed, device)
    flat = _draw(ref_yolov5.param_shapes(config), g, device)
    params = _tree(flat)
    small = pool[0][0]
    frames = [pool[s][j] for s in sorted(pool)
              for j in range(recipe['calibration_frames_per_size'])]
    size = int(config['image_size'])
    stride = max(ref_yolov5.strides(config))

    def batch(imgs, side):
        x = np.stack([ref_yolov5.letterbox(im, side, stride)[0]
                      for im in imgs])
        return torch.from_numpy(x).to(device).permute(0, 3, 1, 2).float() \
            / 255.0

    def rescale(node, x, s, pad, act):
        y = ref_yolov5.conv_node(x, node, s, pad, act)
        if not act:
            return y
        scale = 1.0 / max(float(y.std()), 1e-30)
        node['w'].mul_(scale)
        node['b'].mul_(scale)
        return ref_yolov5.conv_node(x, node, s, pad, act)

    detect = params['l{}'.format(len(ref_yolov5.layer_table(config)) - 1)]
    with torch.no_grad():
        ref_yolov5.forward(config, params, batch([small],
                                                 recipe['small_canvas']),
                           hook=rescale)
        xs = [batch([im], size) for im in frames]
        per_frame = [ref_yolov5.forward(config, params, x) for x in xs]
        no = ref_yolov5.num_outputs(config)
        for lvl in range(len(per_frame[0])):
            out = torch.cat([h[lvl].permute(1, 0, 2, 3).reshape(
                h[lvl].shape[1], -1) for h in per_frame], 1)
            kind = torch.arange(out.shape[0], device=device) % no
            target = torch.where(kind < 4, recipe['box_std'],
                                 recipe['logit_std'])
            scale = target / out.std(dim=1).clamp_min(1e-30)
            node = detect['m{}'.format(lvl)]
            node['w'].mul_(scale)
            node['b'].copy_(-out.mean(dim=1) * scale)
        offset = _solve_objectness(
            config, params, [f for s in sorted(pool) for f in pool[s]],
            recipe)
        for lvl in range(len(per_frame[0])):
            node = detect['m{}'.format(lvl)]
            kind = torch.arange(node['b'].shape[0], device=device) % no
            node['b'].add_(torch.where(kind == 4, offset, 0.0))
    flat = _half(flat)
    return _tree(flat), flat


def _solve_objectness(config, params, frames, recipe, batch=8):
    """The objectness offset (bisection) at which the reference keeps
    recipe['detections_per_image'] boxes an image, on average over
    [frames] (the whole pool the window cycles), above
    recipe['conf_floor']."""

    size = int(config['image_size'])
    stride = max(ref_yolov5.strides(config))
    no = ref_yolov5.num_outputs(config)
    floor = recipe['conf_floor']
    groups = {}
    for im in frames:
        groups.setdefault(ref_yolov5.canvas_shape(im.shape[:2], size, stride),
                          []).append(im)
    # Per frame: (objectness logits, best class score, class, boxes)
    rows = []
    for imgs in groups.values():
        for s in range(0, len(imgs), batch):
            x = torch.from_numpy(np.stack([
                ref_yolov5.letterbox(im, size, stride)[0]
                for im in imgs[s:s + batch]])).to(params['l0']['w'].device)
            heads = ref_yolov5.forward(
                config, params, x.permute(0, 3, 1, 2).float() / 255.0)
            pred = ref_yolov5.decode(config, heads)
            # The raw objectness logits, in decode's row order
            raw = torch.cat([h.view(h.shape[0], -1, no, h.shape[2],
                                    h.shape[3]).permute(0, 1, 3, 4, 2)
                             .reshape(h.shape[0], -1, no)[..., 4]
                             for h in heads], 1)
            for p, z in zip(pred, raw):
                best, cls = p[:, 5:].max(1)
                xy, wh = p[:, :2], p[:, 2:4]
                rows.append((z, best, cls, torch.cat([xy - wh / 2,
                                                      xy + wh / 2], 1)))
    target = recipe['detections_per_image'] * len(rows)

    def count(offset):
        n = 0
        for z, best, cls, boxes in rows:
            obj = torch.sigmoid(z + offset)
            conf = obj * best
            keep = (obj > floor) & (conf > floor)
            if int(keep.sum()) > 3000:
                return float('inf')
            b = boxes[keep].cpu().numpy().astype(np.float64)
            c = cls[keep].cpu().numpy().astype(np.float64)
            n += len(ref_yolov5.greedy_nms(b + c[:, None] * 7680,
                                           conf[keep].cpu().numpy(), 0.45))
        return n

    lo, hi = -30.0, 10.0
    for _ in range(16):
        mid = (lo + hi) / 2
        if count(mid) > target:
            hi = mid
        else:
            lo = mid
    return (lo + hi) / 2

