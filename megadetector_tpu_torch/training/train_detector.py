"""
Detector fine-tuning (counterpart of megadetector_tpu/training/
train_detector.py): the YOLOv5 loss and a train step over the port's
YoloV5 module and optimizer (training/optim.py).

Anchor-ratio target assignment with neighbour-cell expansion, CIoU box
loss, BCE objectness with per-level balancing, BCE classification; targets
pad to a fixed per-image maximum (pad_targets), as in the JAX module,
whose arithmetic this follows op for op:

- x % 1.0 is torch.remainder (the result takes the divisor's sign, as
  jnp.remainder's does), floor and clip of the candidate cells as
  jnp.floor and jnp.clip, then truncation to integers;
- jnp.maximum and jnp.clip split the gradient at ties; torch.maximum does
  the same, so they are written with it (torch.clamp would not);
- the objectness target tobj.at[b, j, i, a].max(v) is a scatter_reduce_
  with 'amax' over zeros (deterministic: a maximum does not depend on the
  order in which duplicates arrive), not index_put_.

The step is eager PyTorch. make_sharded_detector_train_step is its
data-parallel form over a parallel/mesh.DataMesh: one replica of the
model per mesh device, one equal shard of the batch each, on its own
stream. Each shard's loss counts each level's positives over the whole
batch's targets (they depend on the targets and anchors alone), weights
its objectness mean by its share of the batch and scales by the whole
batch's size, so the shards' losses and gradients add up to the whole
batch's: the step computes what the unsharded step computes on the whole
batch, as XLA's sharding does in the JAX step.
"""

import numpy as np
import torch
import torch.nn.functional as F

from megadetector_tpu_torch.parallel.replicas import (
    check_on_first_device, copy_parameters, join, make_replicas, on_stream,
    split_batch, sum_gradients, sum_metrics)

# YOLOv5 hyperparameters (published defaults)
ANCHOR_MATCH_THRESHOLD = 4.0
BOX_GAIN = 0.05
OBJ_GAIN = 1.0
CLS_GAIN = 0.5
# Per-level objectness balance, P3..P6
OBJ_BALANCE = {3: (4.0, 1.0, 0.4), 4: (4.0, 1.0, 0.25, 0.06)}

# Neighbor-cell offsets: center, left, up, right, down
_OFFSETS = np.array([[0, 0], [-1, 0], [0, -1], [1, 0], [0, 1]],
                    np.float32)


def _bce_with_logits(logits, targets):
    return torch.maximum(logits, torch.zeros_like(logits)) - \
        logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def _relu(x):
    """jnp.clip(x, 0) with its gradient (half of it at 0)."""

    return torch.maximum(x, torch.zeros_like(x))


def _ciou(box1, box2, eps=1e-7):
    """
    Complete IoU between center-format boxes [..., 4] (grid units).
    """

    b1x0 = box1[..., 0] - box1[..., 2] / 2
    b1y0 = box1[..., 1] - box1[..., 3] / 2
    b1x1 = box1[..., 0] + box1[..., 2] / 2
    b1y1 = box1[..., 1] + box1[..., 3] / 2
    b2x0 = box2[..., 0] - box2[..., 2] / 2
    b2y0 = box2[..., 1] - box2[..., 3] / 2
    b2x1 = box2[..., 0] + box2[..., 2] / 2
    b2y1 = box2[..., 1] + box2[..., 3] / 2

    inter = _relu(torch.minimum(b1x1, b2x1) - torch.maximum(b1x0, b2x0)) * \
        _relu(torch.minimum(b1y1, b2y1) - torch.maximum(b1y0, b2y0))
    w1, h1 = box1[..., 2], box1[..., 3]
    w2, h2 = box2[..., 2], box2[..., 3]
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    # Enclosing box diagonal and center distance
    cw = torch.maximum(b1x1, b2x1) - torch.minimum(b1x0, b2x0)
    ch = torch.maximum(b1y1, b2y1) - torch.minimum(b1y0, b2y0)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (box2[..., 0] - box1[..., 0]) ** 2 + \
        (box2[..., 1] - box1[..., 1]) ** 2

    v = (4 / (np.pi ** 2)) * \
        (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = v / (v - iou + 1 + eps)
    alpha = alpha.detach()
    return iou - rho2 / c2 - v * alpha


def scatter_max(shape, index, values):
    """jnp.zeros(shape).at[index].max(values): a float32 tensor of
    [shape], zeros, holding at each indexed position the largest of the
    values scattered there (and 0). [index] is one int64 tensor per
    dimension."""

    flat = torch.zeros(shape, dtype=torch.float32, device=values.device)
    offset = index[0]
    for size, idx in zip(shape[1:], index[1:]):
        offset = offset * size + idx
    flat.view(-1).scatter_reduce_(0, offset, values, 'amax')
    return flat


def _candidates(gt_boxes, gt_mask, anchors, s, stride, gh, gw):
    """One level's target geometry: (gxy, gwh) in grid units [B, M, 2]
    and the valid candidates [B, M, na, 5] (a target, one of its matching
    anchors, one of its cell and neighbour offsets)."""

    gxy = gt_boxes[..., 0:2] * s / stride          # [B, M, 2]
    gwh = gt_boxes[..., 2:4] * s / stride          # [B, M, 2]

    # Anchor-ratio matching: [B, M, na]
    r = gwh[:, :, None, :] / (anchors[None, None] + 1e-9)
    ratio = torch.maximum(r, 1.0 / (r + 1e-9)).amax(dim=-1)
    anchor_ok = ratio < ANCHOR_MATCH_THRESHOLD

    # Neighbor-offset validity: [B, M, 5]
    fx = torch.remainder(gxy[..., 0], 1.0)
    fy = torch.remainder(gxy[..., 1], 1.0)
    off_ok = torch.stack([
        torch.ones_like(fx, dtype=torch.bool),
        (fx < 0.5) & (gxy[..., 0] > 1.0),
        (fy < 0.5) & (gxy[..., 1] > 1.0),
        (fx > 0.5) & (gxy[..., 0] < gw - 1.0),
        (fy > 0.5) & (gxy[..., 1] < gh - 1.0),
    ], dim=-1)

    # Candidate set: [B, M, na, 5]
    valid = gt_mask[:, :, None, None] & anchor_ok[:, :, :, None] & \
        off_ok[:, :, None, :]
    return gxy, gwh, valid


def detection_loss(config, model, images, gt_boxes, gt_classes, gt_mask,
                   compute_dtype=torch.float32, batch_targets=None):
    """
    YOLOv5 loss.

    Args:
        config: YoloV5Config
        model: the YoloV5 module (float weights; put in training mode in
            [compute_dtype] here when it is not already)
        images: [B, S, S, 3] float in [0, 1], on the model's device
        gt_boxes: [B, M, 4] cxcywh, normalized to the canvas
        gt_classes: [B, M] int (0-based model classes)
        gt_mask: [B, M] bool (valid targets)
        batch_targets: None, or (gt_boxes, gt_mask) of the whole batch
            when [images] is one shard of it (a sharded step): each
            level's positives are then counted over the whole batch, the
            objectness mean is weighted by the shard's share of the batch
            and the loss scales by the whole batch's size, so that the
            shards' losses add up to the whole batch's

    Returns:
        (total_loss, metrics dict)
    """

    if model.train_dtype != compute_dtype:
        model.set_training(compute_dtype)
    device = images.device
    b, s = images.shape[0], images.shape[1]
    nl = len(config.strides)
    na = config.num_anchors
    nc = config.num_classes
    balance = OBJ_BALANCE[nl]

    head_raw = model(images, decode=False)
    share = None
    b_total = b
    if batch_targets is not None:
        all_boxes, all_mask = batch_targets
        b_total = int(all_boxes.shape[0])
        share = b / b_total

    lbox = 0.0
    lobj = 0.0
    lcls = 0.0
    total_pos = 0.0
    offsets = torch.from_numpy(_OFFSETS).to(device)

    for i_level, raw in enumerate(head_raw):
        stride = float(config.strides[i_level])
        gh, gw = raw.shape[1], raw.shape[2]
        raw = raw.reshape(b, gh, gw, na, 5 + nc).float()

        anchors = torch.as_tensor(config.anchors[i_level], dtype=torch.float32,
                                  device=device) / stride  # [na, 2]

        # GT in this level's grid units, and the candidate set
        gxy, gwh, valid = _candidates(gt_boxes, gt_mask, anchors, s, stride,
                                      gh, gw)

        cell = torch.floor(gxy[:, :, None, None, :] -
                           offsets[None, None, None] * 0.5)
        # cell is [B, M, 1, 5, 2]; broadcast to the full candidate shape
        gi = torch.clamp(cell[..., 0], 0, gw - 1).expand(
            valid.shape).to(torch.int64)
        gj = torch.clamp(cell[..., 1], 0, gh - 1).expand(
            valid.shape).to(torch.int64)

        # Flatten candidates
        b_idx = torch.arange(b, device=device)[:, None, None, None].expand(
            valid.shape)
        a_idx = torch.arange(na, device=device)[None, None, :, None].expand(
            valid.shape)
        vb, va = b_idx.reshape(-1), a_idx.reshape(-1)
        vj, vi = gj.reshape(-1), gi.reshape(-1)
        vmask = valid.reshape(-1).to(torch.float32)

        # Targets per candidate
        t_xy = gxy[:, :, None, None, :].expand(
            valid.shape + (2,)).reshape(-1, 2)
        t_wh = gwh[:, :, None, None, :].expand(
            valid.shape + (2,)).reshape(-1, 2)
        t_cls = gt_classes[:, :, None, None].expand(valid.shape).reshape(-1)
        cand_anchor = anchors[va]

        # Gather predictions at candidate cells
        p = raw[vb, vj, vi, va]                         # [N, 5+nc]
        p_sig = torch.sigmoid(p)
        pxy = p_sig[:, 0:2] * 2.0 - 0.5 + \
            torch.stack([vi, vj], dim=-1).to(torch.float32)
        pwh = torch.square(p_sig[:, 2:4] * 2.0) * cand_anchor
        pred_box = torch.cat([pxy, pwh], dim=-1)
        target_box = torch.cat([t_xy, t_wh], dim=-1)

        ciou = _ciou(pred_box, target_box)
        if batch_targets is None:
            n_pos = torch.clamp(vmask.sum(), min=1.0)
        else:
            # The whole batch's positives (exact: a count)
            n_pos = torch.clamp(_candidates(
                all_boxes, all_mask, anchors, s, stride, gh,
                gw)[2].to(torch.float32).sum(), min=1.0)
        lbox = lbox + torch.sum((1.0 - ciou) * vmask) / n_pos

        # Objectness targets: scatter-max the detached CIoU at the
        # positive cells
        tobj = scatter_max((b, gh, gw, na), (vb, vj, vi, va),
                           _relu(ciou.detach()) * vmask)
        obj = torch.mean(_bce_with_logits(raw[..., 4], tobj))
        if share is not None:
            obj = obj * share
        lobj = lobj + balance[i_level] * obj

        # Classification BCE at positives
        if nc > 1:
            one_hot = F.one_hot(t_cls.to(torch.int64), nc).to(torch.float32)
            cls_bce = _bce_with_logits(p[:, 5:], one_hot).mean(dim=-1)
            lcls = lcls + torch.sum(cls_bce * vmask) / n_pos

        total_pos = total_pos + vmask.sum()

    loss = (BOX_GAIN * lbox + OBJ_GAIN * lobj +
            CLS_GAIN * (nc / 80.0) * lcls) * b_total
    metrics = {'loss': loss, 'box_loss': lbox, 'obj_loss': lobj,
               'cls_loss': lcls, 'n_positives': total_pos}
    return loss, metrics


def _as_tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def make_detector_train_step(config, model, optimizer,
                             compute_dtype=torch.float32):
    """
    (images_u8 [B,S,S,3], gt_boxes, gt_classes, gt_mask) -> metrics dict
    (detached tensors): the loss of [model] in [compute_dtype], its
    gradients, and one step of [optimizer] (training/optim.Optimizer over
    the model's parameters), in place. Inputs may be numpy arrays or
    tensors; they are moved to the model's device.
    """

    model.set_training(compute_dtype)

    def train_step(images_u8, gt_boxes, gt_classes, gt_mask):
        device = next(model.parameters()).device
        x = _as_tensor(images_u8, device).to(torch.float32) / 255.0
        loss, metrics = detection_loss(
            config, model, x, _as_tensor(gt_boxes, device, torch.float32),
            _as_tensor(gt_classes, device, torch.int64),
            _as_tensor(gt_mask, device, torch.bool), compute_dtype)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return {k: v.detach() if isinstance(v, torch.Tensor) else
                torch.tensor(v) for k, v in metrics.items()}

    return train_step


def make_sharded_detector_train_step(config, model, optimizer, mesh,
                                     batch_axis='data',
                                     compute_dtype=torch.float32):
    """
    make_detector_train_step over [mesh] (parallel/mesh.DataMesh): the
    same call and metrics, computing what the unsharded step computes on
    the whole batch. [model] (on the mesh's first device, ValueError
    otherwise) is the first replica and [optimizer] steps its
    parameters; every other mesh device holds a copy. Each step copies
    [model]'s parameters into the copies, splits the batch into equal
    contiguous shards (the batch must divide by the mesh size: ValueError
    otherwise), runs each replica's loss
    (detection_loss with the whole batch's targets) and backward on its
    stream, sums the gradients onto [model] in mesh order (the same bits
    on every run) and takes one optimizer step; the global-norm clip
    sees the summed gradient.
    """

    if batch_axis not in mesh.axis_names:
        raise ValueError('Mesh axes are {}; no axis {!r}'.format(
            mesh.axis_names, batch_axis))
    check_on_first_device(model, mesh)
    model.set_training(compute_dtype)
    replicas = make_replicas(model, mesh.device_list())

    def train_step(images_u8, gt_boxes, gt_classes, gt_mask):
        copy_parameters(replicas)
        shards, _ = split_batch((images_u8, gt_boxes, gt_classes, gt_mask),
                                len(replicas))
        parts = []
        for r, (im, boxes, classes, mask) in zip(replicas, shards):
            d = r.device
            with on_stream(r.stream):
                x = _as_tensor(im, d).to(torch.float32) / 255.0
                loss, metrics = detection_loss(
                    config, r.model, x, _as_tensor(boxes, d, torch.float32),
                    _as_tensor(classes, d, torch.int64),
                    _as_tensor(mask, d, torch.bool), compute_dtype,
                    batch_targets=(_as_tensor(gt_boxes, d, torch.float32),
                                   _as_tensor(gt_mask, d, torch.bool)))
                loss.backward()
            parts.append(metrics)
        join(replicas)
        sum_gradients(replicas)
        optimizer.step()
        return sum_metrics(parts, replicas[0].device)

    return train_step


def pad_targets(boxes_list, classes_list, max_targets=32):
    """
    Pad per-image target lists to fixed [B, M, ...] arrays.

    Args:
        boxes_list: list (len B) of [n_i, 4] cxcywh-normalized arrays
        classes_list: list of [n_i] int arrays
    Returns:
        (gt_boxes [B, M, 4] f32, gt_classes [B, M] i32, gt_mask [B, M])
    """

    b = len(boxes_list)
    gt_boxes = np.zeros((b, max_targets, 4), np.float32)
    # Padded slots keep a tiny nonzero box so CIoU math stays finite
    gt_boxes[..., 2:] = 1e-3
    gt_classes = np.zeros((b, max_targets), np.int32)
    gt_mask = np.zeros((b, max_targets), bool)
    for i, (boxes, classes) in enumerate(zip(boxes_list, classes_list)):
        n = min(len(boxes), max_targets)
        if n > 0:
            gt_boxes[i, :n] = np.asarray(boxes, np.float32)[:n]
            gt_classes[i, :n] = np.asarray(classes, np.int32)[:n]
            gt_mask[i, :n] = True
    return gt_boxes, gt_classes, gt_mask
