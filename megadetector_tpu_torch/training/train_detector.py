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

The step is eager PyTorch; the data-parallel make_sharded_detector_train
_step waits for multi-GPU (ROADMAP A8).
"""

import numpy as np
import torch
import torch.nn.functional as F

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


def detection_loss(config, model, images, gt_boxes, gt_classes, gt_mask,
                   compute_dtype=torch.float32):
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

        # GT in this level's grid units
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
        n_pos = torch.clamp(vmask.sum(), min=1.0)
        lbox = lbox + torch.sum((1.0 - ciou) * vmask) / n_pos

        # Objectness targets: scatter-max the detached CIoU at the
        # positive cells
        tobj = scatter_max((b, gh, gw, na), (vb, vj, vi, va),
                           _relu(ciou.detach()) * vmask)
        lobj = lobj + balance[i_level] * torch.mean(
            _bce_with_logits(raw[..., 4], tobj))

        # Classification BCE at positives
        if nc > 1:
            one_hot = F.one_hot(t_cls.to(torch.int64), nc).to(torch.float32)
            cls_bce = _bce_with_logits(p[:, 5:], one_hot).mean(dim=-1)
            lcls = lcls + torch.sum(cls_bce * vmask) / n_pos

        total_pos = total_pos + vmask.sum()

    loss = (BOX_GAIN * lbox + OBJ_GAIN * lobj +
            CLS_GAIN * (nc / 80.0) * lcls) * b
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
