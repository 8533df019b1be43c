"""
Class-aware greedy NMS with fixed-shape outputs (counterpart of
megadetector_tpu/ops/nms.py).

Per-class suppression uses the coordinate-offset trick: each class's boxes
shift to a disjoint region of the plane, so one class-agnostic pass is
per-class exact. The greedy keep mask comes from ops/cuda_nms
(the CUDA kernel on the card, its plain version on the CPU). Outputs are
compacted to [B, max_det] with a validity mask, survivors in descending
score order, exact ties toward the lower candidate index.
"""

import torch

from megadetector_tpu_torch.ops.cuda_nms import (
    greedy_nms_keep,
    pairwise_iou_xyxy as _pairwise_iou_xyxy,  # noqa: F401  (JAX name)
)
from megadetector_tpu_torch.ops.decode import topk_lower_index_first

# Class-offset floor: the offset is max(this, per-image max valid
# coordinate + 1), so shifted classes never overlap at any canvas size
_CLASS_OFFSET = 8192.0


def cxcywh_to_xyxy(boxes):
    """[..., 4] (cx, cy, w, h) -> (x0, y0, x1, y1)."""

    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2.0, cy - h / 2.0,
                        cx + w / 2.0, cy + h / 2.0], dim=-1)


def nms_on_candidates(cands, iou_thres, max_det=300, class_agnostic=False):
    """
    Suppression + compaction over an already-selected candidate set (the
    output of ops/decode.select_topk_candidates, or batched_nms's own
    selection).

    Args:
        cands: dict with 'boxes_cxcywh' [B, K, 4] float32 canvas pixels,
            'scores' [B, K] float32 descending, 'classes' [B, K] int32,
            'valid' [B, K] bool, optional 'n_candidates' [B]
        iou_thres: suppression threshold
        max_det: detections kept per image
        class_agnostic: suppress across classes when True

    Returns:
        dict of 'boxes' [B, max_det, 4] xyxy, 'scores', 'classes',
        'valid' [B, max_det] (and 'n_candidates' passed through).
    """

    boxes = cxcywh_to_xyxy(cands['boxes_cxcywh'])
    scores = cands['scores']
    classes = cands['classes']
    valid = cands['valid']

    if class_agnostic:
        offset_boxes = boxes
    else:
        # Invalid rows may hold garbage coordinates; `valid` keeps them
        # out of both the offset and the suppression
        masked = torch.where(valid[..., None], boxes, 0.0)
        offset = torch.clamp(masked.amax(dim=(1, 2)) + 1.0,
                             min=_CLASS_OFFSET)
        offset_boxes = boxes + classes.float()[..., None] * \
            offset[:, None, None]

    keep = greedy_nms_keep(offset_boxes.contiguous(), valid.contiguous(),
                           iou_thres)

    kept_scores = torch.where(keep, scores, -1.0)
    final_scores, order = topk_lower_index_first(
        kept_scores, min(max_det, kept_scores.shape[1]))
    final_valid = final_scores > 0.0
    out = {
        'boxes': torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
        'scores': torch.where(final_valid, final_scores, 0.0),
        'classes': torch.gather(classes, 1, order),
        'valid': final_valid,
    }
    if 'n_candidates' in cands:
        out['n_candidates'] = cands['n_candidates']
    return out


def batched_nms(pred, conf_thres, iou_thres, max_det=300,
                pre_nms_topk=1024, class_agnostic=False):
    """
    Full post-processing of decoded predictions: candidate selection +
    per-class NMS.

    Args:
        pred: [B, A, 5+C] decoded predictions (cx, cy, w, h in canvas
            pixels; objectness; per-class confidences)
        conf_thres: confidence floor on objectness AND on the final
            objectness * class score (compared in float32)
        iou_thres / max_det / class_agnostic: as nms_on_candidates
        pre_nms_topk: candidate set size entering NMS

    Returns:
        as nms_on_candidates.
    """

    num_classes = pred.shape[-1] - 5
    thr = torch.full((), conf_thres, dtype=torch.float32, device=pred.device)
    obj = pred[..., 4]
    cls_conf = pred[..., 5:] * pred[..., 4:5]
    best_score = cls_conf.amax(dim=-1)
    # argmax returns the first of equal maxima (the jnp.argmax rule)
    best_class = torch.argmax(cls_conf, dim=-1).to(torch.int32)

    valid = (obj > thr) & (best_score > thr)
    ranked = torch.where(valid, best_score, -1.0)
    top_scores, top_idx = topk_lower_index_first(
        ranked, min(pre_nms_topk, pred.shape[1]))
    cands = {
        'boxes_cxcywh': torch.gather(
            pred[..., :4], 1, top_idx[..., None].expand(-1, -1, 4)),
        'scores': top_scores,
        'classes': torch.gather(best_class, 1, top_idx),
        'valid': top_scores > 0.0,
        'n_candidates': valid.sum(dim=-1, dtype=torch.int32),
    }
    return nms_on_candidates(
        cands, iou_thres, max_det=max_det,
        class_agnostic=(class_agnostic or num_classes == 1))


def nms_xyxy(boxes, scores, iou_thres, max_det=300):
    """
    Plain class-agnostic NMS over explicit boxes [N, 4] xyxy and scores
    [N]. Returns (keep_indices [min(max_det, N)], valid) — indices into
    the input, sorted by descending score.
    """

    n = boxes.shape[0]
    ranked = torch.where(scores > 0, scores, -1.0)
    top_scores, order = topk_lower_index_first(ranked, n)
    keep = greedy_nms_keep(boxes[order][None].float().contiguous(),
                           (top_scores > 0)[None].contiguous(),
                           iou_thres)[0]
    kept_scores = torch.where(keep, top_scores, -1.0)
    final_scores, sub_order = topk_lower_index_first(kept_scores,
                                                     min(max_det, n))
    return order[sub_order], final_scores > 0
