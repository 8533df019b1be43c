"""
Candidate selection straight from the raw detect-head logits
(counterpart of megadetector_tpu/ops/decode.py, global single-top-k form).

Per pyramid level the ranking score obj * best_cls is computed from the
obj/cls logits only; the level maps are concatenated in level order and
one top-k picks the K global winners; only their rows are gathered and
decoded. The flat index is level offset + ((gy*W + gx)*na + a), so grid
position and anchor are recovered arithmetically.

Tie rule: jax.lax.top_k breaks exact ties toward the lower flat index,
and the stored goldens depend on it. torch.topk on CUDA promises no tie
order, so top-k here is a stable descending sort sliced to k: a stable
sort keeps equal keys in input order, i.e. lower index first.

Nothing here copies from the host or reads a device value back, so the
selection can be captured into a CUDA graph: constants come from
device_constant, thresholds are filled on the device.
"""

import torch

from megadetector_tpu_torch.device import device_constant


def topk_lower_index_first(values, k):
    """
    (values, indices) of the k largest float32 entries along the last
    dim, sorted descending, exact ties resolved toward the lower index:
    the jax.lax.top_k contract, which also orders -0.0 below +0.0 (a
    total order on the float bits, compared here as int32 keys).
    """

    bits = values.contiguous().view(torch.int32)
    keys = bits ^ ((bits >> 31) & 0x7fffffff)
    _, order = torch.sort(keys, dim=-1, descending=True, stable=True)
    order = order[..., :k]
    return torch.gather(values, -1, order), order


def select_topk_candidates(head_outputs, anchors, strides, num_classes,
                           conf_thres, k):
    """
    Args:
        head_outputs: list of raw per-level NHWC head tensors
            [B, H_l, W_l, na*(5+nc)]
        anchors: [levels, na, 2] anchor sizes in pixels (array-like)
        strides: per-level stride tuple
        num_classes: nc
        conf_thres: confidence floor (objectness AND obj*cls, as in the
            reference filter chain); compared in float32
        k: candidate count to keep across all levels

    Returns:
        dict with float32 'boxes_cxcywh' [B, K, 4] (canvas pixels),
        'scores' [B, K], 'classes' [B, K] int32, 'valid' [B, K] bool,
        score-sorted descending, and 'n_candidates' [B] int32 (the
        above-floor count, so the caller can see top-k truncation).
    """

    no = 5 + num_classes
    device = head_outputs[0].device
    b = head_outputs[0].shape[0]
    anchors = device_constant(anchors, torch.float32, device)
    na = anchors.shape[1]
    thr = torch.full((), conf_thres, dtype=torch.float32, device=device)

    xs, ranked_list, level_offsets, level_widths = [], [], [], []
    n_above = None
    offset = 0
    for raw in head_outputs:
        _, h, w, _ = raw.shape
        n = h * w * na
        x = raw.reshape(b, n, no)
        # sigmoid is monotone: the class max runs on the raw logits and
        # only the winning logit is sigmoided
        obj = torch.sigmoid(x[..., 4].float())
        best_cls = torch.sigmoid(x[..., 5:].amax(dim=-1).float())
        score = obj * best_cls
        valid = (obj > thr) & (score > thr)
        lvl_count = valid.sum(dim=-1, dtype=torch.int32)
        n_above = lvl_count if n_above is None else n_above + lvl_count
        ranked_list.append(torch.where(valid, score, -1.0))
        xs.append(x)
        level_offsets.append(offset)
        level_widths.append(w)
        offset += n

    ranked = torch.cat(ranked_list, dim=1)
    x_all = torch.cat(xs, dim=1)
    top_scores, top_idx = topk_lower_index_first(ranked, min(k, offset))

    rows = torch.gather(x_all, 1,
                        top_idx[..., None].expand(-1, -1, no)).float()
    # Class argmax in sigmoid space: two logits above ~16.6 both round to
    # 1.0, and the reference then picks the LOWER class index
    # (torch.argmax returns the first maximal index)
    classes = torch.argmax(torch.sigmoid(rows[..., 5:]),
                           dim=-1).to(torch.int32)
    boxp = torch.sigmoid(rows[..., :4])

    offsets = device_constant(level_offsets, top_idx.dtype, device)
    widths = device_constant(level_widths, top_idx.dtype, device)
    level = (top_idx[..., None] >= offsets[1:]).sum(dim=-1)
    local = top_idx - offsets[level]
    a_idx = local % na
    cell = local // na
    w_l = widths[level]
    gx = (cell % w_l).float()
    gy = (cell // w_l).float()
    st = device_constant(strides, torch.float32, device)[level]
    aw = anchors[level, a_idx, 0]
    ah = anchors[level, a_idx, 1]

    cx = (boxp[..., 0] * 2.0 - 0.5 + gx) * st
    cy = (boxp[..., 1] * 2.0 - 0.5 + gy) * st
    bw = torch.square(boxp[..., 2] * 2.0) * aw
    bh = torch.square(boxp[..., 3] * 2.0) * ah

    return {
        'boxes_cxcywh': torch.stack([cx, cy, bw, bh], dim=-1),
        'scores': top_scores,
        'classes': classes,
        'valid': top_scores > 0.0,
        'n_candidates': n_above,
    }


def merge_candidates(cands_list, k):
    """
    Merge candidate sets (each with 'boxes_cxcywh' [B, K_i, 4], 'scores'
    [B, K_i], 'classes' [B, K_i]) into one score-sorted top-k set, ties
    toward the earlier set / lower index.
    """

    boxes = torch.cat([p['boxes_cxcywh'] for p in cands_list], dim=1)
    scores = torch.cat([p['scores'] for p in cands_list], dim=1)
    classes = torch.cat([p['classes'] for p in cands_list], dim=1)

    final_scores, order = topk_lower_index_first(
        scores, min(k, scores.shape[1]))
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    classes = torch.gather(classes, 1, order)
    return {
        'boxes_cxcywh': boxes,
        'scores': final_scores,
        'classes': classes,
        'valid': final_scores > 0.0,
    }
