"""
The comparison that decides `correct`: the program's answers against the
plain reference's, number by number, each against its limit.

Detections (MegaDetector format): DetectionTally. The reference lists
every box above a floor below the driver's (greedy NMS keeps a box or
not by the boxes scored above it alone, so a lower floor only adds boxes
below), so a program box near the driver's floor finds its twin.
"""

import math

import numpy as np


def _iou(a, b, pad):
    """IoU of xyxy boxes a [4] and b [N, 4], each grown by [pad] on every
    side (a box clipped to a line at the image's edge keeps an area)."""

    a = a + np.array([-pad, -pad, pad, pad])
    b = b + np.array([-pad, -pad, pad, pad])
    ix = np.clip(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), 0,
                 None)
    iy = np.clip(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), 0,
                 None)
    inter = ix * iy
    union = (a[2] - a[0]) * (a[3] - a[1]) + \
        (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter
    return inter / np.maximum(union, 1e-12)


def md_to_xyxy(det):
    """(category, conf, xyxy) of an MD detection dict (normalized
    [x, y, w, h])."""

    x, y, w, h = det['bbox']
    return det['category'], float(det['conf']), [x, y, x + w, y + h]


class DetectionTally:
    """
    The program's detections against the reference's, image by image.

    A program detection (category c, conf p, box b) and a reference box
    (best category, conf q, box, every category's score s) are twins when
    their IoU, each grown by [pad] (a pixel: the driver rounds boxes to
    whole pixels), is at least the NMS threshold, and the reference scores
    c at least half its best (a category swap at a near tie is a twin, a
    wrong category is not); close twins when, besides, p and s_c are
    within a factor of [conf_ratio] of each other (the confidence users
    threshold on). Counted, for twins and for close twins apart (a box
    with no twin has no close twin either):
    - missed: reference boxes scored at least [hi] (among its first
      max_det) with no twin among the program's detections;
    - extra: program detections scored at least [hi] with no twin among
      the reference's boxes (listed down to its lower floor);
    and, for the record, the log-confidence error |log p - log s_c| of
    each program detection scored at least [hi], against its closest
    twin.
    """

    def __init__(self, hi, iou_thres=0.45, max_det=300, conf_ratio=2.0):
        self.hi, self.iou_thres, self.max_det = hi, iou_thres, max_det
        self.log_ratio = math.log(conf_ratio)
        self.n_ref = self.n_program = 0
        self.missed = self.extra = 0
        self.missed_close = self.extra_close = 0
        self.errors = []

    def add(self, program, reference, pad):
        pc = [d[0] for d in program]
        pp = np.array([d[1] for d in program], np.float64)
        pb = np.array([d[2] for d in program], np.float64).reshape(-1, 4)
        rb = np.array([r[2] for r in reference], np.float64).reshape(-1, 4)
        rq = np.array([r[1] for r in reference], np.float64)
        rs = np.array([r[3] for r in reference], np.float64)
        twin = np.zeros((len(pc), len(rq)), bool)
        gap = np.full((len(pc), len(rq)), np.inf)
        for i, c in enumerate(pc):
            if len(rq):
                k = int(c) - 1
                twin[i] = (_iou(pb[i], rb, pad) >= self.iou_thres) & \
                    (rs[:, k] >= 0.5 * rq)
                gap[i] = np.abs(np.log(pp[i]) -
                                np.log(np.maximum(rs[:, k], 1e-30)))
        close = twin & (gap <= self.log_ratio)
        for i in np.flatnonzero(pp >= self.hi):
            self.n_program += 1
            self.extra += int(not twin[i].any())
            self.extra_close += int(not close[i].any())
            if twin[i].any():
                self.errors.append(float(np.min(gap[i, twin[i]])))
        must = (rq >= self.hi) & (np.arange(len(rq)) < self.max_det)
        self.n_ref += int(must.sum())
        self.missed += int((must & ~twin.any(axis=0)).sum())
        self.missed_close += int((must & ~close.any(axis=0)).sum())

    def numbers(self):
        """The compared number, conf_off_share: the boxes counted on both
        sides with no close twin on the other, in %; and, for the record,
        unmatched_share, the same with twins, the missed and the extra
        apart, and the log-confidence error's median, 90th percentile and
        largest."""

        err = np.sort(self.errors) if self.errors else np.zeros(1)
        n = max(self.n_ref + self.n_program, 1)
        return {
            'conf_off_share': 100.0 * (self.missed_close +
                                       self.extra_close) / n,
        }, {
            'reference_boxes': self.n_ref, 'program_boxes': self.n_program,
            'unmatched_share': 100.0 * (self.missed + self.extra) / n,
            'missed_share': 100.0 * self.missed / max(self.n_ref, 1),
            'extra_share': 100.0 * self.extra / max(self.n_program, 1),
            'logconf_median': float(np.median(err)),
            'logconf_p90': float(np.quantile(err, 0.9)),
            'logconf_max': float(err[-1]),
        }

def verdict(numbers, limits):
    """(correct, lines): every number at or under its limit; one
    'name value limit' line each, numbers unrounded."""

    lines = []
    ok = True
    for name, value in numbers.items():
        limit = limits[name]
        ok = ok and value <= limit
        lines.append('{} {!r} limit {!r}'.format(name, value, limit))
    return ok, lines
