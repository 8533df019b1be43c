"""
The greedy-NMS kernel's design, checked on the CPU (csrc/nms.cu; no card
needed).

- The division-free IoU test (ops/cuda_nms.py threshold_split): the
  float32 bounds decide most pairs and never contradict the exact test,
  and in float64 inter - m * u has the sign of RN_f32(inter / u) -
  thresh's comparison, on random pairs and on pairs one float32 step
  either side of m * u, including exact ties.
- The mask pass's triangular block index: every upper-triangle tile pair
  exactly once, in row order.
- A numpy emulation of both passes, written from the source: the mask
  words of the launched tiles (the unwritten words hold random bits), the
  sweep's units (chunk, segment) through a two-stage ring whose rows past
  K keep stale bytes, the resolution of each chunk row by row over its
  diagonal words, and the OR of the kept rows' later words. It
  must give greedy_nms_keep_reference's keep mask, also with stages
  narrower than the kernel's, so the segment walk runs.
"""

import math
import os

import numpy as np
import pytest
import torch

from megadetector_tpu_torch.ops import cuda_nms

THRESHOLDS = (0.45, 0.5, 0.65, 0.0)


def _ieee_over(inter, uni, thresh):
    """The plain version's test: float32 division, rounded, then '>'."""

    return (np.float32(inter) / np.float32(uni)) > np.float32(thresh)


def _exact_over(inter, uni, thresh):
    """The kernel's exact test: the sign of inter - m * u in float64 (m * u
    is exact, so the one rounding keeps the sign, as the kernel's fma
    does)."""

    m, _, _, tie_up = cuda_nms.threshold_split(thresh)
    d = np.asarray(inter, np.float64) - m * np.asarray(uni, np.float64)
    return d >= 0 if tie_up else d > 0


def _fast_path(inter, uni, thresh):
    """The kernel's float32 bounds: (proved over, proved not over)."""

    _, m_hi, m_lo, _ = cuda_nms.threshold_split(thresh)
    inter = np.asarray(inter, np.float32)
    uni = np.asarray(uni, np.float32)
    with np.errstate(over='ignore', invalid='ignore'):
        return inter > uni * np.float32(m_hi), inter < uni * np.float32(m_lo)


def _predicate_over(inter, uni, thresh):
    """The kernel's whole test: the bounds, then the exact test for the
    pairs they leave open."""

    over, under = _fast_path(inter, uni, thresh)
    unsure = ~over & ~under
    return over | (unsure & _exact_over(inter, uni, thresh))


#%% The division-free predicate


@pytest.mark.parametrize('thresh', THRESHOLDS)
def test_predicate_equals_division_on_random_pairs(thresh):
    rng = np.random.RandomState(int(thresh * 100))
    n = 1_000_000
    uni = (rng.uniform(0.5, 2.0, n) * 10.0 ** rng.randint(-8, 6, n)).astype(
        np.float32)
    # IoU spread over [0, 1], denser near the threshold
    spread = rng.rand(n) < 0.5
    ratio = np.where(spread, rng.rand(n), thresh + rng.uniform(-1e-5, 1e-5, n))
    inter = (uni * np.clip(ratio, 0, 1)).astype(np.float32)
    with np.errstate(under='ignore'):
        want = _ieee_over(inter, uni, thresh)
        assert np.array_equal(want, _exact_over(inter, uni, thresh))
        assert np.array_equal(want, _predicate_over(inter, uni, thresh))
        over, under = _fast_path(inter, uni, thresh)
    # the bounds never contradict, and leave few of the spread IoUs to the
    # exact test (those within ~2^-19 of the threshold)
    assert not (over & ~want).any() and not (under & want).any()
    unsure = float((~over & ~under)[spread].mean())
    if thresh > 0:
        assert unsure < 1e-4, unsure
    else:
        assert unsure == 1.0  # |m| = 2^-150: every pair takes the exact test


@pytest.mark.parametrize('thresh', THRESHOLDS)
def test_predicate_equals_division_at_the_rounding_point(thresh):
    """inter one float32 step either side of m * u, and on it where it is
    a float32 (exact ties need few bits in m: thresh 0 has m = 2^-150)."""

    rng = np.random.RandomState(7)
    m = cuda_nms.threshold_split(thresh)[0]
    uni = np.concatenate([
        rng.uniform(1e-9, 1e6, 20000), 2.0 ** np.arange(-29, 24),
        np.float32(1e-9) * np.arange(1, 200)]).astype(np.float32)
    x = m * uni.astype(np.float64)
    near = np.float32(x)
    cases = [near, np.nextafter(near, np.float32(np.inf)),
             np.nextafter(near, np.float32(0)),
             np.nextafter(np.nextafter(near, np.float32(np.inf)),
                          np.float32(np.inf))]
    ties = 0
    with np.errstate(under='ignore'):
        for inter in cases:
            inter = inter.astype(np.float32)
            want = _ieee_over(inter, uni, thresh)
            assert np.array_equal(want, _exact_over(inter, uni, thresh))
            assert np.array_equal(want, _predicate_over(inter, uni, thresh))
            ties += int((inter.astype(np.float64) == x).sum())
    if thresh == 0.0:
        assert ties > 0  # the tie rule itself was exercised


def test_threshold_split_tie_rule():
    """At thresh 0 a tie (q = 2^-150) rounds to 0 (even), so it does not
    overlap; just above a float whose successor is even, it does."""

    m, m_hi, m_lo, tie_up = cuda_nms.threshold_split(0.0)
    assert m == 2.0 ** -150 and not tie_up
    assert (m_hi, m_lo) == (float('inf'), float('-inf'))
    t = np.float32(0.5)
    t_next = np.nextafter(t, np.float32(1))
    m, m_hi, m_lo, tie_up = cuda_nms.threshold_split(float(t))
    assert m == (0.5 + float(t_next)) / 2
    assert tie_up == (int(np.array(t_next).view(np.uint32)) % 2 == 0)
    assert m_lo < m < m_hi
    assert m * (1 + 2.0 ** -19) <= m_hi < m * (1 + 2.0 ** -18)
    assert m * (1 - 2.0 ** -18) < m_lo <= m * (1 - 2.0 ** -19)
    # a negative threshold: the bounds keep their sides
    m, m_hi, m_lo, _ = cuda_nms.threshold_split(-0.25)
    assert m_lo < m < m_hi < 0


#%% The mask pass's grid


def triangle_tile(p, n):
    """csrc/nms.cu triangle_tile, as written (float64 sqrt, then
    corrections)."""

    q = n * (n + 1) // 2 - 1 - p
    rr = int((math.sqrt(8.0 * q + 1.0) - 1.0) * 0.5)
    while (rr + 1) * (rr + 2) // 2 <= q:
        rr += 1
    while rr * (rr + 1) // 2 > q:
        rr -= 1
    return n - 1 - rr, n - 1 - (q - rr * (rr + 1) // 2)


@pytest.mark.parametrize('n', list(range(1, 40)) + [1000, 1536])
def test_triangle_index_covers_the_upper_triangle_once(n):
    got = [triangle_tile(p, n) for p in range(n * (n + 1) // 2)]
    want = [(r, c) for r in range(n) for c in range(r, n)]
    assert got == want


def test_sweep_shared_memory_fits_every_accepted_k():
    """The wrapper takes K up to 64 * 6144 (removed <= 48 KB); the sweep's
    ring of two 64 KB stages and removed stay under 227 KB."""

    k_max = 64 * (48 * 1024 // 8)
    assert cuda_nms.sweep_smem_bytes(k_max) <= 232448
    assert cuda_nms.sweep_smem_bytes(8192) == 8 * (2 * 64 * 128 + 128)
    assert cuda_nms.row_words(8192) == 128
    assert cuda_nms.row_words(16383) == 256
    assert cuda_nms.row_words(65) == 2 and cuda_nms.row_words(1) == 2


#%% Emulation of both passes


def _overlaps(a, b, thresh):
    """[..., R, C] bool for rows a [..., R, 4] and columns b [..., C, 4]:
    the kernel's float32 IoU pieces and its division-free test."""

    a = a[..., :, None, :]
    b = b[..., None, :, :]
    zero = np.float32(0)

    def area(x):
        return np.maximum(x[..., 2] - x[..., 0], zero) * \
            np.maximum(x[..., 3] - x[..., 1], zero)

    ix0 = np.maximum(a[..., 0], b[..., 0])
    iy0 = np.maximum(a[..., 1], b[..., 1])
    ix1 = np.minimum(a[..., 2], b[..., 2])
    iy1 = np.minimum(a[..., 3], b[..., 3])
    inter = np.maximum(ix1 - ix0, zero) * np.maximum(iy1 - iy0, zero)
    uni = np.maximum((area(a) + area(b)) - inter, np.float32(1e-9))
    return _predicate_over(inter, uni, thresh)


def _pack_bits(bits):
    """[..., n <= 64] bool -> [...] uint64, bit c = column c."""

    weights = np.left_shift(np.uint64(1),
                            np.arange(bits.shape[-1], dtype=np.uint64))
    return np.bitwise_or.reduce(np.where(bits, weights, np.uint64(0)),
                                axis=-1)


def emulate_mask(boxes, thresh, rng):
    """nms_mask_kernel over every launched tile; the words it never writes
    hold random bits."""

    b, k = boxes.shape[:2]
    rw = cuda_nms.row_words(k)
    tile = cuda_nms.MASK_TILE
    mask = rng.randint(0, 2 ** 62, (b, k, rw)).astype(np.uint64) * 3
    written = np.zeros((k, rw), bool)
    n = -(-k // tile)
    for p in range(n * (n + 1) // 2):
        tr, tc = triangle_tile(p, n)
        rows = np.arange(tr * tile, min(tr * tile + tile, k))
        for cw in range(tile // 64):
            w = tc * (tile // 64) + cw
            if w * 64 >= k:
                break
            cols = np.arange(w * 64, min(w * 64 + 64, k))
            r = rows[(rows >> 6) <= w]
            if r.size == 0:
                continue
            over = _overlaps(boxes[:, r], boxes[:, cols], thresh)
            over &= cols[None, None, :] > r[None, :, None]
            assert not written[r, w].any()
            written[r, w] = True
            mask[:, r, w] = _pack_bits(over)
    # every word the sweep may read is written: row i, words i // 64 ..
    words = (k + 63) // 64
    for i in range(0, k, max(1, k // 97)):
        assert written[i, i // 64:words].all()
    return mask


def sweep_units(words, rw, seg):
    """nms_sweep_kernel's units (chunk c, segment start s0, width n)."""

    c, s0 = 0, 0
    while True:
        yield c, s0, min(seg, rw - s0)
        nc, ns = c, s0 + seg
        if ns >= words:
            nc, ns = c + 1, (c + 1) & ~1
        if nc >= words:
            return
        c, s0 = nc, ns


def emulate_sweep(mask, valid, rng, seg=None):
    """nms_sweep_kernel, one image at a time, with its ring and units."""

    b, k, rw = mask.shape
    words = (k + 63) // 64
    seg = min(cuda_nms.SWEEP_SEGMENT_WORDS, rw) if seg is None else seg
    keep = np.zeros((b, k), bool)
    one = np.uint64(1)
    for img in range(b):
        gone = np.ones(words * 64, bool)
        gone[:k] = ~valid[img]
        removed = _pack_bits(gone.reshape(words, 64))
        stages = [rng.randint(0, 2 ** 62, 64 * seg).astype(np.uint64)
                  for _ in range(2)]
        units = list(sweep_units(words, rw, seg))

        def prefetch(stage, c, s0, n):
            for r in range(64):
                if c * 64 + r < k:
                    stage[r * n:(r + 1) * n] = mask[img, c * 64 + r,
                                                    s0:s0 + n]
            assert s0 % 2 == 0 and n % 2 == 0  # 16-byte pieces

        prefetch(stages[0], *units[0])
        kept = np.uint64(0)
        for u, (c, s0, n) in enumerate(units):
            if u + 1 < len(units):
                prefetch(stages[(u + 1) % 2], *units[u + 1])
            tile = stages[u % 2]
            if s0 == c & ~1:
                # every row in order, its diagonal word from the tile
                # (stale where the row is past K, never alive)
                diag = [int(tile[r * n + (c - s0)]) for r in range(64)]
                kept = int(~removed[c])
                for r in range(64):
                    if (kept >> r) & 1:
                        kept &= ~diag[r]
                kept = np.uint64(kept)
                removed[c] = ~kept
            rows = [r for r in range(64) if (kept >> np.uint64(r)) & one]
            for wi in range(n):
                w = s0 + wi
                if rows and c < w < words:
                    removed[w] |= np.bitwise_or.reduce(
                        tile[[r * n + wi for r in rows]])
        bits = (removed[:, None] >> np.arange(64, dtype=np.uint64)) & one
        keep[img] = bits.reshape(-1)[:k] == 0
    return keep


def _boxes(rng, b, k, canvas=1280.0):
    """Score-sorted-like seeded boxes, class-offset as nms_on_candidates
    makes them, with ~10% invalid slots."""

    xy = rng.uniform(0, canvas, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(8, 240, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    boxes += rng.randint(0, 3, (b, k, 1)).astype(np.float32) * 8192.0
    return boxes, rng.rand(b, k) > 0.1


def _check(boxes, valid, thresh, seg=None, rng=None):
    rng = rng or np.random.RandomState(0)
    mask = emulate_mask(boxes, thresh, rng)
    got = emulate_sweep(mask, valid, rng, seg)
    ref = cuda_nms.greedy_nms_keep_reference(
        torch.from_numpy(boxes), torch.from_numpy(valid), thresh).numpy()
    assert np.array_equal(got, ref), int((got != ref).sum())
    return got


@pytest.mark.parametrize('b', [1, 3, 8])
@pytest.mark.parametrize('k', [1, 63, 64, 65, 130, 1000])
def test_emulation_matches_plain(k, b):
    rng = np.random.RandomState(k * 10 + b)
    # a narrower canvas at small K, so boxes overlap
    boxes, valid = _boxes(rng, b, k, canvas=min(1280.0, 8.0 * k + 64))
    _check(boxes, valid, 0.45)


def test_emulation_matches_plain_at_the_ceiling():
    """K = 8192, the capacity random weights reach (one image: the plain
    version's IoU matrix is 256 MB)."""

    rng = np.random.RandomState(8192)
    boxes, valid = _boxes(rng, 1, 8192)
    keep = _check(boxes, valid, 0.45)
    assert 0 < keep.sum() < valid.sum()


@pytest.mark.parametrize('seg', [2, 4, 6])
@pytest.mark.parametrize('thresh', THRESHOLDS)
def test_segment_walk_matches_plain(seg, thresh):
    """Stages of 2-6 words a row: every chunk's tile is walked in several
    segments, as the kernel does above K ~ 8192."""

    rng = np.random.RandomState(seg)
    boxes, valid = _boxes(rng, 2, 700, canvas=900.0)
    _check(boxes, valid, thresh, seg=seg)


def test_duplicates_across_word_boundaries_and_invalid_images():
    rng = np.random.RandomState(1)
    boxes, valid = _boxes(rng, 3, 200, canvas=600.0)
    for src, dst in ((0, 1), (0, 64), (3, 65), (126, 127), (127, 128),
                     (60, 191), (199, 63)):
        boxes[:, dst] = boxes[:, src]
    valid[:, 0] = True
    valid[:, 3] = False
    valid[:, 100:110] = False
    valid[2] = False  # an image with no valid slot
    keep = _check(boxes, valid, 0.45, seg=4)
    assert not keep[:2, 1].any() and not keep[:2, 64].any()
    assert not keep[2].any()


def test_units_cover_every_later_word_once():
    """At K = 16383 (256 words a row, two stages' width) every chunk reads
    its diagonal word in its first unit and each later word exactly once."""

    k = 16383
    words = (k + 63) // 64
    rw = cuda_nms.row_words(k)
    seg = min(cuda_nms.SWEEP_SEGMENT_WORDS, rw)
    seen = {}
    first = {}
    for c, s0, n in sweep_units(words, rw, seg):
        assert s0 % 2 == 0 and n % 2 == 0 and s0 + n <= rw
        first.setdefault(c, (s0, n))
        for w in range(max(s0, c + 1), min(s0 + n, words)):
            seen[(c, w)] = seen.get((c, w), 0) + 1
    assert sorted(first) == list(range(words))
    for c, (s0, n) in first.items():
        assert s0 <= c < s0 + n
    assert all(v == 1 for v in seen.values())
    assert len(seen) == words * (words - 1) // 2
    assert sum(1 for _ in sweep_units(words, rw, seg)) > words


def test_breakdown_variants_edit_the_kernel_source():
    """experiments/nms_sweep_breakdown.py builds its variants by replacing
    text of csrc/nms.cu: each replaced text must still be there, once."""

    from megadetector_tpu_torch.experiments import nms_sweep_breakdown
    from megadetector_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, 'nms.cu')) as f:
        source = f.read()
    for name, edits in nms_sweep_breakdown.VARIANTS.items():
        for old, _ in edits:
            assert source.count(old) == 1, name
