"""
The fused stem kernel's tiling and data layout, checked on the CPU
(csrc/l0_fused.cu; no card needed).

A numpy emulation of the kernel, written from the source, tile by tile:
each patch row's raw bytes fetched in 16-byte pieces from a 16-byte
boundary below its first byte (pieces partly outside the tensor byte by
byte; the stage starts as random bytes), converted to a bf16 patch with
zeros outside the image; the weights rearranged into mma.sync m16n8k16's
B-fragment order (K padded to 112, channels to a multiple of 64); each
thread's A registers loaded from the patch at pixel base + tap-pair
offset; the MMAs done on the matrices those registers stand for (the PTX
fragment layouts), summed exactly; the accumulators' (pixel, channel) by
the D-fragment layout, the bias + SiLU epilogue, the staged pixels and the
16-byte stores. Its output must meet the kernel's bar against
l0_fused_reference (ops/l0_fused.py plain_bar), every output element must
be written once, and the shared-memory accesses must be free of bank
conflicts.
"""

import numpy as np
import pytest
import torch

from megadetector_tpu_torch.ops import l0_fused as stem

LANE = np.arange(32)
G = LANE // 4
Q = LANE % 4


def _bf16_half(words, i):
    """Element i (0 low, 1 high) of bf16 pairs packed in uint32 words, as
    float64."""

    bits = (words >> np.uint32(16 * i)) & np.uint32(0xffff)
    return (bits << np.uint32(16)).astype(np.uint32).view(np.float32).astype(
        np.float64)


def a_matrix(regs):
    """[..., 16, 16] A of mma.m16n8k16 from its four registers [4, ...,
    32]: a0 (g, 2q..), a1 (g + 8, 2q..), a2 (g, 2q + 8..), a3 (g + 8,
    2q + 8..)."""

    a = np.zeros(regs.shape[1:-1] + (16, 16))
    for r, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for i in range(2):
            a[..., G + dr, 2 * Q + dk + i] = _bf16_half(regs[r], i)
    return a


def b_matrix(regs):
    """[..., 16, 8] B from its two registers [..., 32, 2]: b0 (k 2q.., n
    g), b1 (k 2q + 8.., n g)."""

    b = np.zeros(regs.shape[:-2] + (16, 8))
    for r in range(2):
        for i in range(2):
            b[..., 2 * Q + 8 * r + i, G] = _bf16_half(regs[..., r], i)
    return b


def d_registers(d):
    """The four accumulators [..., 32, 4] of D [..., 16, 8]: (g, 2q),
    (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1)."""

    return np.stack([d[..., G + 8 * (e // 2), 2 * Q + e % 2]
                     for e in range(4)], axis=-1)


def step_tap(s, j, q):
    """csrc/l0_fused.cu step_tap: the first tap (18 ky + r) of the pair in
    register half j of k16 step s for lane q, or -1 for a pad pair."""

    if s < 6:
        return 18 * s + 8 * j + 2 * q
    pair = 4 * j + q
    return 18 * pair + 16 if pair < 6 else -1


def tap_offsets():
    """[7, 2, 32] words into the patch of each lane's tap pairs, as the
    kernel's toff (a pad pair reads lane (g, q - 2)'s word)."""

    off = np.zeros((7, 2, 32), np.int64)
    for s in range(7):
        for j in range(2):
            for lane in range(32):
                t = step_tap(s, j, Q[lane])
                if t < 0:
                    t = step_tap(s, j, Q[lane] - 2)
                off[s, j, lane] = (t // 18) * stem.PATCH_STRIDE + (t % 18) // 2
    return off


def pixel_bases():
    """[8 warps, 2 mi, 2 h, 32] words of pixel column ocol + 16 mi + g +
    8 h of tile row orow (warp w: orow w // 2, ocol 32 (w % 2))."""

    warp = np.arange(8)[:, None, None, None]
    mi = np.arange(2)[None, :, None, None]
    h = np.arange(2)[None, None, :, None]
    return 2 * (warp // 2) * stem.PATCH_STRIDE + 3 * (
        (warp % 2) * 32 + 16 * mi + G + 8 * h)


def b_fragments(w, c):
    """The kernel's bfrag: uint32 [7, C_pad / 8, 32, 2]."""

    cp = -(-c // stem.GROUP) * stem.GROUP
    # row TAPS + 1 stays zero: the pad pairs' weights
    wbits = np.zeros((stem.TAPS + 2, cp), np.uint32)
    wbits[:stem.TAPS, :c] = w.view(torch.int16).numpy().view(np.uint16)
    n8 = cp // 8
    frag = np.zeros((7, n8, 32, 2), np.uint32)
    for s in range(7):
        for lane in range(32):
            n = 8 * np.arange(n8) + G[lane]
            for j in range(2):
                t = step_tap(s, j, Q[lane])
                t = stem.TAPS if t < 0 else t
                frag[s, :, lane, j] = wbits[t, n] | (wbits[t + 1, n] <<
                                                     np.uint32(16))
    return frag


def _check_banks(words):
    """words [..., 32]: one shared-memory access per row; lanes may share
    a word (broadcast) but no two distinct words may share a bank."""

    words = words.reshape(-1, 32)
    for row in words:
        distinct = np.unique(row)
        assert len(np.unique(distinct % 32)) == len(distinct), row


def emulate_stem(images, w, bias, base=0, seed=0):
    """The kernel's output (bf16 [B, H/2, W/2, C]) for x at an absolute
    address = base (mod 16)."""

    rng = np.random.RandomState(seed)
    b, h, wd, _ = images.shape
    c = w.shape[1]
    ho, wo = h // 2, wd // 2
    cp = -(-c // stem.GROUP) * stem.GROUP
    tiles_x = -(-wo // stem.TILE_COLS)
    tiles_y = -(-ho // stem.TILE_ROWS)
    flat = images.reshape(-1)
    total = flat.size
    patch_words = stem.PATCH_ELEMS // 2

    bfrag = b_fragments(w, c)
    bias_s = np.zeros(cp, np.float32)
    bias_s[:c] = bias.numpy()
    toff = tap_offsets()
    pbase = pixel_bases()
    out = np.full((b, ho, wo, c), 0xffff, np.uint16)  # NaN: unwritten
    out_words = out.view(np.uint32).reshape(-1)
    writes = np.zeros(out_words.size, np.int64)

    for tile in range(b * tiles_y * tiles_x):
        bi = tile // (tiles_y * tiles_x)
        rem = tile % (tiles_y * tiles_x)
        oy0 = (rem // tiles_x) * stem.TILE_ROWS
        ox0 = (rem % tiles_x) * stem.TILE_COLS

        # prefetch: raw pieces from the 16-byte boundary below each row
        raw = rng.randint(0, 256, (stem.PATCH_ROWS, 16 * stem.RAW_PIECES))
        leads = {}
        for r in range(stem.PATCH_ROWS):
            iy = 2 * oy0 - 2 + r
            if not 0 <= iy < h:
                continue
            g0 = ((bi * h + iy) * wd + 2 * ox0 - 2) * 3
            lead = (base + g0) % 16
            leads[r] = lead
            for p in range(stem.RAW_PIECES):
                src = g0 - lead + 16 * p
                if 16 * p >= lead + stem.PATCH_ELEMS:
                    continue
                if 0 <= src and src + 16 <= total:
                    assert (base + src) % 16 == 0
                    raw[r, 16 * p:16 * p + 16] = flat[src:src + 16]
                else:
                    for e in range(16):
                        if 0 <= src + e < total:
                            raw[r, 16 * p + e] = flat[src + e]

        # convert: bf16 patch, zeros outside the image
        patch = np.zeros((stem.PATCH_ROWS, stem.PATCH_ELEMS), np.uint32)
        e = np.arange(stem.PATCH_ELEMS)
        ix = 2 * ox0 - 2 + e // 3
        for r, lead in leads.items():
            vals = raw[r, lead + e].astype(np.float32).view(np.uint32) >> 16
            patch[r] = np.where((ix >= 0) & (ix < wd), vals, 0)
        words = rng.randint(0, 2 ** 31, (stem.PATCH_ROWS, stem.PATCH_STRIDE)
                            ).astype(np.uint32)  # the row pads: stale
        words[:, :patch_words] = patch[:, 0::2] | (patch[:, 1::2] <<
                                                    np.uint32(16))
        patch = words.reshape(-1)

        oy = oy0 + np.arange(8) // 2  # each warp's output row
        for grp in range(-(-c // stem.GROUP)):
            acc = np.zeros((8, 2, 8, 32, 4))
            for s in range(7):
                # a0..a3 = [(base h0, tap j0), (h1, j0), (h0, j1), (h1, j1)]
                addr = np.stack([pbase[:, :, 0] + toff[s, 0],
                                 pbase[:, :, 1] + toff[s, 0],
                                 pbase[:, :, 0] + toff[s, 1],
                                 pbase[:, :, 1] + toff[s, 1]])
                _check_banks(addr)
                amat = a_matrix(patch[addr])            # [8, 2, 16, 16]
                for j in range(8):
                    bregs = bfrag[s, grp * 8 + j]       # [32, 2]
                    acc[:, :, j] += d_registers(amat @ b_matrix(bregs))
            # epilogue, staged pixels, 16-byte stores
            for warp in range(8):
                stage = rng.randint(0, 2 ** 31, 32 * stem.STAGE_WORDS).astype(
                    np.uint32)
                for j in range(8):
                    n = grp * stem.GROUP + 8 * j + 2 * Q
                    for mi in range(2):
                        for hh in range(2):
                            pair = []
                            for i in range(2):
                                y = acc[warp, mi, j, :, 2 * hh + i].astype(
                                    np.float32) + bias_s[n + i]
                                v = y * (np.float32(1) / (np.float32(1) +
                                                          np.exp(-y)))
                                pair.append(torch.from_numpy(v).to(
                                    torch.bfloat16).view(torch.int16)
                                    .numpy().view(np.uint16).astype(
                                        np.uint32))
                            word = (16 * mi + G + 8 * hh) * \
                                stem.STAGE_WORDS + 4 * j + Q
                            _check_banks(word)
                            stage[word] = pair[0] | (pair[1] << np.uint32(16))
                pieces = min(stem.GROUP, c - grp * stem.GROUP) // 8
                for i in range(32 * pieces):
                    p, j = divmod(i, pieces)
                    ox = ox0 + (warp % 2) * 32 + p
                    if ox < wo and oy[warp] < ho:
                        dst = (((bi * ho + oy[warp]) * wo + ox) * c +
                               grp * stem.GROUP + 8 * j) // 2
                        assert dst % 4 == 0  # 16-byte store
                        src = p * stem.STAGE_WORDS + 4 * j
                        assert src % 4 == 0
                        out_words[dst:dst + 4] = stage[src:src + 4]
                        writes[dst:dst + 4] += 1
    assert (writes == 1).all()
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


def _case(b, h, w, c, seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, h, w, 3), dtype=np.uint8)
    wt, bias = stem.prepare_l0_weights({
        'w': rng.standard_normal((6, 6, 3, c)).astype(np.float32) * 0.2,
        'b': rng.uniform(-1, 1, c).astype(np.float32)})
    return images, wt, bias


@pytest.mark.parametrize('b,h,w,c,base', [
    (2, 10, 134, 64, 0),    # ragged: 5 x 67 outputs, two column tiles
    (1, 18, 200, 16, 5),    # C 16 (one pass of 64, 48 padded channels)
    (1, 12, 40, 256, 9),    # C 256: four channel passes
    (2, 2, 22, 64, 3),      # a 2-pixel-high image: one output row
    (1, 14, 262, 80, 0),    # C 80: a full pass and a 16-channel tail
])
def test_emulation_meets_the_bar(b, h, w, c, base):
    images, wt, bias = _case(b, h, w, c, seed=c + h)
    got = emulate_stem(images, wt, bias, base=base)
    ref = stem.l0_fused_reference(torch.from_numpy(images), wt, bias)
    assert got.shape == ref.shape
    differ, max_abs, outside = stem.plain_bar(got, ref)
    assert outside == 0, (differ, max_abs)
    assert differ <= stem.DIFF_SHARE * got.numel() + 1, differ


def test_fragment_layouts_reproduce_a_product():
    """a_matrix / b_matrix / d_registers against a plain product: each
    element lands where the PTX layouts say, and the tap offsets cover
    taps 0..107 once per pixel."""

    rng = np.random.RandomState(3)
    words = rng.randint(0, 2 ** 31, (4, 32)).astype(np.uint32) & \
        np.uint32(0x3fff3fff)
    bregs = rng.randint(0, 2 ** 31, (32, 2)).astype(np.uint32) & \
        np.uint32(0x3fff3fff)
    a = a_matrix(words)
    bm = b_matrix(bregs)
    assert np.isfinite(a).all() and (a != 0).sum() > 200
    d = d_registers(a @ bm)
    for lane in range(32):
        g, q = divmod(lane, 4)
        assert d[lane, 0] == (a @ bm)[g, 2 * q]
        assert d[lane, 3] == (a @ bm)[g + 8, 2 * q + 1]
    # every real tap exactly once per pixel, at its patch row and element
    toff = tap_offsets()
    taps = []
    for s in range(7):
        for j in range(2):
            for q in range(4):
                t = step_tap(s, j, q)
                ky, word = divmod(toff[s, j, q], stem.PATCH_STRIDE)
                if t >= 0:
                    assert (ky, 2 * word) == (t // 18, t % 18)
                    taps += [t, t + 1]
    assert sorted(taps) == list(range(stem.TAPS))
    assert 2 * max(toff.reshape(-1) % stem.PATCH_STRIDE) + 1 < \
        stem.PATCH_ELEMS


def test_shared_memory_budget():
    """The kernel's dynamic shared memory (B fragments, bias, patch, two
    raw stages, eight warps' staging) fits two blocks an SM at C = 64 and
    one block at C = 256."""

    def smem(c):
        cp = -(-c // stem.GROUP) * stem.GROUP
        return (7 * (cp // 8) * 256 + 4 * cp +
                4 * stem.PATCH_ROWS * stem.PATCH_STRIDE +
                2 * stem.PATCH_ROWS * 16 * stem.RAW_PIECES +
                4 * 8 * 32 * stem.STAGE_WORDS)

    assert 2 * smem(64) <= 228 * 1024
    assert smem(256) <= 232448
    # a raw row covers the patch row's 396 bytes from any 16-byte offset
    assert 16 * stem.RAW_PIECES >= 15 + stem.PATCH_ELEMS
