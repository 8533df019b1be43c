"""
The int8 conv kernel's tiling and data layout, checked on the CPU
(csrc/conv_int8.cu, csrc/wgmma_int8.cuh; no card needed).

- conv_tiling (ops/conv_int8.py), the instance each call launches, over
  every chain conv of yolov5l6 at both 1280 px canvases (from the model's
  own geometry, a forward on the meta device) and over the odd-Cin shapes
  of the card tests.
- A numpy emulation of one block of the kernel, written from the source
  notes: the producer's cp.async chunks at their swizzled shared-memory
  offsets (md_swizzle), what wgmma reads through the descriptor
  (md_smem_desc) by the PTX canonical K-major layout of its swizzle mode,
  the MMAs, the accumulators by wgmma's register layout, and the staged
  epilogue's reads. It must give back A's and B's tiles stage by stage and
  the conv's int32 sums for the block.
"""

import numpy as np
import pytest
import torch

from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.ops import conv_int8

# csrc/conv_int8.cu Ring: the ring's stages for each stage width
RING = {64: 6, 128: 3}


#%% conv_tiling


def _chain_convs(height, width, batch=8):
    shapes = yolov5.activated_conv_shapes(
        yolov5.YoloV5Config('yolov5l6', num_classes=3), height, width, batch)
    assert shapes[0]['name'] == 'l0' and shapes[0]['cin'] == 3
    return shapes[1:]


@pytest.mark.parametrize('height,width', [(960, 1280), (768, 1280),
                                          (1280, 1280)])
def test_tiling_of_the_yolov5l6_chain_convs(height, width):
    """All 130 chain convs take 16-byte copies, 128-byte stages where Cin
    allows, and a grid of at least one block per SM wherever some tile
    gives one; BM 128 wherever its grid already does."""

    chain = _chain_convs(height, width)
    assert len(chain) == 130
    small = 0
    for d in chain:
        m = d['batch'] * d['ho'] * d['wo']
        t = conv_int8.conv_tiling(m, d['cin'], d['cout'])
        assert t.vec == 16 and d['cin'] % 64 == 0, d
        assert t.bk == (128 if d['cin'] % 128 == 0 else 64), d
        assert t.bn == (64 if d['cout'] <= 64 else 128), d
        big = conv_int8.conv_grid(m, d['cout'], 128, t.bn)
        grid = conv_int8.conv_grid(m, d['cout'], t.bm, t.bn)
        assert t.bm == (128 if big >= conv_int8.SMS else 64), d
        if grid < conv_int8.SMS:
            # no tile fills the card: the 12x20 level of the 768x1280
            # canvas with 512 output channels (120 blocks of 64 x 128)
            assert t.bm == 64 and (d['ho'], d['wo'], d['cout']) == \
                (12, 20, 512), d
            small += 1
    assert small == (17 if height == 768 else 0)


@pytest.mark.parametrize('height,width,n_small', [(960, 1280, 53),
                                                  (768, 1280, 91),
                                                  (1280, 1280, 49)])
def test_tiling_of_the_chain_convs_at_batch_1(height, width, n_small):
    """One image a batch (the single-image driver, a video's or a folder's
    tail): the same instances by Cin and Cout, and BM 64 on every conv
    whose 128-row grid falls under one block an SM; those are the deep
    levels, 256 output channels and more."""

    chain = _chain_convs(height, width, batch=1)
    assert len(chain) == 130
    small = 0
    for d in chain:
        m = d['ho'] * d['wo']
        t = conv_int8.conv_tiling(m, d['cin'], d['cout'])
        assert t.vec == 16 and t.bk == (128 if d['cin'] % 128 == 0
                                        else 64), d
        assert t.bn == (64 if d['cout'] <= 64 else 128), d
        big = conv_int8.conv_grid(m, d['cout'], 128, t.bn)
        assert t.bm == (128 if big >= conv_int8.SMS else 64), d
        if conv_int8.conv_grid(m, d['cout'], t.bm, t.bn) < conv_int8.SMS:
            assert t.bm == 64 and d['cout'] >= 256, d
            small += 1
    assert small == n_small


@pytest.mark.parametrize('cin,aligned', [(4, True), (24, True), (36, True),
                                         (516, True), (64, False),
                                         (768, False)])
def test_tiling_takes_the_4_byte_copies(cin, aligned):
    """Cin % 16 != 0 (the card tests' 4, 24, 36, 516) or a view that is not
    16-byte aligned: the 4-byte instance, with 64-byte stages."""

    t = conv_int8.conv_tiling(8 * 60 * 80, cin, 256, aligned16=aligned)
    assert (t.vec, t.bk, t.bn, t.bm) == (4, 64, 128, 128)
    assert not t.code & (conv_int8.INST_VEC16 | conv_int8.INST_BK128)


def test_instance_codes():
    """Each reachable tiling has its own code, and the code's bits say the
    tiling."""

    seen = {}
    for cin in (36, 64, 128):
        for cout in (40, 64, 65, 1024):
            for m in (64, 2400, 153600):
                for aligned in (True, False):
                    t = conv_int8.conv_tiling(m, cin, cout, aligned)
                    assert seen.setdefault(t.code, t[:4]) == t[:4]
                    assert bool(t.code & conv_int8.INST_VEC16) == \
                        (t.vec == 16)
                    assert bool(t.code & conv_int8.INST_BK128) == \
                        (t.bk == 128)
                    assert bool(t.code & conv_int8.INST_BM128) == \
                        (t.bm == 128)
                    assert bool(t.code & conv_int8.INST_BN128) == \
                        (t.bn == 128)
    assert len(seen) == 12


#%% The kernel's layouts, emulated


def md_swizzle(offset, row_bytes):
    """wgmma_int8.cuh md_swizzle: where byte [offset] of a K-major tile with
    [row_bytes]-byte rows lands."""

    return offset ^ ((offset >> 3) & ((row_bytes // 16 - 1) << 4))


def md_smem_desc(addr, row_bytes):
    """wgmma_int8.cuh md_smem_desc."""

    layout = 1 if row_bytes == 128 else 2
    return (((addr >> 4) & 0x3FFF) | (1 << 16) |
            (((8 * row_bytes) >> 4) << 32) | (layout << 62))


def wgmma_read(smem, desc, rows):
    """The [rows, 32] bytes one k32 step of wgmma reads through a K-major
    descriptor, by the PTX canonical layout of its swizzle mode: 8-row
    groups SBO apart, rows of the mode's width (128 bytes for layout 1, 64
    for 2) inside a group, the 32 K bytes contiguous from the start
    address; then the mode's XOR of address bits 7.. into bits 4.. on the
    absolute shared address."""

    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    layout = desc >> 62
    row_bytes, bits = {1: (128, 3), 2: (64, 2)}[layout]
    r = np.arange(rows)[:, None]
    addr = start + (r // 8) * sbo + (r % 8) * row_bytes + np.arange(32)
    return smem[addr ^ (((addr >> 7) & ((1 << bits) - 1)) << 4)]


def accumulator_coords(n):
    """(row, column) of each wgmma m64nNk32 accumulator, [thread, register],
    by CUTLASS's CLayout_64xN ((4, 8, 4), (2, 2, N / 8)) : ((128, 1, 16),
    (64, 8, 512)) over the column-major 64 x N tile."""

    t = np.arange(128)[:, None]
    v = np.arange(n // 2)[None, :]
    idx = ((t % 4) * 128 + (t // 4 % 8) + (t // 32) * 16 +
           (v % 2) * 64 + (v // 2 % 2) * 8 + (v // 4) * 512)
    return idx % 64, idx // 64


def staging_coords(n):
    """(row, column) where csrc/conv_int8.cu stores each accumulator in the
    staging tile: warp w, lane l, register 4 j + 2 h + q -> (16 w + l / 4
    + 8 h, 8 j + 2 (l % 4) + q)."""

    t = np.arange(128)[:, None]
    v = np.arange(n // 2)[None, :]
    j, h, q = v // 4, v // 2 % 2, v % 2
    return 16 * (t // 32) + (t % 32) // 4 + 8 * h, 8 * j + 2 * (t % 4) + q


@pytest.mark.parametrize('n', [64, 128])
def test_accumulator_layout(n):
    """The kernel's staging stores put every accumulator where wgmma's
    layout says it belongs, each of the 64 x N once."""

    want = accumulator_coords(n)
    got = staging_coords(n)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    flat = got[0] * n + got[1]
    assert np.array_equal(np.sort(flat.ravel()), np.arange(64 * n))


def _pixel_rows(x_shape, geom, m0, rows, tap, kw):
    """For A rows m0 .. m0 + rows - 1 at [tap]: (valid, b, iy, ix)."""

    b_, h, w, _ = x_shape
    sh, sw, pt, pl, ho, wo = geom
    ky, kx = divmod(tap, kw)
    m = m0 + np.arange(rows)
    bi, rem = np.divmod(m, ho * wo)
    iy = rem // wo * sh - pt + ky
    ix = rem % wo * sw - pl + kx
    ok = (m < b_ * ho * wo) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    return ok, bi, iy, ix


def produce(smem, x, wt, geom, tiling, m0, n0, tap, c0, slot, base):
    """One stage of the kernel's producer: thread t copies chunk t % chunks
    of rows t / chunks + step i, 16 bytes or four 4-byte words, zeros
    where the tap leaves the image or past Cin / Cout. Returns the bytes
    written per shared address, to check the coverage."""

    bm, bn, bk, vec = tiling
    threads, chunks = 2 * bm, bk // 16
    step = threads // chunks
    cin = x.shape[3]
    cout, kh, kw, _ = wt.shape
    a_slot = base + slot * bm * bk
    b_slot = base + RING[bk] * bm * bk + slot * bn * bk
    ok, bi, iy, ix = _pixel_rows(x.shape, geom, m0, bm, tap, kw)
    count = np.zeros(smem.shape, np.int64)
    for t in range(threads):
        cc, r0 = t % chunks, t // chunks
        c = c0 + 16 * cc
        for rows, slot_base, src in ((bm, a_slot, 'a'), (bn, b_slot, 'b')):
            for r in range(r0, rows, step):
                chunk = np.zeros(16, np.int8)
                if src == 'a' and ok[r]:
                    line = x[bi[r], iy[r], ix[r]]
                elif src == 'b' and n0 + r < cout:
                    line = wt[n0 + r].reshape(kh * kw, cin)[tap]
                else:
                    line = None
                if line is not None:
                    words = 4 if vec == 16 else 1
                    for j in range(0, 4, words):
                        if cin - c > 4 * j:
                            chunk[4 * j:4 * (j + words)] = \
                                line[c + 4 * j:c + 4 * (j + words)]
                dst = slot_base + md_swizzle(r * bk + 16 * cc, bk)
                smem[dst:dst + 16] = chunk
                count[dst:dst + 16] += 1
    return count


def expected_tiles(x, wt, geom, tiling, m0, n0, tap, c0):
    """A [bm, bk] and B [bn, bk] of one stage, from the conv's definition."""

    bm, bn, bk, _ = tiling
    cin = x.shape[3]
    cout, kh, kw, _ = wt.shape
    ok, bi, iy, ix = _pixel_rows(x.shape, geom, m0, bm, tap, kw)
    xp = np.zeros((bm, cin + bk), np.int8)
    xp[ok, :cin] = x[bi[ok], iy[ok], ix[ok]]
    wp = np.zeros((bn, cin + bk), np.int8)
    n = np.arange(n0, min(n0 + bn, cout))
    wp[n - n0, :cin] = wt[n].reshape(len(n), kh * kw, cin)[:, tap]
    return xp[:, c0:c0 + bk], wp[:, c0:c0 + bk]


def emulate_block(x, wt, stride, pads, tiling, bx, by, raw=0x230):
    """Block (bx, by) of the kernel, emulated: its [bm, bn] int32 output
    (rows past M, columns past Cout included)."""

    bm, bn, bk, _ = tiling
    b, h, w, cin = x.shape
    cout, kh, kw, _ = wt.shape
    ho = (h + pads[0] + pads[1] - kh) // stride[0] + 1
    wo = (w + pads[2] + pads[3] - kw) // stride[1] + 1
    geom = (stride[0], stride[1], pads[0], pads[2], ho, wo)
    m0, n0 = bx * bm, by * bn
    base = (raw + 1023) & ~1023  # the kernel's 1024-byte aligned ring
    ring = RING[bk] * (bm + bn) * bk
    smem = np.zeros(base + ring, np.int8)
    csteps = -(-cin // bk)
    acc = np.zeros((bm, bn), np.int64)
    for s in range(kh * kw * csteps):
        tap, c0 = s // csteps, s % csteps * bk
        slot = s % RING[bk]
        count = produce(smem, x, wt, geom, tiling, m0, n0, tap, c0, slot,
                        base)
        # every byte of the slot's A and B written once, nothing else
        a0 = base + slot * bm * bk
        b0 = base + RING[bk] * bm * bk + slot * bn * bk
        assert (count[a0:a0 + bm * bk] == 1).all()
        assert (count[b0:b0 + bn * bk] == 1).all()
        assert count.sum() == (bm + bn) * bk
        want_a, want_b = expected_tiles(x, wt, geom, tiling, m0, n0, tap, c0)
        got_b = np.concatenate([wgmma_read(smem, md_smem_desc(b0, bk) + 2 * kk,
                                           bn) for kk in range(bk // 32)], 1)
        assert np.array_equal(got_b, want_b)
        for wg in range(bm // 64):
            desc = md_smem_desc(a0 + wg * 64 * bk, bk)
            got_a = np.concatenate([wgmma_read(smem, desc + 2 * kk, 64)
                                    for kk in range(bk // 32)], 1)
            assert np.array_equal(got_a, want_a[64 * wg:64 * (wg + 1)])
            acc[64 * wg:64 * (wg + 1)] += got_a.astype(np.int64) @ \
                got_b.astype(np.int64).T

    # Registers by wgmma's layout, stored by the kernel's formula into the
    # [bm][bn + 8] staging tile, read back four columns a thread
    pitch = bn + 8
    tile = np.full(bm * pitch, -1, np.int64)
    want_r, want_c = accumulator_coords(bn)
    row, col = staging_coords(bn)
    for wg in range(bm // 64):
        regs = acc[64 * wg + want_r, want_c]
        tile[(64 * wg + row) * pitch + col] = regs
    out = np.empty((bm, bn), np.int64)
    for u in range(bm * bn // 4):
        r, c4 = divmod(u, bn // 4)
        out[r, 4 * c4:4 * c4 + 4] = tile[r * pitch + 4 * c4:
                                         r * pitch + 4 * c4 + 4]
    return out, b * ho * wo


EMULATED = [
    # 3x3 s1, Cin 192 (one 64-byte tail stage per tap at BK 128)
    ((2, 9, 13, 192), 72, 3, (1, 1), (1, 1, 1, 1), (64, 128, 64, 16)),
    ((2, 9, 13, 192), 72, 3, (1, 1), (1, 1, 1, 1), (128, 64, 128, 16)),
    # 3x3 s2
    ((1, 17, 23, 128), 96, 3, (2, 2), (1, 1, 1, 1), (128, 128, 128, 16)),
    ((1, 17, 23, 128), 96, 3, (2, 2), (1, 1, 1, 1), (64, 64, 64, 16)),
    # 1x1
    ((2, 7, 11, 256), 40, 1, (1, 1), (0, 0, 0, 0), (128, 128, 128, 16)),
    ((2, 7, 11, 256), 40, 1, (1, 1), (0, 0, 0, 0), (64, 64, 64, 4)),
    # Cin 36: 4-byte copies
    ((1, 9, 10, 36), 24, 3, (1, 1), (1, 1, 1, 1), (64, 64, 64, 4)),
    ((1, 9, 10, 36), 24, 3, (1, 1), (1, 1, 1, 1), (128, 128, 64, 4)),
]


@pytest.mark.parametrize('x_shape,cout,k,stride,pads,tiling', EMULATED)
def test_emulated_block_gives_the_conv(x_shape, cout, k, stride, pads,
                                       tiling):
    """The first and the last (ragged) block of the grid: every stage's A
    and B tiles come back through the descriptors, and the block's sums
    equal the plain int32 conv's."""

    rng = np.random.RandomState(sum(x_shape) + cout + k)
    x = rng.randint(-127, 128, x_shape).astype(np.int8)
    wt = rng.randint(-127, 128, (cout, k, k, x_shape[3])).astype(np.int8)
    ref = conv_int8.conv_int32_reference(
        torch.from_numpy(x), torch.from_numpy(wt), stride, pads).numpy()
    ref = ref.reshape(-1, cout)
    bm, bn = tiling[:2]
    m_total = ref.shape[0]
    last = (-(-m_total // bm) - 1, -(-cout // bn) - 1)
    for bx, by in ((0, 0), last):
        out, m = emulate_block(x, wt, stride, pads, tiling, bx, by)
        assert m == m_total
        rows = min(bm, m_total - bx * bm)
        cols = min(bn, cout - by * bn)
        assert np.array_equal(out[:rows, :cols],
                              ref[bx * bm:bx * bm + rows,
                                  by * bn:by * bn + cols])
        # rows past M and columns past Cout summed zeros
        assert not out[rows:].any() and not out[:, cols:].any()


@pytest.mark.parametrize('bk', [64, 128])
def test_producer_copies_hit_distinct_banks(bk):
    """Each phase of a warp's 16-byte cp.asyncs (8 threads) writes eight
    different 16-byte bank groups of the swizzled tile."""

    chunks = bk // 16
    for bm in (64, 128):
        threads = 2 * bm
        for t0 in range(0, threads, 8):
            t = np.arange(t0, t0 + 8)
            for i in range(4):
                r = t // chunks + (threads // chunks) * i
                off = md_swizzle(r * bk + 16 * (t % chunks), bk)
                assert len(set((off // 16) % 8)) == 8


@pytest.mark.parametrize('n', [64, 128])
def test_staging_stores_hit_distinct_banks(n):
    """Each half-warp's 8-byte accumulator stores into the [bm][n + 8]
    staging tile cover 32 distinct banks."""

    row, col = staging_coords(n)
    word = row * (n + 8) + col
    for half in range(8):
        lanes = slice(16 * half, 16 * half + 16)
        for j in range(n // 8):
            for h in range(2):
                words = word[lanes, 4 * j + 2 * h:4 * j + 2 * h + 2]
                assert len(set((words % 32).ravel())) == 32
