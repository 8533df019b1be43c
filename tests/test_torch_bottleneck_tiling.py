"""
The fused int8 bottleneck kernel's tiling, routing and data layout,
checked on the CPU (csrc/bottleneck_int8.cu, csrc/wgmma_int8.cuh; no card
needed).

- kernel_tiling / bottleneck_tiling (ops/bottleneck_int8.py) over all 42
  bottlenecks of yolov5l6 at both 1280 px canvases (geometry from the
  model's own forward on the meta device): instances, grids, shared
  memory, and which ones the int8 chain routes unfused.
- Routing (models/yolov5.py Bottleneck): either route gives the unfused
  chain's output.
- A numpy emulation of one block of the kernel, written from the source:
  phase 1's cp.async chunks at their swizzled ring offsets and what wgmma
  reads of them, the accumulators by wgmma's register layout, the h1
  tile's stores into its K-major no-swizzle layout (zeros at halo pixels
  off the image), phase 2's A reads of all nine taps through the
  no-swizzle descriptor (the PTX canonical layout ((8, m), (16, 2)) :
  ((16, SBO), (1, LBO)) in bytes) and its B stages, the staged h2 and the
  coalesced residual pass. Shared memory starts as random bytes, so the
  channels past C of h1 hold garbage that only zero weights meet. It must
  give back every stage's tiles, the plain version's int32 sums of both
  convs and its int8 output.
"""

import numpy as np
import pytest
import torch

from megadetector_tpu_torch.models import yolov5
from megadetector_tpu_torch.ops import bottleneck_int8, conv_int8
from megadetector_tpu_torch.ops import quantization as q
from test_torch_conv_tiling import (accumulator_coords, md_smem_desc,
                                    md_swizzle, staging_coords, wgmma_read)

# csrc/bottleneck_int8.cu
TH, TW = bottleneck_int8.TILE
HW_ = TW + 2
HALO = bottleneck_int8.HALO_PIXELS
LBO = HALO * 16
SBO = HW_ * 16
BK = bottleneck_int8.BK
RING = bottleneck_int8.RING_BYTES
SLOT2 = 16 * 1024  # phase 2's stage


#%% Tiling and routing


def _bottlenecks(height, width, batch=8):
    """[(b, h, w, c)] of every bottleneck of yolov5l6 on a batch of
    [batch]: each is a 1x1 C->C 'cv1' followed by its 3x3 'cv2'."""

    shapes = yolov5.activated_conv_shapes(
        yolov5.YoloV5Config('yolov5l6', num_classes=3), height, width, batch)
    out = []
    for d in shapes:
        if '.m' in d['name'] and d['name'].endswith('cv1'):
            assert d['k'] == 1 and d['cin'] == d['cout']
            out.append((d['batch'], d['h'], d['w'], d['cin']))
    return out


@pytest.mark.parametrize('height,width,fused', [(960, 1280, 36),
                                                (768, 1280, 36),
                                                (1280, 1280, 36)])
def test_tiling_of_the_yolov5l6_bottlenecks(height, width, fused):
    """42 bottlenecks at each canvas: every C takes 16-byte copies, BN 64
    at C = 64 else 128, within the 227 KB a block may use (two blocks an
    SM up to C = 256); the six at C = 512 (24 blocks, 48 on the square
    canvas of a tile) run unfused, every other level has at least
    MIN_BLOCKS."""

    bottlenecks = _bottlenecks(height, width)
    assert len(bottlenecks) == 42
    assert sorted({c for _, _, _, c in bottlenecks}) == [64, 128, 256, 384,
                                                         512]
    routed = 0
    for b, h, w, c in bottlenecks:
        t = bottleneck_int8.kernel_tiling(c)
        assert t.vec == 16 and t.bn == (64 if c == 64 else 128)
        assert t.smem == bottleneck_int8.smem_bytes(c) <= \
            bottleneck_int8.MAX_SMEM
        # two blocks an SM: 228 KB per SM, 1 KB reserved per block
        assert (2 * (t.smem + 1024) <= 233472) == (c <= 256)
        grid = bottleneck_int8.bottleneck_grid(b, h, w)
        assert grid == b * -(-h // 16) * -(-w // 8)
        picked = bottleneck_int8.bottleneck_tiling(b, h, w, c)
        if c == 512:
            assert picked is None and grid == (48 if height == 1280
                                               else 24)
        else:
            assert picked == t and grid >= bottleneck_int8.MIN_BLOCKS
            routed += 1
    assert routed == fused


@pytest.mark.parametrize('height,width,unfused', [
    (960, 1280, {(15, 20, 512): 3, (30, 40, 384): 10, (60, 80, 256): 40}),
    (768, 1280, {(12, 20, 512): 3, (24, 40, 384): 10, (48, 80, 256): 30}),
    (1280, 1280, {(20, 20, 512): 6, (40, 40, 384): 15,
                  (80, 80, 256): 50})])
def test_routing_of_the_yolov5l6_bottlenecks_at_batch_1(height, width,
                                                        unfused):
    """One image a batch (the single-image driver, a video's or a folder's
    tail): the grids of the three deepest levels fall under MIN_BLOCKS, so
    their 30 bottlenecks run as two conv launches each; the 12 at C = 64
    and 128 stay fused."""

    routed = 0
    seen = {}
    for b, h, w, c in _bottlenecks(height, width, batch=1):
        assert b == 1
        grid = bottleneck_int8.bottleneck_grid(b, h, w)
        picked = bottleneck_int8.bottleneck_tiling(b, h, w, c)
        if grid < bottleneck_int8.MIN_BLOCKS:
            assert picked is None
            seen[(h, w, c)] = grid
        else:
            assert picked == bottleneck_int8.kernel_tiling(c) and c <= 128
            routed += 1
    assert seen == unfused
    assert routed == 12


@pytest.mark.parametrize('c,aligned,want', [
    (36, True, (64, 4)), (516, True, (128, 4)), (64, False, (64, 4)),
    (896, True, (128, 16)), (900, True, None), (1024, True, None),
    (6, True, None), (0, True, None)])
def test_kernel_tiling_edges(c, aligned, want):
    """C % 16 != 0 or a misaligned tensor: 4-byte copies; C up to 896 fits
    shared memory; C not a positive multiple of 4 never runs."""

    t = bottleneck_int8.kernel_tiling(c, aligned)
    if want is None:
        assert t is None
        assert bottleneck_int8.bottleneck_tiling(8, 240, 320, c) is None
        return
    assert (t.bn, t.vec) == want
    assert t.code == ((bottleneck_int8.INST_VEC16 if t.vec == 16 else 0) |
                      (bottleneck_int8.INST_BN128 if t.bn == 128 else 0))


def _bottleneck_case(rng, b, h, w, c):
    x = torch.from_numpy(rng.randint(-127, 128, (b, h, w, c)).astype(
        np.int8))
    convs = []
    for k in (1, 3):
        wq = torch.from_numpy(rng.randint(-127, 128, (c, k, k, c)).astype(
            np.int8))
        scale = torch.from_numpy((rng.uniform(0.5, 1.5, c) / (
            np.sqrt(c * k * k) * 127.0)).astype(np.float32))
        bias = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(
            np.float32))
        convs.append((wq, scale, bias))
    return x, convs


@pytest.mark.parametrize('b,h,w,c,fused', [(8, 64, 64, 16, True),
                                           (2, 9, 13, 24, False)])
def test_routing_gives_the_unfused_chain(b, h, w, c, fused, monkeypatch):
    """A fused int8 Bottleneck takes the kernel where bottleneck_tiling
    takes its shape (the plain version on the CPU) and its two convs and
    the add elsewhere: both give the unfused chain exactly."""

    rng = np.random.RandomState(c + h)
    x, convs = _bottleneck_case(rng, b, h, w, c)
    assert (bottleneck_int8.bottleneck_tiling(b, h, w, c) is not None) == \
        fused
    calls = []
    kernel = bottleneck_int8.bottleneck_int8
    monkeypatch.setattr(bottleneck_int8, 'bottleneck_int8',
                        lambda *a: calls.append(a) or kernel(*a))
    xq = q.QTensor(x, 0.011)
    for shortcut in (True, False):
        modules = {}
        for fuse in (True, False):
            m = yolov5.Bottleneck(c, shortcut, fused=fuse)
            for name, (wq, ws, bias), y_scale in (
                    ('cv1', convs[0], 0.021), ('cv2', convs[1], 0.033)):
                setattr(m, name, yolov5.QConv(getattr(m, name), {
                    'w_q': wq, 'w_scale': ws, 'b': bias, 'x_scale': 0.01,
                    'y_scale': y_scale}))
            modules[fuse] = m
        n_calls = len(calls)
        got = modules[True](xq)
        assert len(calls) - n_calls == int(fused)
        want = modules[False](xq)
        assert got.scale == want.scale
        assert torch.equal(got.q, want.q)


#%% The kernel's block, emulated


def md_smem_desc_interleave(addr, lbo, sbo):
    """wgmma_int8.cuh md_smem_desc_interleave (layout 0 in bits 62-63)."""

    return (((addr >> 4) & 0x3FFF) | (((lbo >> 4) & 0x3FFF) << 16) |
            (((sbo >> 4) & 0x3FFF) << 32))


def wgmma_read_interleave(smem, desc, rows):
    """The [rows, 32] bytes one k32 step of wgmma reads through a K-major
    descriptor without swizzle, by the PTX canonical layout: core matrices
    of 8 rows x 16 bytes, row r of one at r * 16; the next 8 rows SBO
    bytes on, the next 16 K bytes LBO bytes on."""

    assert desc >> 62 == 0
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return smem[start + (r // 8) * sbo + (r % 8) * 16 + (k // 16) * lbo +
                k % 16]


def _copy_chunk(line, ch, c, vec):
    """The 16 bytes a thread's cp.async chunk lands: line[ch:ch + 16] up
    to C, as one 16-byte copy or four 4-byte words; zeros without a
    source line."""

    chunk = np.zeros(16, np.int8)
    if line is not None:
        step = 16 if vec == 16 else 4
        for j in range(0, 16, step):
            if c - ch > j:
                chunk[j:j + step] = line[ch + j:ch + j + step]
    return chunk


def _halo_pixel(p, y0, x0, h, w):
    hy, hx = divmod(p, HW_)
    iy, ix = y0 - 1 + hy, x0 - 1 + hx
    ok = p < HALO and 0 <= iy < h and 0 <= ix < w
    return ok, iy, ix


def emulate_block(x, convs, scales, shortcut, tiling, bx, by, bi,
                  raw=0x230):
    """
    Block (bx, by) of image bi, emulated from csrc/bottleneck_int8.cu.
    [scales] = (mid_scale, cv2_scale, s_in). Returns (phase-1 sums
    {(pixel, n): int}, phase-2 sums [128, C], int8 output [16, 8, C] with
    -128 where the block stores nothing). Asserts every stage's tiles as
    it goes.
    """

    (w1, s1, b1), (w2, s2, b2) = convs
    mid_scale, cv2_scale, s_in = scales
    bn, vec = tiling
    _, h, w, c = x.shape
    x0, y0 = bx * TW, by * TH
    nk, nn = -(-c // BK), -(-c // bn)
    slot_a = 128 * BK
    slot1 = slot_a + bn * BK
    slots1 = RING // slot1
    unit2 = bn * BK
    kunits, slots2 = SLOT2 // unit2, RING // SLOT2
    pitch = bn + 16
    base = (raw + 1023) & ~1023
    h1_off = base + RING
    cp = nk * BK
    rng = np.random.RandomState(bx + 7 * by)
    smem = rng.randint(-128, 128, h1_off + HALO * cp).astype(np.int8)
    w1m = w1.numpy().reshape(c, c)
    w2m = w2.numpy()
    xn = x.numpy()
    want_r, want_c = accumulator_coords(bn)
    row_of, col_of = staging_coords(bn)

    # Phase 1: (mc, nc, kc) stages, kc fastest
    sums1 = {}
    h1_written = np.zeros(HALO * cp, np.int64)
    acc = np.zeros((2, 64, bn), np.int64)
    for s in range(2 * nn * nk):
        kc, nc, mc = s % nk, s // nk % nn, s // (nk * nn)
        slot = base + kc % slots1 * slot1  # each group restarts the ring
        for t in range(256):
            cc, r0 = t % 4, t // 4
            ch = kc * BK + 16 * cc
            for r in (r0, r0 + 64):
                ok, iy, ix = _halo_pixel(128 * mc + r, y0, x0, h, w)
                dst = slot + md_swizzle(r * BK + 16 * cc, BK)
                smem[dst:dst + 16] = _copy_chunk(
                    xn[bi, iy, ix] if ok else None, ch, c, vec)
            for r in range(r0, bn, 64):
                n = nc * bn + r
                dst = slot + slot_a + md_swizzle(r * BK + 16 * cc, BK)
                smem[dst:dst + 16] = _copy_chunk(
                    w1m[n] if n < c else None, ch, c, vec)
        b_tile = np.concatenate([wgmma_read(
            smem, md_smem_desc(slot + slot_a, BK) + 2 * kk, bn)
            for kk in range(BK // 32)], 1)
        wb = np.zeros((bn, cp + BK), np.int8)
        nv = min(bn, c - nc * bn)
        wb[:nv, :c] = w1m[nc * bn:nc * bn + nv]
        assert np.array_equal(b_tile, wb[:, kc * BK:(kc + 1) * BK])
        for wg in range(2):
            # both warpgroups multiply at every stage; rows past the halo
            # (the upper half of the second chunk) are zeros
            a_tile = np.concatenate([wgmma_read(
                smem, md_smem_desc(slot + wg * 64 * BK, BK) + 2 * kk, 64)
                for kk in range(BK // 32)], 1)
            for m in range(64):
                ok, iy, ix = _halo_pixel(128 * mc + 64 * wg + m, y0, x0, h,
                                         w)
                line = np.zeros(cp + BK, np.int8)
                if ok:
                    line[:c] = xn[bi, iy, ix]
                assert np.array_equal(a_tile[m],
                                      line[kc * BK:(kc + 1) * BK])
            acc[wg] += a_tile.astype(np.int64) @ b_tile.astype(np.int64).T
        if kc == nk - 1:
            # epilogue1: registers by wgmma's layout -> h1 stores
            for wg in range(2):
                regs = acc[wg][want_r, want_c]
                ns = np.minimum(nc * bn + col_of, c - 1)
                vals = conv_int8.chain_epilogue_reference(
                    torch.from_numpy(regs.astype(np.int32)), s1[ns], b1[ns],
                    mid_scale).numpy()
                for ti in range(128):
                    for v in range(bn // 2):
                        p = 128 * mc + 64 * wg + row_of[ti, v]
                        n = nc * bn + col_of[ti, v]
                        if p >= HALO or n >= c:
                            continue
                        ok, _, _ = _halo_pixel(p, y0, x0, h, w)
                        sums1[(p, n)] = int(regs[ti, v])
                        off = (n // 16) * LBO + p * 16 + n % 16
                        smem[h1_off + off] = vals[ti, v] if ok else 0
                        h1_written[off] += 1
            acc[:] = 0
    # every byte of h1 below C written once
    h1_mask = np.zeros((cp // 16, HALO, 16), bool)
    h1_mask[:c // 16] = True
    if c % 16:
        h1_mask[c // 16, :, :c % 16] = True
    assert (h1_written.reshape(h1_mask.shape)[h1_mask] == 1).all()
    assert not h1_written.reshape(h1_mask.shape)[~h1_mask].any()

    # Phase 2: a group per N chunk nc; stage i holds units u = kunits i +
    # q, (tap, kc) = divmod(u, nk), each a [bn][64] swizzled tile
    h1_ref = conv_int8.conv_int8_reference(x, w1, s1, b1, (1, 1),
                                           (0, 0, 0, 0), mid_scale).numpy()
    h1_pad = np.zeros((h + TH + 2, w + TW + 2, c), np.int8)
    h1_pad[1:h + 1, 1:w + 1] = h1_ref[bi]
    sums2 = np.zeros((128, c), np.int64)
    out = np.full((TH, TW, c), -128, np.int64)
    units = 9 * nk
    stages = -(-units // kunits)
    for nc in range(nn):
        acc = np.zeros((2, 64, bn), np.int64)
        for i in range(stages):
            slot = base + i % slots2 * SLOT2
            for q in range(kunits):
                u = kunits * i + q
                if u >= units:
                    break
                tap, kc = divmod(u, nk)
                dy, dx = divmod(tap, 3)
                unit = slot + q * unit2
                for t in range(256):
                    cc, r0 = t % 4, t // 4
                    ch = kc * BK + 16 * cc
                    for r in range(r0, bn, 64):
                        n = nc * bn + r
                        dst = unit + md_swizzle(r * BK + 16 * cc, BK)
                        smem[dst:dst + 16] = _copy_chunk(
                            w2m[n, dy, dx] if n < c else None, ch, c, vec)
                b_tile = np.concatenate([wgmma_read(
                    smem, md_smem_desc(slot, BK) + q * (unit2 >> 4) + 2 * kk,
                    bn) for kk in range(BK // 32)], 1)
                wb = np.zeros((bn, cp + BK), np.int8)
                nv = min(bn, c - nc * bn)
                wb[:nv, :c] = w2m[nc * bn:nc * bn + nv, dy, dx]
                assert np.array_equal(b_tile, wb[:, kc * BK:(kc + 1) * BK])
                for wg in range(2):
                    a0 = h1_off + ((8 * wg + dy) * HW_ + dx) * 16 + \
                        4 * kc * LBO
                    a_tile = np.concatenate([wgmma_read_interleave(
                        smem, md_smem_desc_interleave(a0 + 2 * kk * LBO,
                                                      LBO, SBO), 64)
                        for kk in range(BK // 32)], 1)
                    # rows: tile pixel (8 wg + m / 8, m % 8) shifted by the
                    # tap; channels past C hold garbage, met only by zero
                    # weights
                    m = np.arange(64)
                    want = h1_pad[y0 + 8 * wg + m // 8 + dy, x0 + m % 8 + dx]
                    valid = min(BK, c - kc * BK)
                    assert np.array_equal(a_tile[:, :valid],
                                          want[:, kc * BK:kc * BK + valid])
                    assert not b_tile[:, valid:].any()
                    acc[wg] += a_tile.astype(np.int64) @ \
                        b_tile.astype(np.int64).T
        cols = slice(nc * bn, min(c, (nc + 1) * bn))
        for wg in range(2):
            sums2[64 * wg:64 * wg + 64, cols] = \
                acc[wg][:, :cols.stop - cols.start]
            # epilogue2: h2 into the staging tile at the drained ring's
            # start, by the register layout
            regs = acc[wg][want_r, want_c]
            ns = np.minimum(nc * bn + col_of, c - 1)
            vals = conv_int8.chain_epilogue_reference(
                torch.from_numpy(regs.astype(np.int32)), s2[ns], b2[ns],
                cv2_scale).numpy()
            keep = nc * bn + col_of < c
            rows = 64 * wg + row_of
            smem[base + (rows * pitch + col_of)[keep]] = vals[keep]
        # read back [unit] bytes a thread, residual, stores
        for u in range(128 * (bn // vec)):
            row, col = divmod(u, bn // vec)
            col *= vec
            ty, tx = divmod(row, TW)
            n = nc * bn + col
            if y0 + ty >= h or x0 + tx >= w or n >= c:
                continue
            at = base + row * pitch + col
            hv = torch.from_numpy(smem[at:at + vec].copy())
            if shortcut:
                hv = bottleneck_int8.residual_requant(
                    x[bi, y0 + ty, x0 + tx, n:n + vec], s_in, hv,
                    cv2_scale)[0]
            out[ty, tx, n:n + vec] = hv.numpy()
    return sums1, sums2, out


EMULATED = [
    # C 64, BN 64, 16-byte copies: the first block (top-left corner) and
    # the last (W 12 off the 8-wide tile)
    (1, 9, 12, 64, (64, 16), True, (0, 0)),
    (1, 9, 12, 64, (64, 16), False, (1, 0)),
    # C 128, BN 128: H 20 off the 16-high tile, two K stages
    (1, 20, 8, 128, (128, 16), True, (0, 1)),
    # C 36 on 4-byte words: K and N tails in one stage, one block
    (2, 5, 7, 36, (64, 4), True, (0, 0)),
    # C 144: a 1-pixel-high image, two N chunks (the second 16 wide),
    # three K stages (the last 16 bytes)
    (1, 1, 9, 144, (128, 16), True, (1, 0)),
]


@pytest.mark.parametrize('b,h,w,c,tiling,shortcut,block', EMULATED)
def test_emulated_block_gives_the_bottleneck(b, h, w, c, tiling, shortcut,
                                             block):
    """Every stage's A and B tiles come back through the descriptors; the
    block's phase-1 sums equal the plain 1x1's int32 sums at every halo
    pixel in the image, its phase-2 sums the plain 3x3's on h1, and its
    output the plain bottleneck's, bit for bit."""

    rng = np.random.RandomState(c + h + w)
    x, convs = _bottleneck_case(rng, b, h, w, c)
    assert bottleneck_int8.kernel_tiling(c)[:2] == tiling
    scales = (0.021, 0.033, 0.011)
    bi = b - 1
    bx, by = block
    sums1, sums2, out = emulate_block(x, convs, scales, shortcut, tiling,
                                      bx, by, bi)
    x0, y0 = bx * TW, by * TH
    (w1, s1, b1), (w2, s2, b2) = convs
    ref1 = conv_int8.conv_int32_reference(x, w1, (1, 1),
                                          (0, 0, 0, 0)).numpy()[bi]
    n_in = 0
    for (p, n), v in sums1.items():
        ok, iy, ix = _halo_pixel(p, y0, x0, h, w)
        if ok:
            assert v == ref1[iy, ix, n]
            n_in += 1
        else:
            assert v == 0  # zero-filled rows
    assert n_in == c * sum(_halo_pixel(p, y0, x0, h, w)[0]
                           for p in range(HALO))
    h1 = conv_int8.conv_int8_reference(x, w1, s1, b1, (1, 1), (0, 0, 0, 0),
                                       scales[0])
    ref2 = conv_int8.conv_int32_reference(h1, w2, (1, 1),
                                          (1, 1, 1, 1)).numpy()[bi]
    want, _ = bottleneck_int8.bottleneck_int8_reference(
        x, w1, s1, b1, scales[0], w2, s2, b2, scales[1], scales[2],
        shortcut)
    want = want.numpy()[bi]
    stored = 0
    for row in range(128):
        ty, tx = divmod(row, TW)
        oy, ox = y0 + ty, x0 + tx
        if oy < h and ox < w:
            assert np.array_equal(sums2[row], ref2[oy, ox])
            assert np.array_equal(out[ty, tx], want[oy, ox])
            stored += 1
        else:
            assert (out[ty, tx] == -128).all()  # nothing stored
    assert stored == min(TH, h - y0) * min(TW, w - x0) > 0


@pytest.mark.parametrize('bn', [64, 128])
def test_stores_hit_distinct_banks(bn):
    """Each warp's 2-byte stores of one accumulator pair, into the h1 tile
    (phase 1) and into the [128][bn + 16] staging tile (phase 2), touch
    each 4-byte bank at most through one word; the read-back's 16-byte
    loads of a quarter warp cover eight distinct 16-byte bank groups at BN
    128 (at BN 64 a quarter warp spans two 80-byte rows: two ways at
    most)."""

    row, col = staging_coords(bn)
    pitch = bn + 16
    for lanes in (slice(w * 32, w * 32 + 32) for w in range(4)):
        for j in range(bn // 8):
            for hh in range(2):
                v = 4 * j + 2 * hh
                r, cl = row[lanes, v], col[lanes, v]
                for addr in (r * pitch + cl,
                             (cl // 16) * LBO + r * 16 + cl % 16):
                    words = addr // 4
                    banks = {}
                    for word in words:
                        banks.setdefault(word % 32, set()).add(word)
                    assert all(len(ws) == 1 for ws in banks.values())
    units = bn // 16
    for q0 in range(0, 128 * units, 8):
        u = np.arange(q0, q0 + 8)
        addr = (u // units) * pitch + (u % units) * 16
        ways = np.bincount((addr // 16) % 8, minlength=8)
        assert ways.max() == (1 if bn == 128 else 2)
