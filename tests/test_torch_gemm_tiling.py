"""
The int8 GEMM kernel's tiling and data layout, checked on the CPU
(csrc/gemm_int8.cu, csrc/wgmma_int8.cuh; no card needed).

- gemm_tiling (ops/gemm_int8.py), the padding and persistent grid each
  call launches with, at every shape the experiment entry points launch
  at batches 8 and 64, at chip_smoke.py's phase-14 shapes and at the card
  tests' shapes; the persistent walk covers every output tile once, and
  the two consumer warpgroups split a block's tiles.
- The transpose and pad pre-passes, emulated from the source, against
  their plain versions.
- A numpy emulation of the kernel, written from the source notes: each
  block's TMA boxes placed in the ring under the 128-byte swizzle
  (md_swizzle), what wgmma reads through the descriptor (md_smem_desc)
  stage by stage, the accumulators by wgmma's register layout, and the
  staged epilogue's reads, against the plain int32 product and the fused
  requant, tails included; the ring's mbarrier phases over a persistent
  walk, with the consumers' order barrier and without it (where a wait
  passes on an older phase); bank checks of the shared-memory accesses.
"""

import os
import re

import numpy as np
import pytest
import torch

from megadetector_tpu_torch.experiments import exp_int8_chain, exp_int8_matmul
from megadetector_tpu_torch.ops import _build, conv_int8, gemm_int8

from test_torch_conv_tiling import (accumulator_coords, md_smem_desc,
                                    md_swizzle, wgmma_read)

with open(os.path.join(_build.CSRC_DIR, 'gemm_int8.cu')) as _f:
    SOURCE = _f.read()

# csrc/gemm_int8.cu: K bytes of a ring stage, the element-store
# epilogue's staging row in words (32 columns + 8), a consumer's staging
# bytes ([64] such rows; the TMA store's 8 KB box fits in them) and the
# shared memory a block may use
BK = 128
STAGING_PITCH = 40
STAGING_BYTES = 64 * STAGING_PITCH * 4
SMEM_MAX = 232448
# The ring's stages: what shared memory holds after 1024 bytes of
# alignment slack, the two consumers' staging and 256 bytes for the
# barriers
RING_STAGES = (SMEM_MAX - 1024 - 2 * STAGING_BYTES - 256) // (
    (gemm_int8.BM + gemm_int8.BN) * BK)


def block_tiles(tiling, block):
    """The (row, column) origins of the output tiles persistent block
    [block] computes, in its order: tile = block + i * grid, row band
    tile // tiles_n, column tile tile % tiles_n. Its consumer warpgroup c
    takes the block's tiles c, c + 2, ..."""

    return [(t // tiling.tiles_n * gemm_int8.BM,
             t % tiling.tiles_n * gemm_int8.BN)
            for t in range(block, tiling.tiles, tiling.grid)]


def smem_bytes():
    """Dynamic shared memory of a block: 1024 bytes of alignment slack,
    the ring, two consumers' staging tiles and two mbarriers a stage."""

    return (1024 + RING_STAGES * (gemm_int8.BM + gemm_int8.BN) * BK +
            2 * STAGING_BYTES + 16 * RING_STAGES)


def tma_store(n, requant):
    """Whether the epilogue stores through TMA (the source's g.tma_store):
    the int8 output with rows of 16-byte multiples (N % 16 == 0). The
    int32 output, and other widths, go out element by element."""

    return bool(requant) and n % 16 == 0


def transpose_pad_reference(b, kp):
    """Plain version of the transpose pre-pass: bt [N, kp] = b^T with zero
    columns from K on."""

    k, n = b.shape
    bt = np.zeros((n, kp), np.int8)
    bt[:, :k] = b.T
    return bt

# The card tests' shapes (tests/test_torch_cuda.py)
CARD_SHAPES = [(512, 1152, 512), (1000, 300, 72), (37, 45, 29),
               (65, 130, 66), (1, 4, 4), (4097, 2304, 256),
               (17000, 160, 700), (300, 1000, 200), (129, 16, 257),
               (2000, 4096, 129), (333, 512, 384)]
PHASE14 = [(65536, 1152, 1152), (38400, 2304, 256), (4096, 2048, 2048)]


def _experiment_shapes():
    shapes = set(PHASE14 + CARD_SHAPES)
    for batch in (8, 64):
        for rows, k in exp_int8_chain.MM_SHAPES:
            shapes.add((rows * batch, k, k))
        for m, k, n, _ in exp_int8_matmul.mm_shapes(batch):
            shapes.add((m, k, n))
    shapes.add(exp_int8_chain.CHECK_SHAPE)
    shapes.add(exp_int8_matmul.CHECK_SHAPE)
    return sorted(shapes)


SHAPES = _experiment_shapes()


#%% The source's constants and instances


def _constant(name):
    return int(re.search(r'constexpr int {} = (\d+);'.format(name),
                         SOURCE).group(1))


def test_python_mirrors_the_source():
    """The copies of the kernel's constants (ops/gemm_int8.py's tile, this
    file's ring and staging) agree with csrc/gemm_int8.cu."""

    assert _constant('kBM') == gemm_int8.BM
    assert _constant('kBN') == gemm_int8.BN
    assert _constant('kBK') == BK
    assert _constant('kChunk') + 8 == STAGING_PITCH
    assert _constant('kSmemMax') == SMEM_MAX
    assert 'kPitch = kChunk + 8' in SOURCE
    assert 'kStaging = 64 * kPitch * 4' in SOURCE
    # the TMA store's int8 box [64 rows x 128 bytes] fits the staging
    assert STAGING_BYTES >= 64 * 128
    assert ('kStages = (kSmemMax - 1024 - 2 * kStaging - 256) / kStage'
            in SOURCE)
    # one consumer warpgroup (four warps) releases each stage
    assert 'md_mbarrier_init(empty + 8 * s, 4)' in SOURCE


def test_block_fits_shared_memory():
    """The ring has at least three stages (six) and the block fits the
    card's 227 KB of shared memory, one block an SM; one stage more would
    not fit."""

    assert RING_STAGES == 6
    assert smem_bytes() <= SMEM_MAX
    assert (smem_bytes() + (gemm_int8.BM + gemm_int8.BN) *
            BK > SMEM_MAX)


#%% gemm_tiling and the persistent walk


@pytest.mark.parametrize('m,k,n', SHAPES)
def test_tiling_of_the_experiment_shapes(m, k, n):
    """K pads to 16 bytes, a is copied only when TMA cannot read it, and
    the grid is min(tiles, SMs)."""

    t = gemm_int8.gemm_tiling(m, k, n)
    assert t.kp % 16 == 0 and k <= t.kp < k + 16 and t.kp >= 16
    assert t.pad_a == (k % 16 != 0)
    assert t.tiles_n == -(-n // 128)
    assert t.tiles == -(-m // 128) * t.tiles_n
    assert t.grid == min(t.tiles, conv_int8.SMS)
    assert gemm_int8.gemm_tiling(m, k, n, aligned=False).pad_a
    if (m, k, n) in PHASE14:
        assert not t.pad_a and t.grid == conv_int8.SMS


@pytest.mark.parametrize('k,kp,pad', [(0, 16, True), (4, 16, True),
                                      (16, 16, False), (45, 48, True),
                                      (1152, 1152, False),
                                      (1000, 1008, True)])
def test_padding(k, kp, pad):
    """Kp is K rounded up to 16 (at least 16); a is padded exactly when Kp
    differs from K."""

    t = gemm_int8.gemm_tiling(300, k, 200)
    assert (t.kp, t.pad_a) == (kp, pad)


@pytest.mark.parametrize('m,k,n', SHAPES)
def test_persistent_walk_covers_every_tile_once(m, k, n):
    """Blocks 0 .. grid - 1 together compute every output tile exactly
    once, at the picked grid and at others (a grid smaller and larger than
    the card's 132 SMs); a block's two consumers take its tiles in turn."""

    t = gemm_int8.gemm_tiling(m, k, n)
    want = {(r, c) for r in range(0, m, 128) for c in range(0, n, 128)}
    for grid in {t.grid, 1, 7, 131, t.tiles + 3}:
        seen = []
        for block in range(grid):
            mine = block_tiles(t._replace(grid=grid), block)
            assert len(mine) == (
                (t.tiles - 1 - block) // grid + 1 if block < t.tiles else 0)
            halves = mine[0::2], mine[1::2]
            assert len(halves[0]) - len(halves[1]) in (0, 1)
            seen += mine
        assert len(seen) == len(want) and set(seen) == want
    # the N index varies fastest: the blocks in flight share row bands
    first = [block_tiles(t, b)[0] for b in range(t.grid)]
    assert len({r for r, _ in first}) == -(-t.grid // t.tiles_n)


#%% The pre-passes, emulated


def emulate_transpose(b, kp):
    """transpose_kernel: 64 x 64 byte tiles of b [K, N] through the
    [64][68] shared tile, written to bt [N, kp] with zeros from K on."""

    k, n = b.shape
    bt = np.full((n, kp), 99, np.int8)  # every byte must be written
    for n0 in range(0, n, 64):
        for k0 in range(0, kp, 64):
            tile = np.zeros((64, 68), np.int8)
            for i in range(64 * 64):
                r, c = divmod(i, 64)
                kk, nn = k0 + r, n0 + c
                tile[r, c] = b[kk, nn] if kk < k and nn < n else 0
            for i in range(64 * 64):
                r, c = divmod(i, 64)
                nn, kk = n0 + r, k0 + c
                if nn < n and kk < kp:
                    bt[nn, kk] = tile[c, r]
    return bt


def emulate_pad(a, kp):
    """pad_kernel: ap [M, kp] from a [M, K], zeros from K on."""

    m, k = a.shape
    flat = a.reshape(-1)
    ap = np.empty(m * kp, np.int8)
    for i in range(m * kp):
        r, c = divmod(i, kp)
        ap[i] = flat[r * k + c] if c < k else 0
    return ap.reshape(m, kp)


@pytest.mark.parametrize('k,n', [(4, 4), (45, 29), (130, 66), (64, 128),
                                 (0, 7), (160, 70)])
def test_transpose_and_pad_prepasses(k, n):
    """The pre-passes, emulated, give the plain transpose and padding
    (transpose_pad_reference), whatever K and N."""

    rng = np.random.RandomState(k + n)
    b = rng.randint(-128, 128, (k, n)).astype(np.int8)
    kp = gemm_int8.padded_k(k)
    want = transpose_pad_reference(b, kp)
    assert want.shape == (n, kp) and np.array_equal(want[:, :k], b.T)
    assert not want[:, k:].any()
    assert np.array_equal(emulate_transpose(b, kp), want)
    a = rng.randint(-128, 128, (3, k)).astype(np.int8)
    ap = emulate_pad(a, kp)
    assert np.array_equal(ap[:, :k], a) and not ap[:, k:].any()


#%% The kernel, emulated


def tma_box(smem, dst, mat, r0, c0, box_rows):
    """A TMA load of the [box_rows x 128 byte] box of the row-major int8
    matrix [mat] at (row r0, K byte c0) into shared memory at the
    1024-byte aligned [dst] under CU_TENSOR_MAP_SWIZZLE_128B: 16-byte
    chunk c of box row i lands at md_swizzle(dst + 128 i + 16 c), zeros
    out of bounds. Returns how often each shared byte was written."""

    rows, kp = mat.shape
    box = np.zeros((box_rows, BK), np.int8)
    r1, c1 = min(rows, r0 + box_rows), min(kp, c0 + BK)
    if r1 > r0 and c1 > c0:
        box[:r1 - r0, :c1 - c0] = mat[r0:r1, c0:c1]
    i = np.arange(box_rows)[:, None]
    c = np.arange(BK // 16)[None, :]
    addr = md_swizzle(dst + BK * i + 16 * c, 128)
    idx = (addr[..., None] + np.arange(16)).ravel()
    smem[idx] = box.ravel()
    count = np.zeros(smem.shape, np.int64)
    np.add.at(count, idx, 1)
    return count


def staging_store_words(n_cols=32):
    """Word offsets in a warpgroup's [64][40] staging tile of the int2
    stores of one 32-column step: [thread, jj, h, q] -> word, from the
    source: (acc_row + 8 h) * kPitch + 8 jj + acc_col + q."""

    t = np.arange(128)[:, None, None, None]
    jj = np.arange(n_cols // 8)[None, :, None, None]
    h = np.arange(2)[None, None, :, None]
    q = np.arange(2)[None, None, None, :]
    acc_row = 16 * (t // 32) + (t % 32) // 4
    acc_col = 2 * (t % 4)
    return ((acc_row + 8 * h) * STAGING_PITCH + 8 * jj + acc_col +
            q)


def readback_words():
    """[thread, pass] -> (staging row, first word) of the epilogue's
    16-byte reads: row lt / 8 + 16 pass, column 4 (lt % 8)."""

    t = np.arange(128)[:, None]
    p = np.arange(4)[None, :]
    r = t // 8 + 16 * p
    return r, r * STAGING_PITCH + 4 * (t % 8)


def epilogue(acc64, bn):
    """A consumer warpgroup's m64 x bn accumulators (by wgmma's register
    layout) through the staging steps: the [64, bn] values the threads
    read back, in place."""

    regs_r, regs_c = accumulator_coords(bn)
    regs = acc64[regs_r, regs_c]  # [thread, register]
    out = np.full((64, bn), -(1 << 40), np.int64)
    words = staging_store_words()
    rows, starts = readback_words()
    t = np.arange(128)[:, None]
    for ch in range(bn // 32):
        stg = np.full(64 * STAGING_PITCH, -(1 << 41), np.int64)
        for jj in range(4):
            j = 4 * ch + jj
            for h in range(2):
                for q in range(2):
                    stg[words[:, jj, h, q]] = regs[:, 4 * j + 2 * h + q]
        col = 32 * ch + 4 * (t % 8)  # [thread, 1]
        for e in range(4):
            out[rows, col + e] = stg[starts + e]
    return out


def tma_staging_offsets():
    """Byte offsets in a consumer's staging of the TMA-store epilogue's
    2-byte writes, [thread, j, h] -> the offset of int8 columns 8 j +
    acc_col (+1) of row acc_row + 8 h, from the source:
    md_swizzle<128>(128 row + col)."""

    t = np.arange(128)[:, None, None]
    j = np.arange(16)[None, :, None]
    h = np.arange(2)[None, None, :]
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * h
    col = 8 * j + 2 * (t % 4)
    return md_swizzle(128 * row + col, 128)


def tma_epilogue(acc64, requant):
    """A consumer's m64 x 128 accumulators through the TMA-store epilogue:
    the registers (wgmma's layout), requantized, written to the swizzled
    staging, then read by the TMA store's box ([64 rows x 128 bytes],
    byte x of row r at md_swizzle<128>(128 r + x)): the [64, 128] int8
    values stored."""

    regs_r, regs_c = accumulator_coords(128)
    vals = requant_np(acc64[regs_r, regs_c], requant).reshape(128, 16, 2, 2)
    off = tma_staging_offsets()
    stg = np.full(64 * 128, 99, np.int64)
    stg[off] = vals[..., 0]
    stg[off + 1] = vals[..., 1]
    r = np.arange(64)[:, None]
    return stg[md_swizzle(128 * r + np.arange(128), 128)]


def emulate_gemm(a, b, tiling, requant=None, raw=0x230):
    """Every block of the kernel, emulated: the [M, N] output (int32 as
    int64, or the requantized int8 values). The block's L-th load fills
    ring slot L % stages; consumer i % 2 computes the block's tile i, two
    m64 blocks of 128 columns, and stores them through TMA where the
    output's rows allow (tma_store), else element by element."""

    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk, kp = gemm_int8.BM, gemm_int8.BN, BK, tiling.kp
    ap = np.zeros((m, kp), np.int8)
    ap[:, :k] = a
    bt = np.zeros((n, kp), np.int8)
    bt[:, :k] = b.T
    stages = RING_STAGES
    a_stage, b_stage = bm * bk, bn * bk
    base = (raw + 1023) & ~1023
    nk = -(-kp // bk)
    out = np.full((m, n), -(1 << 42), np.int64)
    for block in range(tiling.grid):
        smem = np.zeros(base + stages * (a_stage + b_stage), np.int8)
        for i, (m0, n0) in enumerate(block_tiles(tiling, block)):
            acc = np.zeros((bm, bn), np.int64)
            for kb in range(nk):
                slot = (i * nk + kb) % stages
                a0 = base + slot * a_stage
                b0 = base + stages * a_stage + slot * b_stage
                count = tma_box(smem, a0, ap, m0, kb * bk, bm)
                count += tma_box(smem, b0, bt, n0, kb * bk, bn)
                # the two boxes fill the slot, each byte once
                assert (count[a0:a0 + a_stage] == 1).all()
                assert (count[b0:b0 + b_stage] == 1).all()
                assert count.sum() == a_stage + b_stage
                k0 = kb * bk
                want_b = np.zeros((bn, bk), np.int8)
                part = bt[n0:n0 + bn, k0:k0 + bk]
                want_b[:part.shape[0], :part.shape[1]] = part
                got_b = np.concatenate([
                    wgmma_read(smem, md_smem_desc(b0, 128) + 2 * kk, bn)
                    for kk in range(4)], 1)
                assert np.array_equal(got_b, want_b)
                for mi in range(2):
                    desc = md_smem_desc(a0 + 64 * mi * bk, 128)
                    got_a = np.concatenate([
                        wgmma_read(smem, desc + 2 * kk, 64)
                        for kk in range(4)], 1)
                    want_a = np.zeros((64, bk), np.int8)
                    part = ap[m0 + 64 * mi:m0 + 64 * mi + 64, k0:k0 + bk]
                    want_a[:part.shape[0], :part.shape[1]] = part
                    assert np.array_equal(got_a, want_a)
                    acc[64 * mi:64 * mi + 64] += got_a.astype(np.int64) @ \
                        got_b.astype(np.int64).T
            for mi in range(2):
                block = acc[64 * mi:64 * mi + 64]
                if tma_store(n, requant is not None):
                    vals = tma_epilogue(block, requant)
                else:
                    vals = epilogue(block, bn)
                    if requant is not None:
                        vals = requant_np(vals, requant)
                rows = min(64, m - (m0 + 64 * mi))
                cols = min(bn, n - n0)
                if rows > 0 and cols > 0:
                    out[m0 + 64 * mi:m0 + 64 * mi + rows, n0:n0 + cols] = \
                        vals[:rows, :cols]
    return out


def requant_np(acc, scale):
    """store4's int8: clamp(rint(f32(acc) * f32(scale)), -127, 127)."""

    y = acc.astype(np.float32) * np.float32(scale)
    return np.clip(np.rint(y), -127, 127).astype(np.int64)


EMULATED = [
    # M, N and K tails; N below one tile; K a multiple of 16 but not 128;
    # K over the ring (9 stages: loads wrap the 6 slots within a tile);
    # N % 4 != 0, N % 16 != 0 (element stores of both types), N % 16 == 0
    # (TMA stores of the int8 output)
    (300, 200, 300), (37, 29, 45), (130, 66, 65), (129, 257, 16),
    (65, 130, 272), (200, 140, 128), (260, 130, 1152), (70, 144, 200),
    (150, 256, 64),
]


@pytest.mark.parametrize('m,n,k', EMULATED)
def test_emulated_kernel_gives_the_product(m, n, k):
    """Every block through the ring, the descriptors, the register layout
    and the staged epilogue gives the plain int32 product and the fused
    requant (gemm_int8_reference), at a grid of two blocks (each with
    tiles for both consumers)."""

    rng = np.random.RandomState(m + n + k)
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    b = rng.randint(-128, 128, (k, n)).astype(np.int8)
    tiling = gemm_int8.gemm_tiling(m, k, n)._replace(grid=2)
    for requant in (None, 3e-4):
        got = emulate_gemm(a, b, tiling, requant)
        ref = gemm_int8.gemm_int8_reference(torch.from_numpy(a),
                                            torch.from_numpy(b), requant)
        assert np.array_equal(got, ref.numpy().astype(np.int64))


#%% The ring's mbarriers over a persistent walk


class MBarrier:
    """An mbarrier: [count] arrivals (and the expected transaction bytes)
    complete a phase; try_wait.parity(p) passes once the phase of parity p
    has completed, i.e. while the current phase's parity differs."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, expect_tx=0):
        self.pending -= 1
        self.tx += expect_tx
        self._complete()

    def land(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        assert self.pending >= 0
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passes(self, parity):
        return (self.phase & 1) != parity


def run_ring(nk, n_tiles, seed, order=True):
    """The producer and the two consumer warpgroups of one block over its
    persistent walk of [n_tiles] tiles of [nk] stages, interleaved at
    random, TMA bytes landing in issue order. With [order], consumer c
    starts tile i > 0 only once the other has issued tile i - 1's MMAs
    (the kernel's named barriers). Returns the loads a consumer read from
    a slot that held other data; raises on a deadlock or on a slot
    refilled while its consumer still reads it."""

    rng = np.random.RandomState(seed)
    stages = RING_STAGES
    full = [MBarrier(1) for _ in range(stages)]
    empty = [MBarrier(4) for _ in range(stages)]
    slot_data = [None] * stages
    in_flight = []  # (slot, load) issued, not landed
    holders = [None] * stages  # the consumer reading a slot
    issued = [False] * n_tiles
    stale = []
    nbytes = (gemm_int8.BM + gemm_int8.BN) * BK

    def producer():
        for load in range(nk * n_tiles):
            s, parity = load % stages, (load // stages) & 1
            while not empty[s].passes(parity ^ 1):
                yield
            full[s].arrive(expect_tx=nbytes)
            in_flight.append((s, load))
            yield

    def release(s):
        holders[s] = None
        for _ in range(4):  # lane 0 of each warp
            empty[s].arrive()

    def consumer(c):
        for i in range(c, n_tiles, 2):
            while order and i > 0 and not issued[i - 1]:
                yield
            prev = None
            for kb in range(nk):
                load = i * nk + kb
                s, parity = load % stages, (load // stages) & 1
                while not full[s].passes(parity):
                    yield
                if slot_data[s] != load:
                    stale.append(load)
                holders[s] = c
                yield  # wgmma, commit, wait_group 1
                if kb:
                    release(prev)
                prev = s
            issued[i] = True
            yield  # wait_group 0
            release(prev)
            yield  # the epilogue

    actors = [producer(), consumer(0), consumer(1)]
    done = [False] * len(actors)
    steps = 0
    while not all(done):
        steps += 1
        assert steps < 100000, 'deadlock'
        if in_flight and rng.rand() < 0.3:
            s, load = in_flight.pop(0)
            assert holders[s] is None  # no consumer still reads the slot
            slot_data[s] = load  # the TMA bytes land
            full[s].land(nbytes)
            continue
        j = rng.randint(len(actors))
        if not done[j]:
            try:
                next(actors[j])
            except StopIteration:
                done[j] = True
    loads = nk * n_tiles
    assert all(e.phase == loads // stages + (1 if s < loads % stages else 0)
               for s, e in enumerate(empty))
    return stale


@pytest.mark.parametrize('nk', [1, 2, 5, 9, 18])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_ring_phases_carry_across_tiles(nk, seed):
    """With the order barrier, every stage a consumer reads holds the load
    it waited for, over a walk of seven tiles: the phase bits carry across
    tiles and across the consumers' turns, and no slot is refilled early."""

    assert run_ring(nk, 7, seed) == []


def test_ring_without_the_order_barrier_goes_wrong():
    """Without it, consumer 1's first wait (E5: 9 stages a tile, so load 9
    in slot 3 with parity 1) can pass on the slot's fresh barrier before
    load 3 has landed, and the ring then reads stale stages or deadlocks:
    the barrier is what makes the parity waits safe."""

    wrong = 0
    for seed in range(10):
        try:
            wrong += bool(run_ring(9, 4, seed, order=False))
        except AssertionError:
            wrong += 1
    assert wrong


#%% Bank checks


def test_staging_stores_hit_distinct_banks():
    """Each half-warp's 8-byte accumulator stores into a [64][40] staging
    tile cover 32 distinct banks."""

    words = staging_store_words()
    for half in range(8):
        lanes = slice(16 * half, 16 * half + 16)
        for jj in range(4):
            for h in range(2):
                w = words[lanes, jj, h, :]
                assert len(set((w % 32).ravel())) == 32


def test_tma_staging_stores():
    """The TMA-store epilogue's 2-byte staging writes cover each byte of
    the box once, and a warp's hit distinct banks (lanes sharing a word
    write its halves)."""

    off = tma_staging_offsets()
    covered = (off[..., None] + np.arange(2)).ravel()
    assert np.array_equal(np.sort(covered), np.arange(64 * 128))
    for j in range(16):
        for h in range(2):
            for warp in range(4):
                words = set(off[32 * warp:32 * warp + 32, j, h] // 4)
                banks = [w % 32 for w in words]
                assert len(banks) == len(set(banks))


def test_readback_and_transpose_hit_distinct_banks():
    """Each quarter-warp's 16-byte staging reads cover 32 distinct banks;
    the transpose's column reads of its [64][68] byte tile put a warp's 32
    lanes on 32 distinct banks."""

    _, starts = readback_words()
    for q in range(16):
        for p in range(4):
            w = starts[8 * q:8 * q + 8, p][:, None] + np.arange(4)
            assert len(set((w % 32).ravel())) == 32
    for r in range(64):
        for c0 in (0, 32):
            banks = ((np.arange(c0, c0 + 32) * 68 + r) // 4) % 32
            assert len(set(banks)) == 32
