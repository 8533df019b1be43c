"""
The backward of the port's bf16 conv epilogue (ops/silu_bf16.py
silu_bf16_backward_reference, the plain version of the E7 backward kernel
in csrc/silu_bf16.cu) against jax.vjp of the JAX bf16 chain y = x + b;
y * jax.nn.sigmoid(y), with b a float32 parameter cast to bf16, as
megadetector_tpu/models/yolov5.py _conv computes it with dtype bf16:

- dx over all 65,536 bf16 bit patterns of x, for three seeded g and bias
  draws: bit-identical (NaN where JAX has NaN) except at the elements
  where an intermediate of the chain is subnormal (below 2^-126): XLA on
  the CPU flushes those to zero, the port (and the kernel) keep them.
  There the test's flush-to-zero copy of the chain gives JAX's bits; the
  count of such elements is asserted;
- db (the float32 bias gradient) on finite inputs: the port sums dx in
  float32 and rounds once to bf16. XLA on the CPU evaluates the bf16
  reduce_sum of the VJP one element after another (N, H, W in order),
  rounding each addition to bf16 (the test's sequential copy gives its
  bits exactly), which drops every term below 2^-9 of the running sum; a
  parallel kernel cannot follow that order. The bar: the port's db equals
  bf16(float32 sum of JAX's own dx), and is no further from the exact
  (float64) sum of dx than JAX's db is, plus one bf16 step;
- silu_bf16 under autograd: its gradients are the plain backward's, the
  forward's bits are the no-grad call's, and out= is refused;
- the kernel's (s, i) table (sigmoid_grad_table_reference and the
  kernel's lookup, sigmoid_grad_lookup_reference) over all 65,536 bf16
  y: the plain chain's bits, and jax.nn.sigmoid's under the subnormal
  rule above; dx through the table equal to the plain dx;
- the kernel's db order: silu_bf16_backward_bias_sum_ordered equal to a
  thread-by-thread walk of the kernels' loops (csrc/silu_bf16.cu: the
  rows kernel, the planes kernel, the bias pass) at small shapes, and
  held to JAX's db by the bars above (NCHW, channels_last, C of 24, 80
  and 1536 at H = W = 1); backward_plan's grids within the card's
  limits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megadetector_tpu_torch.ops import silu_bf16

TINY = 2.0 ** -126


def _jax_vjp(x_nchw, bias, g_nchw):
    """(dx NCHW bf16 as a torch tensor, db float32 numpy) from jax.vjp of
    the JAX package's bf16 activation with a float32 bias."""

    def f(x, b):
        y = x + b.astype(jnp.bfloat16)
        return y * jax.nn.sigmoid(y)

    x = jnp.asarray(x_nchw.float().permute(0, 2, 3, 1).numpy()).astype(
        jnp.bfloat16)
    g = jnp.asarray(g_nchw.float().permute(0, 2, 3, 1).numpy()).astype(
        jnp.bfloat16)
    b = jnp.asarray(bias.float().numpy())
    _, vjp = jax.vjp(f, x, b)
    dx, db = jax.jit(vjp)(g)
    dx = torch.from_numpy(np.array(dx.astype(jnp.float32))).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    return dx, np.asarray(db)


def _all_bf16(shape):
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    return torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).reshape(shape)


def _draw(rng, shape, scale):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            torch.bfloat16)


def _ftz(t):
    return torch.where(t.float().abs() < TINY, torch.zeros_like(t), t)


def _subnormal(t):
    a = t.float().abs()
    return (a > 0) & (a < TINY)


def _dx_with_flush(g, x, bias):
    """(the plain chain with every intermediate flushed to zero below
    2^-126, as XLA on the CPU computes it; elements where an intermediate
    of the plain chain is subnormal)."""

    y = x if bias is None else x + silu_bf16._channel_view(bias, x)
    d = 1 + torch.exp(-y)
    s = torch.reciprocal(d)
    h = 1 - s
    i = s * h
    k = g * s
    j = y * g
    l = j * i
    sub = _subnormal(y)
    for t in (torch.exp(-y), d, s, h, i, k, j, l, k + l):
        sub |= _subnormal(t)
    y = _ftz(y)
    e = _ftz(torch.exp(-y))
    s = _ftz(torch.reciprocal(_ftz(1 + e)))
    i = _ftz(s * _ftz(1 - s))
    dx = _ftz(_ftz(g * s) + _ftz(_ftz(y * g) * i))
    return dx, sub


def _check_dx(g, x, bias, ours, ref):
    """Bit-identical outside the flushed elements; there the flushed chain
    gives JAX's bits. Returns how many elements differ."""

    flushed, sub = _dx_with_flush(g, x, bias)
    nan = torch.isnan(ref.float())
    assert torch.equal(torch.isnan(ours.float()), nan)
    assert torch.equal(torch.isnan(flushed.float()), nan)
    same = ours.view(torch.int16) == ref.view(torch.int16)
    assert bool(same[~nan & ~sub].all()), int((~same[~nan & ~sub]).sum())
    ftz_same = (flushed.view(torch.int16) == ref.view(torch.int16)) | \
        (flushed.float() == ref.float())
    assert bool(ftz_same[~nan].all())
    return int((~same & ~nan).sum())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_dx_exhaustive_vs_jax_vjp(seed):
    shape = (4, 16, 32, 32)
    x = _all_bf16(shape)
    rng = np.random.RandomState(seed)
    g = _draw(rng, shape, 1.0)
    bias = _draw(rng, (16,), 0.5)
    ref_dx, _ = _jax_vjp(x, bias, g)
    dx, db = silu_bf16.silu_bf16_backward_reference(g, x, bias)
    assert dx.dtype == torch.bfloat16 and db.dtype == torch.bfloat16
    n_flushed = _check_dx(g, x, bias, dx, ref_dx)
    # measured: 1-3 of the 65,536
    assert n_flushed <= 16, n_flushed


def _bf16_step(v):
    """The spacing of bf16 values at |v| (2^-133 at least)."""

    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize('layout', ['nchw', 'channels_last'])
@pytest.mark.parametrize('shape', [(2, 24, 9, 11), (3, 40, 1, 1),
                                   (1, 8, 16, 16), (4, 16, 32, 32)])
def test_db_and_dx_on_finite_inputs_against_jax(shape, layout):
    rng = np.random.RandomState(sum(shape))
    x = _draw(rng, shape, 3.0)
    g = _draw(rng, shape, 1.0)
    bias = _draw(rng, (shape[1],), 0.5)
    ref_dx, ref_db = _jax_vjp(x, bias, g)
    if layout == 'channels_last':
        x = x.contiguous(memory_format=torch.channels_last)
    dx, db = silu_bf16.silu_bf16_backward_reference(g, x, bias)
    assert _check_dx(g, x, bias, dx, ref_dx) == 0
    assert torch.equal(db, ref_dx.float().sum((0, 2, 3)).to(torch.bfloat16))
    exact = dx.double().sum((0, 2, 3)).numpy()
    ours = db.float().numpy()
    assert np.all(np.abs(ours - exact) <=
                  np.abs(ref_db - exact) + _bf16_step(exact))
    # JAX's bits: a sequential bf16 sum over N, H, W
    acc = torch.zeros(shape[1], dtype=torch.bfloat16)
    for row in ref_dx.permute(0, 2, 3, 1).reshape(-1, shape[1]):
        acc = (acc.float() + row.float()).to(torch.bfloat16)
    np.testing.assert_array_equal(acc.float().numpy(), ref_db)


def test_without_bias_matches_jax_vjp():
    x = _all_bf16((512, 128))
    g = _draw(np.random.RandomState(5), (512, 128), 1.0)
    dx, db = silu_bf16.silu_bf16_backward_reference(g, x)
    assert db is None

    def f(v):
        return v * jax.nn.sigmoid(v)

    _, vjp = jax.vjp(f, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    (ref,) = jax.jit(vjp)(jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(
        torch.bfloat16)
    assert _check_dx(g, x, None, dx, ref) <= 16


def test_autograd_function_uses_the_backward():
    rng = np.random.RandomState(7)
    shape = (2, 16, 6, 5)
    x = _draw(rng, shape, 2.0).requires_grad_(True)
    master = torch.from_numpy(
        rng.standard_normal(16).astype(np.float32)).requires_grad_(True)
    bias = master.to(torch.bfloat16)
    g = _draw(rng, shape, 1.0)
    out = silu_bf16.silu_bf16(x, bias)
    with torch.no_grad():
        plain = silu_bf16.silu_bf16(x.detach(), bias.detach())
    assert out.requires_grad
    assert torch.equal(out.detach().view(torch.int16),
                       plain.view(torch.int16))
    dx, dmaster = torch.autograd.grad(out, (x, master), g)
    ref_dx, ref_db = silu_bf16.silu_bf16_backward_reference(
        g, x.detach(), bias.detach())
    assert torch.equal(dx.view(torch.int16), ref_dx.view(torch.int16))
    assert dmaster.dtype == torch.float32
    assert torch.equal(dmaster, ref_db.float())
    with pytest.raises(ValueError, match='out='):
        silu_bf16.silu_bf16(x, bias, out=torch.empty_like(plain))


def test_no_grad_call_is_unchanged():
    """Without grad the call is the plain forward: no autograd record."""

    x = _draw(np.random.RandomState(8), (2, 8, 4, 4), 2.0)
    bias = torch.zeros(8, dtype=torch.bfloat16, requires_grad=True)
    with torch.no_grad():
        y = silu_bf16.silu_bf16(x, bias)
    assert not y.requires_grad and y.grad_fn is None
    assert torch.equal(y.view(torch.int16), silu_bf16.silu_bf16_reference(
        x, bias.detach()).view(torch.int16))


def _bits(t):
    return t.contiguous().view(torch.int16)


def test_sigmoid_grad_table_exhaustive_vs_jax():
    """The table's (s, i) for every bf16 y: the plain chain's bits (NaN y
    reads an outside entry: see test_table_dx_equals_plain_dx), and
    JAX's sigmoid and s * (1 - s) in bf16 outside the elements where an
    intermediate is subnormal (XLA on the CPU flushes those; the flushed
    chain gives JAX's bits there)."""

    y = _all_bf16((65536,))
    table = silu_bf16.sigmoid_grad_table_reference()
    assert table.shape == (2 * silu_bf16.SIGMOID_TABLE_HALF,) == (3844,)
    s, i = silu_bf16.sigmoid_grad_lookup_reference(y, table)
    ref_s = silu_bf16.sigmoid_bf16_reference(y)
    ref_i = ref_s * (1 - ref_s)
    nan = torch.isnan(y.float())
    assert int(nan.sum()) == 254
    assert torch.equal(_bits(s)[~nan], _bits(ref_s)[~nan])
    assert torch.equal(_bits(i)[~nan], _bits(ref_i)[~nan])
    # every |y| < 2^-8 is (0.5, 0.25), y >= 128 (1, 0), y <= -128 (0, 0)
    a = y.float().abs()
    assert bool((s[a < 2.0 ** -8].float() == 0.5).all())
    assert bool((i[a < 2.0 ** -8].float() == 0.25).all())
    assert bool((s[y.float() >= 128].float() == 1).all())
    assert bool((s[y.float() <= -128].float() == 0).all())
    assert bool((i[a >= 128].float() == 0).all())

    yj = jnp.asarray(y.float().numpy()).astype(jnp.bfloat16)
    sj = jax.nn.sigmoid(yj)
    ij = sj * (1 - sj)
    sj = torch.from_numpy(np.array(sj.astype(jnp.float32))).to(
        torch.bfloat16)
    ij = torch.from_numpy(np.array(ij.astype(jnp.float32))).to(
        torch.bfloat16)
    e = torch.exp(-y)
    d = 1 + e
    sub = _subnormal(y) | _subnormal(e) | _subnormal(d) | \
        _subnormal(ref_s) | _subnormal(1 - ref_s) | _subnormal(ref_i)
    keep = ~nan & ~sub
    assert torch.equal(_bits(s)[keep], _bits(sj)[keep])
    assert torch.equal(_bits(i)[keep], _bits(ij)[keep])
    fs = _ftz(torch.reciprocal(_ftz(1 + _ftz(torch.exp(-_ftz(y))))))
    fi = _ftz(fs * _ftz(1 - fs))
    assert bool(((fs.float() == sj.float()) | (_bits(fs) == _bits(sj)))[
        ~nan].all())
    assert bool(((fi.float() == ij.float()) | (_bits(fi) == _bits(ij)))[
        ~nan].all())
    # measured: the subnormal y (254) and y where s underflows
    assert int((sub & ~nan).sum()) <= 600


@pytest.mark.parametrize('with_bias', [True, False])
def test_table_dx_equals_plain_dx(with_bias):
    """dx from the table's (s, i), rounded where the kernel rounds, equals
    the plain chain's dx over all 65,536 bf16 x (NaN where it is NaN)."""

    shape = (4, 16, 32, 32)
    x = _all_bf16(shape)
    rng = np.random.RandomState(11)
    g = _draw(rng, shape, 1.0)
    bias = _draw(rng, (16,), 0.5) if with_bias else None
    y = x if bias is None else x + silu_bf16._channel_view(bias, x)
    s, i = silu_bf16.sigmoid_grad_lookup_reference(
        y, silu_bf16.sigmoid_grad_table_reference())
    dx = g * s + (y * g) * i
    ref, _ = silu_bf16.silu_bf16_backward_reference(g, x, bias)
    nan = torch.isnan(ref.float())
    assert torch.equal(torch.isnan(dx.float()), nan)
    assert torch.equal(_bits(dx)[~nan], _bits(ref)[~nan])


def _walk_rows(d, plan):
    """partials [blocks, c] of the rows kernel, thread by thread: d
    float32 [rows, c]."""

    rows, c = d.shape
    width, cols, lanes = plan.width, plan.cols, plan.lanes
    units = c // width
    stride = plan.blocks * lanes
    partials = np.zeros((plan.blocks, c), np.float32)
    for bx in range(plan.blocks):
        for by in range(-(-units // cols)):
            for col in range(cols):
                unit = by * cols + col
                if unit >= units:
                    continue
                chans = slice(unit * width, (unit + 1) * width)
                red = []
                for lane in range(lanes):
                    total = np.zeros(width, np.float32)
                    r = bx * lanes + lane
                    while r < rows:
                        total = total + d[r, chans]
                        r += stride
                    red.append(total)
                s = 1
                while s < lanes:
                    s <<= 1
                s >>= 1
                while s > 0:
                    for lane in range(min(s, lanes - s)):
                        red[lane] = red[lane] + red[lane + s]
                    s >>= 1
                partials[bx, chans] = red[0]
    return partials


def _walk_planes(d, plan):
    """partials [N * segs, c] of the planes kernel, thread by thread: d
    float32 [N, c, inner]."""

    n_img, c, inner = d.shape
    width, segs = plan.width, plan.segs
    threads, steps = silu_bf16.BACKWARD_THREADS, \
        silu_bf16.BACKWARD_TILE_STEPS
    plane_units = inner // width
    partials = np.zeros((n_img * segs, c), np.float32)
    for p in range(n_img * c):
        plane = d[p // c, p % c]
        for seg in range(segs):
            begin = seg * threads * steps
            end = min(plane_units, begin + threads * steps)
            sums = np.zeros(threads, np.float32)
            for t in range(threads):
                total = np.float32(0)
                for j in range(steps):
                    u = begin + t + j * threads
                    if u < end:
                        for k in range(width):
                            total = np.float32(total + plane[u * width + k])
                sums[t] = total
            v = sums.reshape(threads // 32, 32).copy()
            for s in (16, 8, 4, 2, 1):
                v[:, :s] = v[:, :s] + v[:, s:2 * s]
            w = v[:, 0].copy()
            for s in (4, 2, 1):
                w[:s] = w[:s] + w[s:2 * s]
            partials[(p // c) * segs + seg, p % c] = w[0]
    return partials


def _walk_bias_pass(partials):
    """db [c] of the bias pass before its rounding (float32), slice by
    slice."""

    rows, c = partials.shape
    slices = silu_bf16.BACKWARD_BIAS_SLICES
    db = np.zeros(c, np.float32)
    for ch in range(c):
        red = np.zeros(slices, np.float32)
        for sl in range(slices):
            total = np.float32(0)
            for r in range(sl, rows, slices):
                total = np.float32(total + partials[r, ch])
            red[sl] = total
        s = slices // 2
        while s > 0:
            red[:s] = red[:s] + red[s:2 * s]
            s >>= 1
        db[ch] = red[0]
    return torch.from_numpy(db)


@pytest.mark.parametrize('shape,layout,aligned,kind,width', [
    ((2, 256, 10, 10), 'channels_last', True, 'rows', 8),
    ((1, 24, 30, 30), 'channels_last', True, 'rows', 8),
    ((1, 520, 4, 5), 'channels_last', True, 'rows', 8),
    ((1, 40, 12, 12), 'channels_last', False, 'rows', 1),
    ((5, 24, 1, 1), 'nchw', True, 'rows', 8),
    ((1, 2, 96, 96), 'nchw', True, 'planes', 8),
    ((2, 3, 7, 9), 'nchw', True, 'planes', 1)])
def test_ordered_sum_follows_the_kernel_loops(shape, layout, aligned, kind,
                                              width):
    """silu_bf16_backward_bias_sum_ordered, bit for bit, against a walk of
    the kernels' own loops: several blocks, lanes not a power of two
    (C = 24: 85 lanes), a partly filled column tile (C = 520), one
    channel a thread, two tiles a plane, one element a unit."""

    rng = np.random.RandomState(sum(shape))
    # exponents spread over 2^-20 .. 2^20, so that float32 sums round and
    # their order shows in the bits
    dx = torch.from_numpy((rng.standard_normal(shape) * 2.0 ** rng.randint(
        -20, 21, shape)).astype(np.float32)).to(torch.bfloat16)
    if layout == 'channels_last':
        dx = dx.contiguous(memory_format=torch.channels_last)
    c, inner = silu_bf16._layout(dx)
    plan = silu_bf16.backward_plan(dx.numel(), c, inner, True, aligned)
    assert (plan.kind, plan.width) == (kind, width)
    d = dx.float()
    if kind == 'rows':
        partials = _walk_rows(d.permute(0, 2, 3, 1).reshape(-1, c).numpy(),
                              plan)
        assert plan.blocks > 1 or shape[1] in (520, 24)
    else:
        partials = _walk_planes(d.reshape(shape[0], c, inner).numpy(), plan)
    assert partials.shape == (plan.partial_rows, c)
    want = _walk_bias_pass(partials)
    got = silu_bf16._bias_sum_ordered_f32(dx, aligned)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(
        _bits(silu_bf16.silu_bf16_backward_bias_sum_ordered(dx, aligned)),
        _bits(want.to(torch.bfloat16)))
    # the order shows: float32 sums in another order give other bits
    assert not torch.equal(got.view(torch.int32),
                           d.sum((0, 2, 3)).view(torch.int32))


@pytest.mark.parametrize('layout', ['nchw', 'channels_last'])
@pytest.mark.parametrize('shape', [(2, 24, 9, 11), (4, 16, 32, 32),
                                   (2, 40, 20, 20), (64, 24, 1, 1),
                                   (64, 80, 1, 1), (64, 1536, 1, 1)])
def test_ordered_bias_sum_against_jax(shape, layout):
    """The kernel's db (its order, from the plain dx, which is JAX's) held
    to JAX's VJP: within one bf16 step of bf16(float32 sum of JAX's dx),
    and no further from the exact (float64) sum than JAX's db plus one
    step. Both 16-byte paths (aligned and not)."""

    rng = np.random.RandomState(sum(shape) + 1)
    x = _draw(rng, shape, 3.0)
    g = _draw(rng, shape, 1.0)
    bias = _draw(rng, (shape[1],), 0.5)
    ref_dx, ref_db = _jax_vjp(x, bias, g)
    if layout == 'channels_last':
        x = x.contiguous(memory_format=torch.channels_last)
        g = g.contiguous(memory_format=torch.channels_last)
    dx, _ = silu_bf16.silu_bf16_backward_reference(g, x, bias)
    assert _check_dx(g, x, bias, dx, ref_dx) == 0
    f32 = ref_dx.float().sum((0, 2, 3)).to(torch.bfloat16).float().numpy()
    exact = dx.double().sum((0, 2, 3)).numpy()
    for aligned in (True, False):
        ours = silu_bf16.silu_bf16_backward_bias_sum_ordered(
            dx, aligned=aligned).float().numpy()
        assert np.all(np.abs(ours - f32) <= _bf16_step(f32))
        assert np.all(np.abs(ours - exact) <=
                      np.abs(ref_db - exact) + _bf16_step(exact))


def test_backward_plan_within_the_card_limits():
    """Every plan's block fits 256 threads, its grid the card's limits and
    BACKWARD_BLOCKS resident blocks, and every row / tile is some block's,
    across the layouts, widths and the channel limit."""

    cases = [(8 * 128 * 240 * 320, 128, 1), (64 * 1536 * 49, 1536, 1),
             (64 * 16, 16, 1), (8 * 1024 * 400, 1024, 1),
             (4 * 96 * 391, 96, 391), (8 * 128 * 76800, 128, 76800),
             (silu_bf16.MAX_BACKWARD_CHANNELS * 3,
              silu_bf16.MAX_BACKWARD_CHANNELS, 1)]
    for n, c, inner in cases:
        for has_bias in (True, False):
            for aligned in (True, False):
                plan = silu_bf16.backward_plan(n, c, inner, has_bias,
                                               aligned)
                assert plan.blocks >= 1
                if plan.kind == 'rows':
                    units = c // plan.width
                    col_tiles = -(-units // plan.cols)
                    assert plan.cols * plan.lanes <= 256
                    assert col_tiles <= 65535
                    assert plan.blocks * col_tiles <= max(
                        silu_bf16.BACKWARD_BLOCKS, col_tiles)
                    assert plan.partial_rows == plan.blocks
                else:
                    plane = inner if has_bias else n
                    tile = silu_bf16.BACKWARD_TILE_STEPS * 256
                    assert plan.segs * tile >= plane // plan.width
                    assert plan.blocks <= silu_bf16.BACKWARD_BLOCKS
                    assert plan.partial_rows == (
                        n // plane // c * plan.segs if has_bias else 0)
