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
  forward's bits are the no-grad call's, and out= is refused.
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
