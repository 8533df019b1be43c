"""
The int8 experiments' kernels in the port (ops/conv_int8.py
conv3x3_int8_exp for E1-E4, ops/gemm_int8.py gemm_int8 for E5-E6) on the
CPU, against the JAX Pallas kernels they replace, run in interpret mode.

The experiment scripts (experiments/exp_pallas_conv3x3*.py,
exp_pallas_int8_chain.py, exp_pallas_int8_matmul.py) arm an os._exit
watchdog and run their probes when imported, so their kernel bodies and
pallas_call wrappers are restated here, line for line (the file:line of
each is named). Inputs are seeded numpy, as the experiments draw them:
int8 in [-127, 127], scale U(1e-4, 4e-4), bias U(-0.5, 0.5), at the
originals' check shapes. At those scales almost every output saturates
(|acc * scale| is ~45), so each conv case also runs at 'spread' scales,
U(1e-6, 4e-6), where the outputs cover the int8 range.

Bars (ROADMAP C):
- int32 accumulators and the GEMMs: identical.
- bf16: identical. XLA rounds to bf16 after the s32 -> f32 -> bf16
  convert, *, +, exp, 1 + and 1 /, but not after the last *: the body
  converts that product to f32 at once, and XLA removes the f32 -> bf16
  -> f32 pair. The port rounds at the same points.
- f32, f32_nosilu and hybrid: int8 within 1 lsb on at most 1e-4 of
  elements. XLA on the CPU contracts the f32 `acc * scale + bias` into one
  FMA (one rounding; 3,160 of 12,288 wide-range values differ by an ulp
  from two roundings), which the port does not copy (the chain's affine,
  B2's and the kernel's, rounds twice); and torch's and XLA's f32
  sigmoids differ by an ulp. Either can cross a requant boundary. The
  measured counts are smaller: see ROADMAP C.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from megadetector_tpu_torch.ops import conv_int8, gemm_int8

RATIO = 0.8531
Y_SCALE = 0.043
SCALES = {'original': (1e-4, 4e-4), 'spread': (1e-6, 4e-6)}


# -------------------------------------------------- restated Pallas bodies

def _e1_kernel(top_ref, x_ref, bot_ref, w_ref, sc_ref, b_ref,
               o_ref, *, n_bands, in_ratio, inv_y):
    # experiments/exp_pallas_conv3x3.py:70-102
    i = pl.program_id(1)
    bh, w, c = x_ref.shape[1:]
    cout = o_ref.shape[-1]
    top = jnp.where(i == 0, jnp.zeros_like(top_ref[0]), top_ref[0])
    bot = jnp.where(i == n_bands - 1, jnp.zeros_like(bot_ref[0]),
                    bot_ref[0])
    x = jnp.concatenate([top, x_ref[0], bot], axis=0)
    if in_ratio != 1.0:
        x = jnp.clip(
            jnp.round(x.astype(jnp.float32) * np.float32(in_ratio)),
            -127, 127).astype(jnp.int8)
    x = jnp.pad(x, ((0, 0), (1, 1), (0, 0)))
    acc = jnp.zeros((bh, w, cout), jnp.int32)
    for dy in range(3):
        for dx in range(3):
            xs = x[dy:dy + bh, dx:dx + w, :]
            acc = acc + jax.lax.dot_general(
                xs, w_ref[dy, dx], (((2,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * sc_ref[0].reshape(1, 1, cout) \
        + b_ref[0].reshape(1, 1, cout)
    y = y * jax.nn.sigmoid(y)
    o_ref[0] = jnp.clip(jnp.round(y * np.float32(inv_y)),
                        -127, 127).astype(jnp.int8)


def _e2_kernel(top_ref, x_ref, bot_ref, w_ref, sc_ref, b_ref,
               o_ref, *, n_bands, in_ratio, inv_y, mode, silu):
    # experiments/exp_pallas_conv3x3b.py:66-119
    i = pl.program_id(1)
    bh, w, c = x_ref.shape[1:]
    cout = o_ref.shape[-1]
    top = jnp.where(i == 0, jnp.zeros_like(top_ref[0]), top_ref[0])
    bot = jnp.where(i == n_bands - 1, jnp.zeros_like(bot_ref[0]),
                    bot_ref[0])
    x = jnp.concatenate([top, x_ref[0], bot], axis=0)
    if in_ratio != 1.0:
        x = jnp.clip(
            jnp.round(x.astype(jnp.float32) * np.float32(in_ratio)),
            -127, 127).astype(jnp.int8)
    x = jnp.pad(x, ((0, 0), (1, 1), (0, 0)))
    if mode == 'rank3':
        acc = jnp.zeros((bh, w, cout), jnp.int32)
        for dy in range(3):
            for dx in range(3):
                acc = acc + jax.lax.dot_general(
                    x[dy:dy + bh, dx:dx + w, :], w_ref[dy, dx],
                    (((2,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * sc_ref[0].reshape(1, 1, cout) \
            + b_ref[0].reshape(1, 1, cout)
    elif mode == 'flat':
        acc = jnp.zeros((bh * w, cout), jnp.int32)
        for dy in range(3):
            for dx in range(3):
                xs = x[dy:dy + bh, dx:dx + w, :].reshape(bh * w, c)
                acc = acc + jax.lax.dot_general(
                    xs, w_ref[dy, dx], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * sc_ref[0] + b_ref[0]
    else:  # im2col
        patches = jnp.concatenate(
            [x[dy:dy + bh, dx:dx + w, :].reshape(bh * w, c)
             for dy in range(3) for dx in range(3)], axis=1)
        acc = jax.lax.dot_general(
            patches, w_ref[:], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * sc_ref[0] + b_ref[0]
    if silu:
        y = y * jax.nn.sigmoid(y)
    out = jnp.clip(jnp.round(y * np.float32(inv_y)),
                   -127, 127).astype(jnp.int8)
    o_ref[0] = out.reshape(1, bh, w, cout)[0] if mode == 'rank3' \
        else out.reshape(bh, w, cout)


def _e3_kernel(top_ref, x_ref, bot_ref, w_ref, sc_ref, b_ref,
               o_ref, *, n_bands, in_ratio, inv_y, mode, ep_dtype):
    # experiments/exp_pallas_conv3x3c.py:64-107
    i = pl.program_id(1)
    bh, w, c = x_ref.shape[1:]
    cout = o_ref.shape[-1]
    top = jnp.where(i == 0, jnp.zeros_like(top_ref[0]), top_ref[0])
    bot = jnp.where(i == n_bands - 1, jnp.zeros_like(bot_ref[0]),
                    bot_ref[0])
    x = jnp.concatenate([top, x_ref[0], bot], axis=0)
    if in_ratio != 1.0:
        x = jnp.clip(
            jnp.round(x.astype(jnp.float32) * np.float32(in_ratio)),
            -127, 127).astype(jnp.int8)
    x = jnp.pad(x, ((0, 0), (1, 1), (0, 0)))
    if mode == 'flat':
        acc = jnp.zeros((bh * w, cout), jnp.int32)
        for dy in range(3):
            for dx in range(3):
                xs = x[dy:dy + bh, dx:dx + w, :].reshape(bh * w, c)
                acc = acc + jax.lax.dot_general(
                    xs, w_ref[dy, dx], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32)
    else:  # im2col
        patches = jnp.concatenate(
            [x[dy:dy + bh, dx:dx + w, :].reshape(bh * w, c)
             for dy in range(3) for dx in range(3)], axis=1)
        acc = jax.lax.dot_general(
            patches, w_ref[:], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
    y = acc.astype(ep_dtype) * sc_ref[0].astype(ep_dtype) \
        + b_ref[0].astype(ep_dtype)
    y = y * jax.nn.sigmoid(y)
    if ep_dtype != jnp.float32:
        y = y.astype(jnp.float32)
    out = jnp.clip(jnp.round(y * np.float32(inv_y)),
                   -127, 127).astype(jnp.int8)
    o_ref[0] = out.reshape(bh, w, cout)


def _e4_kernel(top_ref, x_ref, bot_ref, w_ref, sc_ref, b_ref, o_ref, *,
               n_bands, inv_y, epi):
    # experiments/exp_pallas_conv3x3d.py:60-97
    i = pl.program_id(1)
    bh, w, c = x_ref.shape[1:]
    cout = o_ref.shape[-1]
    top = jnp.where(i == 0, jnp.zeros_like(top_ref[0]), top_ref[0])
    bot = jnp.where(i == n_bands - 1, jnp.zeros_like(bot_ref[0]),
                    bot_ref[0])
    x = jnp.concatenate([top, x_ref[0], bot], axis=0)
    x = jnp.pad(x, ((0, 0), (1, 1), (0, 0)))
    acc = jnp.zeros((bh * w, cout), jnp.int32)
    for dy in range(3):
        for dx in range(3):
            xs = x[dy:dy + bh, dx:dx + w, :].reshape(bh * w, c)
            acc = acc + jax.lax.dot_general(
                xs, w_ref[dy, dx], (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
    if epi == 'f32':
        y = acc.astype(jnp.float32) * sc_ref[0] + b_ref[0]
        y = y * jax.nn.sigmoid(y)
    elif epi == 'bf16':
        sc = jnp.broadcast_to(sc_ref[:].astype(jnp.bfloat16),
                              (bh * w, cout))
        bb = jnp.broadcast_to(b_ref[:].astype(jnp.bfloat16),
                              (bh * w, cout))
        y = acc.astype(jnp.bfloat16) * sc + bb
        y = (y * jax.nn.sigmoid(y)).astype(jnp.float32)
    else:  # hybrid: f32 affine, bf16 sigmoid
        y = acc.astype(jnp.float32) * sc_ref[0] + b_ref[0]
        sig = jax.nn.sigmoid(y.astype(jnp.bfloat16)).astype(jnp.float32)
        y = y * sig
    out = jnp.clip(jnp.round(y * np.float32(inv_y)),
                   -127, 127).astype(jnp.int8)
    o_ref[0] = out.reshape(bh, w, cout)


def _banded_call(kern, x_q, w_arg, w_block, scale, bias, bh):
    """The pallas_call every conv experiment makes (exp_pallas_conv3x3.py
    :125-145 and its copies): grid (B, H / bh), 1-row halos above and
    below, interpret=True."""

    bsz, h, w, c = x_q.shape
    cout = scale.shape[0]
    w_index = (lambda b, i: (0, 0)) if len(w_block) == 2 else \
        (lambda b, i: (0, 0, 0, 0))
    return pl.pallas_call(
        kern,
        grid=(bsz, h // bh),
        in_specs=[
            pl.BlockSpec((1, 1, w, c),
                         lambda b, i: (b, jnp.maximum(i * bh - 1, 0), 0, 0)),
            pl.BlockSpec((1, bh, w, c), lambda b, i: (b, i, 0, 0)),
            pl.BlockSpec((1, 1, w, c),
                         lambda b, i: (b, jnp.minimum((i + 1) * bh, h - 1),
                                       0, 0)),
            pl.BlockSpec(w_block, w_index),
            pl.BlockSpec((1, cout), lambda b, i: (0, 0)),
            pl.BlockSpec((1, cout), lambda b, i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, bh, w, cout), lambda b, i: (b, i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bsz, h, w, cout), jnp.int8),
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=('parallel', 'arbitrary')),
        interpret=True,
    )(x_q, x_q, x_q, w_arg, scale.reshape(1, cout), bias.reshape(1, cout))


def e1_conv(x, w, scale, bias, in_ratio, y_scale, bh):
    # exp_pallas_conv3x3.py:105-145 pallas_conv3x3
    kern = functools.partial(_e1_kernel, n_bands=x.shape[1] // bh,
                             in_ratio=float(in_ratio),
                             inv_y=1.0 / float(y_scale))
    return _banded_call(kern, x, w, w.shape, scale, bias, bh)


def e2_conv(x, w, scale, bias, in_ratio, y_scale, bh, mode, silu):
    # exp_pallas_conv3x3b.py:122-161 pallas_conv3x3
    c, cout = w.shape[2], w.shape[3]
    if mode == 'im2col':
        w_arg = jnp.asarray(np.ascontiguousarray(
            np.asarray(w).reshape(9 * c, cout)))
    else:
        w_arg = w
    kern = functools.partial(_e2_kernel, n_bands=x.shape[1] // bh,
                             in_ratio=float(in_ratio),
                             inv_y=1.0 / float(y_scale), mode=mode, silu=silu)
    return _banded_call(kern, x, w_arg, w_arg.shape, scale, bias, bh)


def e3_conv(x, w, scale, bias, in_ratio, y_scale, bh, mode, ep_dtype):
    # exp_pallas_conv3x3c.py:110-150 pallas_conv3x3
    c, cout = w.shape[2], w.shape[3]
    w_arg = w.reshape(9 * c, cout) if mode == 'im2col' else w
    kern = functools.partial(_e3_kernel, n_bands=x.shape[1] // bh,
                             in_ratio=float(in_ratio),
                             inv_y=1.0 / float(y_scale), mode=mode,
                             ep_dtype=ep_dtype)
    return _banded_call(kern, x, w_arg, w_arg.shape, scale, bias, bh)


def e4_conv(x, w, scale, bias, bh, epi):
    # exp_pallas_conv3x3d.py:100-125 conv (Y_SCALE is the module's 0.043)
    kern = functools.partial(_e4_kernel, n_bands=x.shape[1] // bh,
                             inv_y=1.0 / Y_SCALE, epi=epi)
    return _banded_call(kern, x, w, w.shape, scale, bias, bh)


def _mm_kernel(a_ref, b_ref, o_ref):
    # exp_pallas_int8_chain.py:82-84 and exp_pallas_int8_matmul.py:73-75
    o_ref[:] = jnp.dot(a_ref[:], b_ref[:], preferred_element_type=jnp.int32)


def _mm_kernel_fused(a_ref, b_ref, o_ref):
    # exp_pallas_int8_chain.py:105-109
    y = jnp.dot(a_ref[:], b_ref[:], preferred_element_type=jnp.int32)
    o_ref[:] = jnp.clip(
        jnp.round(y.astype(jnp.float32) * np.float32(3e-4)),
        -127, 127).astype(jnp.int8)


def _mm_kernel_acc(a_ref, b_ref, o_ref, acc_ref, *, n_k):
    # exp_pallas_int8_matmul.py:97-107
    @pl.when(pl.program_id(2) == 0)
    def _init():
        acc_ref[:] = jnp.zeros_like(acc_ref)

    acc_ref[:] += jnp.dot(a_ref[:], b_ref[:],
                          preferred_element_type=jnp.int32)

    @pl.when(pl.program_id(2) == n_k - 1)
    def _done():
        o_ref[:] = acc_ref[:]


def mm_full_k(kernel, a, b, out_dtype, bm, bn):
    # exp_pallas_int8_chain.py:87-102 / :112-129, exp_pallas_int8_matmul.py
    # :78-94
    m, k = a.shape
    n = b.shape[1]
    return pl.pallas_call(
        kernel,
        grid=(m // bm, n // bn),
        in_specs=[pl.BlockSpec((bm, k), lambda i, j: (i, 0)),
                  pl.BlockSpec((k, bn), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((m, n), out_dtype),
        interpret=True,
    )(a, b)


def mm_kloop(a, b, bm, bn, bk):
    # exp_pallas_int8_matmul.py:110-128 pallas_mm_i8_kloop
    m, k = a.shape
    n = b.shape[1]
    n_k = k // bk
    return pl.pallas_call(
        functools.partial(_mm_kernel_acc, n_k=n_k),
        grid=(m // bm, n // bn, n_k),
        in_specs=[pl.BlockSpec((bm, bk), lambda i, j, kk: (i, kk)),
                  pl.BlockSpec((bk, bn), lambda i, j, kk: (kk, j))],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j, kk: (i, j)),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.int32),
        scratch_shapes=[pltpu.VMEM((bm, bn), jnp.int32)],
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=('parallel', 'parallel', 'arbitrary')),
        interpret=True,
    )(a, b)


# ----------------------------------------------------------------- helpers

def _conv_inputs(seed, b, h, w, c, cout, scales='original'):
    rng = np.random.RandomState(seed)
    lo, hi = SCALES[scales]
    return (rng.randint(-127, 128, (b, h, w, c)).astype(np.int8),
            rng.randint(-127, 128, (3, 3, c, cout)).astype(np.int8),
            rng.uniform(lo, hi, cout).astype(np.float32),
            rng.uniform(-0.5, 0.5, cout).astype(np.float32))


def _port_conv(x, w, scale, bias, in_ratio, y_scale, epilogue):
    return conv_int8.conv3x3_int8_exp(
        torch.from_numpy(x), conv_int8.prepare_weight(w),
        torch.from_numpy(scale), torch.from_numpy(bias), in_ratio, y_scale,
        epilogue).numpy()


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_int8(got, want, identical):
    """identical, or within 1 lsb on at most 1e-4 of elements (the f32
    sigmoid ulp); returns the number of elements that differ."""

    assert got.shape == want.shape and got.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    n_off = int((diff > 0).sum())
    if identical:
        assert n_off == 0, '{} of {} differ, max {}'.format(
            n_off, diff.size, diff.max())
    else:
        assert diff.max() <= 1 and n_off <= 1e-4 * diff.size, \
            '{} of {} differ, max {}'.format(n_off, diff.size, diff.max())
    return n_off


# ------------------------------------------------------------------- tests

E1_SHAPES = [(2, 24, 40, 128, 128, 8), (1, 30, 40, 256, 128, 15),
             (1, 16, 16, 128, 256, 16)]


@pytest.mark.parametrize('scales', sorted(SCALES))
@pytest.mark.parametrize('shape', E1_SHAPES,
                         ids=['x'.join(map(str, s[:5])) for s in E1_SHAPES])
def test_e1_conv3x3_vs_pallas(shape, scales):
    """E1 at its three check shapes: the f32 epilogue with the input
    requant at 0.8531."""

    b, h, w, c, cout, bh = shape
    x, wq, sc, bias = _conv_inputs(c + cout, b, h, w, c, cout, scales)
    want = e1_conv(*_jax(x, wq, sc, bias), RATIO, Y_SCALE, bh)
    got = _port_conv(x, wq, sc, bias, RATIO, Y_SCALE, 'f32')
    _assert_int8(got, want, identical=False)


def test_e1_in_ratio_one_skips_the_requant():
    """At in_ratio 1 neither side requantizes the input: -128 stays
    -128 (a requant would clip it to -127)."""

    x, wq, sc, bias = _conv_inputs(3, 1, 8, 8, 64, 64, 'spread')
    x[0, 3, 3, :] = -128
    want = e1_conv(*_jax(x, wq, sc, bias), 1.0, Y_SCALE, 8)
    got = _port_conv(x, wq, sc, bias, 1.0, Y_SCALE, 'f32')
    _assert_int8(got, want, identical=False)
    assert not np.array_equal(
        got, _port_conv(x, wq, sc, bias, 1.0 + 1e-12, Y_SCALE, 'f32'))


@pytest.mark.parametrize('silu', [True, False])
@pytest.mark.parametrize('mode', ['rank3', 'flat', 'im2col'])
def test_e2_modes_are_one_port_function(mode, silu):
    """E2's three schedules against the one port function; silu=False is
    the f32_nosilu epilogue."""

    x, wq, sc, bias = _conv_inputs(7, 2, 24, 40, 128, 128, 'spread')
    want = e2_conv(*_jax(x, wq, sc, bias), RATIO, Y_SCALE, 8, mode, silu)
    got = _port_conv(x, wq, sc, bias, RATIO, Y_SCALE,
                     'f32' if silu else 'f32_nosilu')
    _assert_int8(got, want, identical=False)


@pytest.mark.parametrize('scales', sorted(SCALES))
@pytest.mark.parametrize('ep', ['f32', 'bf16'])
@pytest.mark.parametrize('mode', ['flat', 'im2col'])
def test_e3_modes_and_epilogues(mode, ep, scales):
    x, wq, sc, bias = _conv_inputs(11, 2, 24, 40, 128, 128, scales)
    ep_dtype = jnp.float32 if ep == 'f32' else jnp.bfloat16
    want = e3_conv(*_jax(x, wq, sc, bias), RATIO, Y_SCALE, 8, mode,
                   ep_dtype)
    got = _port_conv(x, wq, sc, bias, RATIO, Y_SCALE, ep)
    _assert_int8(got, want, identical=ep == 'bf16')


@pytest.mark.parametrize('scales', sorted(SCALES))
@pytest.mark.parametrize('epi', ['f32', 'bf16', 'hybrid'])
def test_e4_epilogues(epi, scales):
    x, wq, sc, bias = _conv_inputs(13, 2, 24, 40, 128, 128, scales)
    want = e4_conv(*_jax(x, wq, sc, bias), 8, epi)
    got = _port_conv(x, wq, sc, bias, 1.0, Y_SCALE, epi)
    _assert_int8(got, want, identical=epi == 'bf16')


def test_s32_to_bf16_rounds_twice_as_xla_does():
    """XLA converts s32 -> bf16 through f32 (two roundings), in a jitted
    graph and inside a Pallas body alike; the port's bf16 epilogue does
    the same (acc.to(float32).to(bfloat16); __int2float_rn then
    __float2bfloat16_rn in the kernel). A single rounding differs above
    2^24: 2^24 + 2^16 + 1 rounds once to 2^24 + 2^17, twice to 2^24."""

    rng = np.random.RandomState(0)
    v = np.concatenate([
        rng.randint(-2 ** 31, 2 ** 31 - 1, 4096, dtype=np.int64),
        rng.randint(-2 ** 26, 2 ** 26, 4096),
        [2 ** 24 + 2 ** 16 + 1, -(2 ** 24 + 2 ** 16 + 1),
         2 ** 25 + 2 ** 17 + 1, 2 ** 24 - 1, 2 ** 24 + 2 ** 16]]).astype(
             np.int32)
    v = np.resize(v, (65, 128))

    def body(x_ref, o_ref):
        o_ref[:] = x_ref[:].astype(jnp.bfloat16)

    pallas = np.asarray(pl.pallas_call(
        body, interpret=True,
        out_shape=jax.ShapeDtypeStruct(v.shape, jnp.bfloat16))(
            jnp.asarray(v)).astype(jnp.float32))
    jitted = np.asarray(jax.jit(lambda a: a.astype(jnp.bfloat16))(
        jnp.asarray(v)).astype(jnp.float32))
    port = torch.from_numpy(v).to(torch.float32).to(torch.bfloat16).float()
    assert np.array_equal(pallas, jitted)
    assert np.array_equal(port.numpy(), pallas)

    # the single rounding, exactly: nearest multiple of the bf16 ulp, ties
    # to even
    x = v.astype(np.int64)
    ulp = 2 ** np.maximum(np.floor(np.log2(np.maximum(np.abs(x), 1))) - 7,
                          0).astype(np.int64)
    q, r = np.divmod(np.abs(x), ulp)
    up = (2 * r > ulp) | ((2 * r == ulp) & (q % 2 == 1))
    single = np.sign(x) * (q + up) * ulp
    differs = single.astype(np.float64) != pallas
    assert differs.any() and (np.abs(x[differs]) > 2 ** 24).all()


@pytest.mark.parametrize('epilogue', sorted(conv_int8.EXP_EPILOGUES))
def test_epilogues_vs_jax_over_wide_accumulators(epilogue):
    """Each epilogue alone, on int32 accumulators up to 2^27 in magnitude
    (beyond 2^24, where int -> float rounds) and scales that spread y over
    the SiLU's range, against the same jnp ops jitted (the experiments'
    epilogue lines)."""

    rng = np.random.RandomState(17)
    acc = np.concatenate([rng.randint(-2 ** 27, 2 ** 27, (64, 96)),
                          rng.randint(-2 ** 16, 2 ** 16, (64, 96))]).astype(
                              np.int32)
    scale = rng.uniform(1e-7, 4e-4, 96).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 96).astype(np.float32)
    inv_y = 1.0 / Y_SCALE

    def jax_epilogue(acc, sc, b):
        if epilogue == 'bf16':
            y = acc.astype(jnp.bfloat16) * sc.astype(jnp.bfloat16) + \
                b.astype(jnp.bfloat16)
            y = (y * jax.nn.sigmoid(y)).astype(jnp.float32)
        else:
            y = acc.astype(jnp.float32) * sc + b
            if epilogue == 'f32':
                y = y * jax.nn.sigmoid(y)
            elif epilogue == 'hybrid':
                y = y * jax.nn.sigmoid(y.astype(jnp.bfloat16)).astype(
                    jnp.float32)
        return jnp.clip(jnp.round(y * np.float32(inv_y)), -127,
                        127).astype(jnp.int8)

    want = jax.jit(jax_epilogue)(*_jax(acc, scale, bias))
    got = conv_int8.exp_epilogue_reference(
        torch.from_numpy(acc), torch.from_numpy(scale),
        torch.from_numpy(bias), Y_SCALE, epilogue).numpy()
    _assert_int8(got, want, identical=epilogue == 'bf16')


def _mm_inputs(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randint(-127, 128, (m, k)).astype(np.int8),
            rng.randint(-127, 128, (k, n)).astype(np.int8))


def test_e5_mm_kernel_and_fused():
    """E5's check shape, 512x1152x512: the s32 kernel and the fused
    requant at 3e-4, identical."""

    a, b = _mm_inputs(5, 512, 1152, 512)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = mm_full_k(_mm_kernel, *_jax(a, b), jnp.int32, 512, 512)
    assert np.array_equal(gemm_int8.gemm_int8(ta, tb).numpy(),
                          np.asarray(want))
    want = mm_full_k(_mm_kernel_fused, *_jax(a, b), jnp.int8, 512, 512)
    got = gemm_int8.gemm_int8(ta, tb, requant_scale=3e-4).numpy()
    _assert_int8(got, want, identical=True)


@pytest.mark.parametrize('schedule', ['full_k', 'kloop'])
def test_e6_mm_schedules(schedule):
    """E6's check shape, 1024x1152x256, full-K (bm 512, bn 256) and the
    k-loop (bk 384), identical."""

    a, b = _mm_inputs(6, 1024, 1152, 256)
    if schedule == 'full_k':
        want = mm_full_k(_mm_kernel, *_jax(a, b), jnp.int32, 512, 256)
    else:
        want = mm_kloop(*_jax(a, b), 512, 256, 384)
    got = gemm_int8.gemm_int8(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('m,k,n', [(37, 45, 29), (1, 7, 3), (65, 130, 66)])
def test_gemm_ragged_vs_numpy(m, k, n):
    """Shapes off every tile and off the 4-byte words, against numpy's
    int64 product."""

    a, b = _mm_inputs(m + k + n, m, k, n)
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = gemm_int8.gemm_int8(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), want)
    fused = gemm_int8.gemm_int8(torch.from_numpy(a), torch.from_numpy(b),
                                requant_scale=0.01).numpy()
    want8 = np.clip(np.round(want.astype(np.float32) * np.float32(0.01)),
                    -127, 127).astype(np.int8)
    assert np.array_equal(fused, want8)


def test_wrong_inputs_raise():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 8), dtype=torch.int8)
    s = torch.ones(8)
    with pytest.raises(ValueError, match='unknown epilogue'):
        conv_int8.conv3x3_int8_exp(x, w, s, s, 1.0, 0.1, 'bf8')
    with pytest.raises(ValueError, match='CPU or a CUDA'):
        conv_int8.conv3x3_int8_exp(x.to('meta'), w.to('meta'), s, s, 1.0,
                                   0.1)
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match='CPU or on one CUDA'):
        gemm_int8.gemm_int8(a.to('meta'), a.t().contiguous().to('meta'))
