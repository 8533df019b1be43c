"""
The port's bf16 conv epilogue (ops/silu_bf16.py, kernel E7) on the CPU,
against the JAX package's bf16 activation:

- exhaustively, over all 65,536 bf16 bit patterns, against the Pallas
  kernel experiments/exp_pallas_l0_retry.py _bf16_kernel (x *
  jax.nn.sigmoid(x) on a bf16 block) run in interpret mode; the
  experiment script runs its probes when imported, so its three-line
  kernel body is restated here;
- on a conv + bias, against megadetector_tpu/models/yolov5.py _conv with
  dtype bf16 (the conv rounded to bf16, + b rounded, then the activation).

XLA lowers each bf16 op to an f32 op and a rounding convert (exp, 1 +,
1 /, *), and so does the port. The bar: bit-identical wherever both
results are normal numbers (|y| >= 2^-126) or NaN together; below 2^-126
XLA on the CPU flushes subnormal intermediates to zero, and there the two
differ by less than 2^-119 in absolute value (measured: 511 of the 65,536
patterns, at most 8.8e-37).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from jax.experimental import pallas as pl

from megadetector_tpu.models import yolov5 as jax_yolov5
from megadetector_tpu_torch.ops import silu_bf16

TINY = 2.0 ** -126
FLUSH_BOUND = 2.0 ** -119


def _bf16_kernel(x_ref, o_ref):
    # experiments/exp_pallas_l0_retry.py:71-74
    x = x_ref[:]
    y = x * jax.nn.sigmoid(x)
    o_ref[:] = y


def _all_bf16():
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    return torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).reshape(512, 128)


def _to_torch_bf16(a):
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        torch.bfloat16)


def _check(ours, ref):
    o, r = ours.float(), ref.float()
    nan = torch.isnan(o)
    assert torch.equal(nan, torch.isnan(r))
    normal = ~nan & (o.abs() >= TINY) & (r.abs() >= TINY)
    same = ours.view(torch.int16) == ref.view(torch.int16)
    assert bool(same[normal].all()), int((~same[normal]).sum())
    rest = ~nan & ~normal
    if rest.any():
        assert float((o[rest] - r[rest]).abs().max()) < FLUSH_BOUND
    return int((~same & ~nan).sum())


def test_exhaustive_vs_jax_bf16_kernel():
    x = _all_bf16()
    x_j = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ref = pl.pallas_call(
        _bf16_kernel, interpret=True,
        out_shape=jax.ShapeDtypeStruct(x_j.shape, jnp.bfloat16))(x_j)
    ours = silu_bf16.silu_bf16(x)
    n_flushed = _check(ours, _to_torch_bf16(ref))
    assert n_flushed <= 1024, n_flushed
    # without a bias the reference and the wrapper are the same op chain
    assert torch.equal(ours.view(torch.int16),
                       silu_bf16.silu_bf16_reference(x).view(torch.int16))


@pytest.mark.parametrize('layout', ['contiguous', 'channels_last'])
def test_conv_bias_silu_vs_jax_conv(layout):
    """The port's bf16 Conv epilogue: the conv rounded to bf16 without its
    bias, then silu_bf16 with the bias, against JAX _conv(dtype=bf16)."""

    rng = np.random.RandomState(0)
    x = rng.rand(2, 16, 20, 8).astype(np.float32)
    w = (rng.randn(3, 3, 8, 16) * 0.3).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    ref = jax_yolov5._conv({'w': jnp.asarray(w), 'b': jnp.asarray(b)},
                           jnp.asarray(x).astype(jnp.bfloat16), 1,
                           jnp.bfloat16, pad=1)

    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).to(torch.bfloat16).permute(3, 2, 0, 1)
    if layout == 'contiguous':
        xt = xt.contiguous()
    y = F.conv2d(xt, wt, None, 1, 1)
    assert y.is_contiguous(memory_format=torch.channels_last) == \
        (layout == 'channels_last')
    out = silu_bf16.silu_bf16(y, torch.from_numpy(b).to(torch.bfloat16))
    _check(out.permute(0, 2, 3, 1).contiguous(), _to_torch_bf16(ref))


def test_out_and_in_place():
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 4, 4)
                         .astype(np.float32)).to(torch.bfloat16)
    bias = torch.linspace(-1, 1, 8).to(torch.bfloat16)
    want = silu_bf16.silu_bf16_reference(x, bias)
    y = x.clone()
    assert silu_bf16.silu_bf16(y, bias, out=y) is y
    assert torch.equal(y, want)


def test_wrong_inputs_raise():
    x = torch.zeros((1, 4, 2, 2), dtype=torch.bfloat16, device='meta')
    with pytest.raises(ValueError, match='CPU or a CUDA'):
        silu_bf16.silu_bf16(x)
