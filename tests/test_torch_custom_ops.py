"""
The port's kernels as torch custom operators (namespace mdtorch), on the
CPU, where each runs its plain version:

- each operator's fake (tracing) version gives the real output's shape
  and dtype (torch.library.opcheck's schema and fake-tensor checks);
- each is one node of a torch.export graph: the plain NMS loop over K is
  no longer unrolled into the graph;
- the CPU implementation equals the plain version exactly, through the
  wrappers and through torch.ops;
- the device-style threshold split (cuda_nms.threshold_split_tensor, run
  on the CPU) is bit-identical to threshold_split over a sweep and
  adversarial thresholds;
- device_constant survives an export: the store keeps real tensors, and
  the exported graph takes them as constants (no copy from the host).
"""

import numpy as np
import pytest
import torch

from megadetector_tpu_torch import device as port_device
from megadetector_tpu_torch.ops import (bottleneck_int8, conv_int8,
                                        cuda_nms, l0_fused, silu_bf16)

OPS = torch.ops.mdtorch


def _rng(seed=0):
    return np.random.RandomState(seed)


def _boxes(rng, b=2, k=70):
    xy = rng.rand(b, k, 2).astype(np.float32) * 60
    wh = rng.rand(b, k, 2).astype(np.float32) * 30 + 1
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1))
    valid = torch.from_numpy(rng.rand(b, k) > 0.2)
    return boxes, valid


def _int8(rng, shape):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _conv_args(mode, stride=1):
    rng = _rng(1)
    x = _int8(rng, (1, 6, 5, 8))
    w = _int8(rng, (16, 3, 3, 8))
    scale = _f32(rng, (16,), 1e-4).abs()
    bias = _f32(rng, (16,), 0.1)
    y_scale = None if mode == 'int32' else 0.05
    return (x, w, None if mode == 'int32' else scale,
            None if mode == 'int32' else bias, [stride, stride],
            [1, 1, 1, 1], y_scale, mode != 'linear')


def _bottleneck_args(shortcut):
    rng = _rng(2)
    c = 8
    return (_int8(rng, (1, 6, 5, c)), _int8(rng, (c, 1, 1, c)),
            _f32(rng, (c,), 1e-4).abs(), _f32(rng, (c,), 0.1), 0.04,
            _int8(rng, (c, 3, 3, c)), _f32(rng, (c,), 1e-4).abs(),
            _f32(rng, (c,), 0.1), 0.05, 0.03, shortcut)


def _l0_args():
    rng = _rng(3)
    images = torch.from_numpy(rng.randint(0, 256, (2, 8, 10, 3))
                              .astype(np.uint8))
    w, b = l0_fused.prepare_l0_weights({'w': rng.randn(6, 6, 3, 16) * 0.1,
                                        'b': rng.randn(16) * 0.1})
    return images, w, b


def _silu_args(with_bias):
    rng = _rng(4)
    x = _f32(rng, (2, 8, 4, 4), 3.0).to(torch.bfloat16)
    bias = _f32(rng, (8,)).to(torch.bfloat16) if with_bias else None
    return x, bias


# (operator, arguments, plain version of the same arguments)
CASES = {
    'nms_value': (OPS.greedy_nms_keep,
                  lambda: _boxes(_rng()) + (0.45,),
                  cuda_nms.greedy_nms_keep_reference),
    'nms_tensor': (OPS.greedy_nms_keep_t,
                   lambda: _boxes(_rng()) + (torch.tensor(0.45),),
                   cuda_nms.greedy_nms_keep_reference),
    'conv_int32': (OPS.conv_int8, lambda: _conv_args('int32'),
                   conv_int8.conv_int8_reference),
    'conv_silu': (OPS.conv_int8, lambda: _conv_args('silu'),
                  conv_int8.conv_int8_reference),
    'conv_linear_s2': (OPS.conv_int8, lambda: _conv_args('linear', 2),
                       conv_int8.conv_int8_reference),
    'bottleneck_residual': (OPS.bottleneck_int8,
                            lambda: _bottleneck_args(True),
                            lambda *a: bottleneck_int8
                            .bottleneck_int8_reference(*a)[0]),
    'bottleneck_plain': (OPS.bottleneck_int8,
                         lambda: _bottleneck_args(False),
                         lambda *a: bottleneck_int8
                         .bottleneck_int8_reference(*a)[0]),
    'l0_fused': (OPS.l0_fused, _l0_args, l0_fused.l0_fused_reference),
    'silu_bias': (OPS.silu_bf16, lambda: _silu_args(True),
                  silu_bf16.silu_bf16_reference),
    'silu_no_bias': (OPS.silu_bf16, lambda: _silu_args(False),
                     silu_bf16.silu_bf16_reference),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_fake_and_real_outputs_agree(case):
    op, make_args, _ = CASES[case]
    args = make_args()
    torch.library.opcheck(op, args,
                          test_utils=('test_schema', 'test_faketensor'))
    from torch._subclasses.fake_tensor import FakeTensorMode
    real = op(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        fake = op(*fake_args)
    assert fake.shape == real.shape and fake.dtype == real.dtype


@pytest.mark.parametrize('case', sorted(CASES))
def test_cpu_implementation_is_the_plain_version(case):
    op, make_args, plain = CASES[case]
    args = make_args()
    got, want = op(*args), plain(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _counters():
    return (cuda_nms.launches, conv_int8.launches, bottleneck_int8.launches,
            l0_fused.launches, silu_bf16.launches)


def test_wrappers_call_the_operators():
    before = _counters()
    boxes, valid = _boxes(_rng())
    assert torch.equal(
        cuda_nms.greedy_nms_keep(boxes, valid, 0.45),
        cuda_nms.greedy_nms_keep(boxes, valid, torch.tensor(0.45)))
    x, w, scale, bias, stride, pads, y_scale, act = _conv_args('silu')
    assert torch.equal(conv_int8.conv_int8(x, w, scale, bias, stride, pads,
                                           y_scale, act),
                       OPS.conv_int8(x, w, scale, bias, stride, pads,
                                     y_scale, act))
    args = _bottleneck_args(True)
    out, out_scale = bottleneck_int8.bottleneck_int8(*args)
    want, want_scale = bottleneck_int8.bottleneck_int8_reference(*args)
    assert torch.equal(out, want) and out_scale == want_scale
    assert torch.equal(l0_fused.l0_fused(*_l0_args()),
                       l0_fused.l0_fused_reference(*_l0_args()))
    x, b = _silu_args(True)
    y = x.clone()
    assert silu_bf16.silu_bf16(y, b, out=y) is y
    assert torch.equal(y, silu_bf16.silu_bf16_reference(x, b))
    # The launch counters count kernel launches only, never the plain
    # versions
    assert _counters() == before


class _Calls(torch.nn.Module):
    """Calls one function on its inputs."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _wrapper_case(case):
    """(function of tensors, the tensor inputs) for [case]."""

    op, make_args, _ = CASES[case]
    args = make_args()
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    positions = [i for i, a in enumerate(args)
                 if isinstance(a, torch.Tensor)]

    def fn(*ts):
        full = list(args)
        for i, t in zip(positions, ts):
            full[i] = t
        return op(*full)

    return fn, tensors, op


@pytest.mark.parametrize('case', sorted(CASES))
def test_each_operator_is_one_node_of_an_exported_graph(case):
    fn, tensors, op = _wrapper_case(case)
    with torch.no_grad():
        program = torch.export.export(_Calls(fn), tuple(tensors),
                                      strict=False)
    calls = [n for n in program.graph.nodes if n.op == 'call_function']
    targets = [n.target for n in calls]
    assert targets.count(op.default) == 1
    # Nothing else is traced: the plain versions (NMS's loop over K, the
    # stem's 108 taps) stay inside the operator
    assert len(calls) <= 2, targets
    assert torch.equal(program.module()(*tensors), fn(*tensors))


def test_nms_wrapper_exports_as_one_node():
    boxes, valid = _boxes(_rng(), k=300)

    def nms(b, v, t):
        return cuda_nms.greedy_nms_keep(b, v, t)

    thr = torch.tensor(0.45)
    with torch.no_grad():
        program = torch.export.export(_Calls(nms), (boxes, valid, thr),
                                      strict=False)
    assert len(program.graph.nodes) < 10
    for t in (0.3, 0.45, 0.7):
        assert torch.equal(
            program.module()(boxes, valid, torch.tensor(t)),
            cuda_nms.greedy_nms_keep_reference(boxes, valid, t))


def _adversarial_thresholds():
    f32 = np.float32
    tiny = np.finfo(f32).tiny
    values = [0.0, -0.0, 1.0, 0.5, 0.45, 0.6, 1e-30, 2.0 ** -60,
              2.0 ** -61, tiny, np.nextafter(tiny, f32(0)),
              f32(1.4e-45), f32(1e-40), -0.45, np.finfo(f32).max,
              np.nextafter(np.finfo(f32).max, f32(0))]
    # t+ with an odd and with an even mantissa, near each usual threshold
    for t in (0.3, 0.45, 0.5, 0.6, 0.65, 0.7, 0.85):
        t = f32(t)
        for _ in range(4):
            values.append(t)
            t = np.nextafter(t, f32(np.inf))
    return [f32(v) for v in values]


def _split_bits(t):
    m, m_hi, m_lo, tie_up = cuda_nms.threshold_split(float(t))
    return np.array([m, m_hi, m_lo, float(tie_up)]).view(np.int64)


@pytest.mark.parametrize('kind', ['adversarial', 'sweep'])
def test_device_threshold_split_is_bit_identical(kind):
    if kind == 'adversarial':
        values = _adversarial_thresholds()
        # Both parities of t+'s mantissa are among them
        parities = {int(np.nextafter(v, np.float32(np.inf)).view(np.uint32))
                    % 2 for v in values}
        assert parities == {0, 1}
    else:
        rng = _rng(5)
        values = list(rng.rand(3000).astype(np.float32)) + list(
            (rng.rand(500) * 2.0 ** rng.randint(-140, 20, 500))
            .astype(np.float32))
    for v in values:
        got = cuda_nms.threshold_split_tensor(torch.tensor(v))
        assert got.dtype == torch.float64 and tuple(got.shape) == (4,)
        assert np.array_equal(got.numpy().view(np.int64), _split_bits(v)), v


def test_device_constant_survives_an_export():
    values = [[3.25, -1.5], [7.0, 0.125]]
    before = port_device.device_constant(values, torch.float32, 'cpu')

    class UsesConstant(torch.nn.Module):
        def forward(self, x):
            return x * port_device.device_constant(values, torch.float32,
                                                   x.device) + \
                port_device.device_constant([9.5], torch.float32, x.device)

    x = torch.ones(2, 2)
    with torch.no_grad():
        program = torch.export.export(UsesConstant(), (x,), strict=False)
    # The graph takes both as constants: no op makes or copies them
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == 'call_function']
    assert not any('lift_fresh' in t or '_to_copy' in t or 'to.' in t
                   for t in targets), targets
    assert torch.equal(program.module()(x), x * before + 9.5)
    # The store holds real tensors only, and hands out the same ones
    after = port_device.device_constant(values, torch.float32, 'cpu')
    made_in_trace = port_device.device_constant([9.5], torch.float32, 'cpu')
    assert after is before
    assert type(made_in_trace) is torch.Tensor
    assert torch.equal(made_in_trace, torch.tensor([9.5]))
    assert all(type(t) is torch.Tensor
               for t in port_device._CONSTANTS.values())


def test_meta_tensors_are_refused():
    x = torch.zeros((1, 8, 2, 2), dtype=torch.bfloat16, device='meta')
    with pytest.raises(ValueError, match='CPU or a CUDA'):
        silu_bf16.silu_bf16(x)
    with pytest.raises(ValueError, match='CPU or a CUDA'):
        conv_int8.conv_int8(torch.zeros((1, 4, 4, 8), dtype=torch.int8,
                                        device='meta'),
                            torch.zeros((8, 1, 1, 8), dtype=torch.int8,
                                        device='meta'),
                            None, None, (1, 1), (0, 0, 0, 0))
    with pytest.raises(ValueError, match='CPU or a CUDA'):
        cuda_nms.greedy_nms_keep(torch.zeros((1, 4, 4), device='meta'),
                                 torch.zeros((1, 4), dtype=torch.bool,
                                             device='meta'), 0.5)
