"""
The int8 experiment entry points of the port
(megadetector_tpu_torch/experiments/exp_*.py) on the CPU: each one's
--check at its original's check shapes, and its timed sweep of the
original's variants at small shapes (the module's shape lists replaced),
with every variant's launch count held to what it declares. On the CPU the
kernels' wrappers run their plain versions, so no kernel launch is
counted; chip_smoke.py holds the counts on the card.
"""

import pytest
import torch

from megadetector_tpu_torch.experiments import (_harness, exp_conv3x3,
                                                exp_conv3x3b, exp_conv3x3c,
                                                exp_conv3x3d, exp_int8_chain,
                                                exp_int8_matmul)

MODULES = [exp_conv3x3, exp_conv3x3b, exp_conv3x3c, exp_conv3x3d,
           exp_int8_chain, exp_int8_matmul]
IDS = [m.__name__.rsplit('.', 1)[1] for m in MODULES]
SMALL_CONV = [(8, 12, 16), (4, 6, 32)]


@pytest.mark.parametrize('module', MODULES, ids=IDS)
def test_check_on_cpu(module, capsys):
    assert module.main(['--check', '--device', 'cpu']) == {'records': []}
    out = capsys.readouterr().out
    assert 'check OK' in out and 'differ on' not in out


@pytest.mark.parametrize('module', MODULES, ids=IDS)
def test_sweep_on_cpu_at_small_shapes(module, monkeypatch, capsys):
    for name in ('SHAPES', 'CONV_SHAPES'):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, SMALL_CONV)
    if module is exp_conv3x3c:
        monkeypatch.setattr(module, 'CEILING', 64)
    if module is exp_int8_chain:
        monkeypatch.setattr(module, 'MM_SHAPES', [(16, 64), (8, 128)])
    if module is exp_int8_matmul:
        monkeypatch.setattr(module, 'mm_shapes', lambda batch: [
            (batch * 24, 64, 32, 'rows'), (64, 128, 128, 'square')])
    result = module.main(['--device', 'cpu', '--batch', '2', '--chain', '2',
                          '--iters', '1'])
    records = result['records']
    assert records
    ports = [r for r in records if r['expect']]
    assert ports, 'no variant runs a port kernel'
    for r in records:
        assert r['clock'] == 'host clock, cpu'
        assert r['ms_per_step'] > 0 and r['tops'] > 0
        assert r['calls'] == 2 * (2 if module is not exp_int8_matmul else 1)
        assert set(r['expect']) <= set(_harness.KERNELS)
        assert all(n == 0 for n in r['launches'].values())
    out = capsys.readouterr().out
    assert 'host clock, cpu' in out
    if module in (exp_conv3x3b, exp_conv3x3c, exp_int8_matmul):
        assert 'one function on Hopper' in out


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default run would start')
    with pytest.raises(RuntimeError, match='CUDA'):
        exp_int8_matmul.main(['--check'])
