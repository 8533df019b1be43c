"""
The accelerator and profiling utilities of the port (utils/
accelerator_test.py, utils/gpu_test.py, utils/profiling.py) on the CPU:

- accelerator_test(device='cpu') runs the greedy NMS's plain version on
  its smoke case and reports platform 'cpu'; with no card and no device
  it reports the fault (no CUDA) and its CLI exits non-zero; the card's
  own run (the kernel against its plain version) is chip_smoke.py's;
- gpu_test's torch_test, tf_test and directml_test print and return what
  the JAX module's do; its main() runs accelerator_test where the JAX
  module runs its JAX probe;
- StageTimer and ThroughputMeter: the JAX module's statistics and summary
  lines on the same samples; xla_trace writes a Chrome trace naming the
  spans of annotate and the ops they ran, nothing when disabled.
"""

import json
import os

import pytest
import torch

from megadetector_tpu.utils import gpu_test as jax_gpu_test
from megadetector_tpu.utils import profiling as jax_profiling
from megadetector_tpu_torch.utils import accelerator_test, gpu_test, \
    profiling


def test_accelerator_test_on_the_cpu_when_asked(capsys):
    result = accelerator_test.accelerator_test(device='cpu')
    out = capsys.readouterr().out
    assert result['torch_ok'] and result['smoke_test_ok'], result
    assert result['platform'] == 'cpu' and result['error'] is None
    assert result['torch_version'] == torch.__version__
    assert result['smoke_test_seconds'] >= 0
    assert 'plain greedy NMS' in result['smoke_test']
    assert 'Smoke test' in out and 'passed' in out
    with pytest.raises(SystemExit) as e:
        accelerator_test.main(['--device', 'cpu'])
    assert e.value.code == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason='a card is present')
def test_accelerator_test_without_a_card_reports_the_fault(capsys):
    result = accelerator_test.accelerator_test(verbose=False)
    assert result['torch_ok'] and not result['smoke_test_ok']
    assert 'CUDA' in result['error'] and result['platform'] is None
    with pytest.raises(SystemExit) as e:
        accelerator_test.main([])
    assert e.value.code == 1
    assert 'CUDA' in capsys.readouterr().out


@pytest.mark.parametrize('name', ['torch_test', 'tf_test', 'directml_test'])
def test_gpu_test_probes_as_jax(name, capsys):
    ours = getattr(gpu_test, name)()
    ours_out = capsys.readouterr().out
    ref = getattr(jax_gpu_test, name)()
    assert ours == ref
    assert ours_out == capsys.readouterr().out
    assert getattr(gpu_test, name)(verbose=False) == ref
    assert capsys.readouterr().out == ''


def test_gpu_test_main_runs_the_accelerator_probe(capsys, monkeypatch):
    calls = []
    monkeypatch.setattr(accelerator_test, 'accelerator_test',
                        lambda **kw: calls.append(kw))
    gpu_test.main()
    out = capsys.readouterr().out
    assert calls == [{}]
    assert '*** Running accelerator tests ***' in out
    assert '*** Running TF tests ***' in out
    assert not hasattr(gpu_test, 'jax_test')


def test_stage_timer_and_meter_as_jax(monkeypatch):
    samples = {'load': [0.01, 0.03, 0.02], 'forward': [0.5],
               'nms': [0.001, 0.002]}
    timers = [profiling.StageTimer(), jax_profiling.StageTimer()]
    for timer in timers:
        for stage, xs in samples.items():
            for x in xs:
                timer.record(stage, x)
        with timer.time_stage('write'):
            pass
        timer.samples['write'] = [0.004]
    assert timers[0].stats() == timers[1].stats()
    assert timers[0].summary() == timers[1].summary()

    clock = [100.0]
    for module in (profiling, jax_profiling):
        monkeypatch.setattr(module.time, 'time', lambda: clock[0])
    meters = [profiling.ThroughputMeter(), jax_profiling.ThroughputMeter()]
    clock[0] = 112.5
    for meter in meters:
        meter.update(8)
        meter.update()
    assert meters[0].rate == meters[1].rate == 9 / 12.5
    assert meters[0].summary_line() == meters[1].summary_line()
    assert meters[0].summary_line('crops') == \
        meters[1].summary_line('crops')


def test_trace_names_the_annotated_spans_and_their_ops(tmp_path, capsys):
    x = torch.ones(64, 64)
    with profiling.xla_trace(str(tmp_path)) as prof:
        assert prof is not None
        with profiling.annotate('md_program'):
            y = torch.mm(x, x)
    assert float(y[0, 0]) == 64.0
    files = os.listdir(str(tmp_path))
    assert len(files) == 1 and files[0].startswith('trace_')
    with open(os.path.join(str(tmp_path), files[0])) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name') for e in events}
    assert 'md_program' in names and 'aten::mm' in names
    assert 'Wrote trace to' in capsys.readouterr().out

    with profiling.xla_trace(str(tmp_path / 'off'), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / 'off').exists()
