"""
A run of each cell, on the CPU at a small size (benchmark/run.py's
run_cell: everything but the look for a card), with the program's timed
path broken underneath: `correct` has to come out false for each fault
the cell can have. One chip, no training step: a batch with half of its
images left out, and an answer altered where it is produced (the boxes'
x and y swapped; the confidences scaled by 0.4; every confidence 0.9). A
sound run comes out correct.
"""

import numpy as np
import pytest
import torch

from benchmark import run

CPU = torch.device('cpu')


def _run(spec, workload, traffic_dir, trace=False):
    return run.run_cell(spec, workload, 987654321012, 1.0, trace, CPU,
                        traffic_dir=traffic_dir)[0]


def _break_detector(monkeypatch, fault):
    from megadetector_tpu_torch.models.detector import TorchDetector
    sound = TorchDetector.run_program

    def broken(self, batch_u8, *args, **kwargs):
        out, topk = sound(self, batch_u8, *args, **kwargs)
        out = dict(out)
        if fault == 'half':
            valid = out['valid'].copy()
            valid[len(valid) // 2:] = False
            out['valid'] = valid
        elif fault == 'altered':
            out['boxes'] = out['boxes'][..., [1, 0, 3, 2]].copy()
        elif fault == 'conf_scaled':
            out['scores'] = out['scores'] * 0.4
        else:
            out['scores'] = np.full_like(out['scores'], 0.9)
        return out, topk
    monkeypatch.setattr(TorchDetector, 'run_program', broken)


@pytest.mark.parametrize('workload', ['md-bf16-camtrap'])
def test_sound_run_is_correct(small_spec, workload):
    spec, traffic_dir = small_spec
    result = _run(spec, workload, traffic_dir, trace=True)
    assert result['correct'], result['checks']
    assert result['failed'] == 0 and result['attempted'] > 0
    assert list(result)[-1] == 'checks'


@pytest.mark.parametrize('fault', ['half', 'altered', 'conf_scaled',
                                   'conf_constant'])
def test_fault_is_not_correct(small_spec, monkeypatch, fault):
    spec, traffic_dir = small_spec
    _break_detector(monkeypatch, fault)
    result = _run(spec, 'md-bf16-camtrap', traffic_dir)
    assert not result['correct'], result['checks']


def test_missing_answers_are_not_correct(small_spec, monkeypatch):
    """A batch whose images come back as failures."""
    from megadetector_tpu_torch.models import detector

    def fail(self, infos, results, *args, **kwargs):
        for idx, info in infos:
            results[idx] = {'file': info['file'], 'detections': None,
                            'failure': detector.FAILURE_INFER}
    monkeypatch.setattr(detector.TorchDetector, '_run_batch', fail)
    spec, traffic_dir = small_spec
    result = _run(spec, 'md-bf16-camtrap', traffic_dir)
    assert not result['correct'] and result['failed'] > 0
    assert np.isfinite(result['checks']['failed']['value'])
