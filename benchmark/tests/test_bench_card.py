"""
On the card (skipped without one): the controls of `correct` at the
cell's own size on one seed, with a short window. Each has to come out
above its cell's limit on at least one compared number.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q
"""

import pytest

from benchmark import controls, run


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['md-bf16-camtrap'])
def test_control_is_refused(card, workload):
    spec = run.load_spec()
    _, _, config, _ = run.find_cell(spec, workload)
    result = run.run_cell(
        spec, workload, 4242424242, 2.0, False, card,
        config=controls.merged(config, config['control']['program']))[0]
    assert not result['correct'], result['checks']
