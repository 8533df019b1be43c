"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import importlib
import importlib.util
import json
import os
import re

from benchmark import run

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TOP_KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
            'end_to_end', 'per_layer'}
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        '\n' not in text and '\t' not in text


def test_keys_names_and_units():
    spec = run.load_spec()
    assert set(spec) == TOP_KEYS
    assert 1 <= spec['run_seconds'] <= 51
    assert spec['paths'] == ['benchmark']
    assert all(_line(w) for w in spec['command'])
    names = []
    for c in spec['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['why'])
        assert _line(c['source']) and c['file'].startswith('benchmark/')
        assert all(NAME.match(k) for k in c['reduced'])
        names.append(c['name'])
    for w in spec['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['config'] in names and w['chips'] in (1, 4)
        assert _line(w['why'])
        names.append(w['name'])
    for m in spec['end_to_end'] + spec['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
        names.append(m['name'])
    assert len(names) == len(set(names))
    for m in spec['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                          'bound', 'source'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    assert 'setup_s' in {m['name'] for m in spec['end_to_end']}
    for m in spec['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                          'source', 'layer', 'moves'}
        assert _line(m['layer'])
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    spec = run.load_spec()
    for w in spec['workloads']:
        e2e = {m['name'] for m in run.metrics_for(spec, 'end_to_end',
                                                  w['name'])}
        layer = run.metrics_for(spec, 'per_layer', w['name'])
        assert 'setup_s' in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m['moves'] in e2e, (w['name'], m['name'])


def test_files_found_by_name():
    spec = run.load_spec()
    for w in spec['workloads']:
        cell, entry, config, traffic = run.find_cell(spec, w['name'])
        importlib.import_module('benchmark.reference.' + config['family'])
        importlib.import_module('benchmark.systems.' + config['system'])
        assert traffic['items'] == 'frames'
        assert set(config['limits'])
    for m in spec['per_layer']:
        path = os.path.join(run.BENCH_DIR, 'metrics', m['name'] + '.py')
        module_spec = importlib.util.spec_from_file_location('m', path)
        module = importlib.util.module_from_spec(module_spec)
        module_spec.loader.exec_module(module)
        assert callable(module.read)


def test_metric_readers_find_nothing_in_an_empty_run():
    obs = {'spans': [], 'trace': None, 'batches': 0, 'program_calls': 0}
    spec = run.load_spec()
    for m in spec['per_layer']:
        assert run.read_metric(m['name'], obs) is None, m['name']
