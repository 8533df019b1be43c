"""
Runs one benchmark cell once and prints its result as the last line of
standard output:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration and its traffic are found by name: the
workload in BENCHMARK.json names a configuration (benchmark/configs/, the
file BENCHMARK.json gives) and a traffic mix (benchmark/traffic/<name>.json);
the configuration's 'system' names the module under benchmark/systems/
that drives the program for it. With --trace 0 the line carries the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, each read by
benchmark/metrics/<metric name>.py, which returns None where it finds
nothing to read (the metric is then left out).

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, or when jax, jaxlib, flax or the JAX package is loaded once
the window has closed.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, 'benchmark')
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'megadetector_tpu')


def load_spec(path=None):
    with open(path or os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def find_cell(spec, workload, traffic_dir=None):
    """(workload entry, config entry, config file dict, traffic dict);
    traffic files are read from [traffic_dir] (default
    benchmark/traffic)."""

    cells = {w['name']: w for w in spec['workloads']}
    if workload not in cells:
        raise SystemExit('unknown workload {!r}; known: {}'.format(
            workload, sorted(cells)))
    cell = cells[workload]
    entry = {c['name']: c for c in spec['configs']}[cell['config']]
    with open(os.path.join(ROOT, entry['file'])) as f:
        config = json.load(f)
    with open(os.path.join(traffic_dir or os.path.join(BENCH_DIR, 'traffic'),
                           cell['traffic'] + '.json')) as f:
        traffic = json.load(f)
    return cell, entry, config, traffic


def metrics_for(spec, kind, cell_name):
    """The [kind] ('end_to_end' or 'per_layer') metrics of the cell."""

    return [m for m in spec[kind]
            if cell_name in m.get('workloads', [cell_name])]


def read_metric(name, obs):
    """benchmark/metrics/<name>.py's read(obs), or None."""

    path = os.path.join(BENCH_DIR, 'metrics', name + '.py')
    module_spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + name.replace('.', '_').replace('-', '_'), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read(obs)


def forbidden_loaded():
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""

    return sorted({m.split('.')[0] for m in list(sys.modules)} &
                  set(FORBIDDEN_MODULES))


def card_facts():
    """Lines naming the card, its power limit and the host's cores."""

    lines = []
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.strip()
        lines.append('card: {}'.format(out))
    except (OSError, subprocess.SubprocessError) as e:
        lines.append('card: nvidia-smi unavailable ({})'.format(e))
    lines.append('host cores usable: {}'.format(len(os.sched_getaffinity(0))))
    return lines


def run_cell(spec, workload, seed, seconds, trace, device, traffic_dir=None,
             config=None):
    """Run the cell on [device] (a torch.device), with [config] in place of
    its configuration file where given: returns (result dict, check
    lines, observation). Everything but the look for the card."""

    import torch

    from benchmark import compare

    cell, entry, loaded, traffic = find_cell(spec, workload, traffic_dir)
    config = loaded if config is None else config
    system = importlib.import_module('benchmark.systems.' + config['system'])
    obs = system.run(cell, config, traffic, seed, seconds, trace, device)
    obs['cell'] = cell
    obs['config'] = config
    obs['traffic'] = traffic
    obs['end_to_end']['setup_s'] = obs.pop('setup_s')
    numbers = dict(obs['numbers'])
    numbers['failed'] = obs['failed']
    limits = dict(config['limits'], failed=0)
    correct, lines = compare.verdict(numbers, limits)
    kind = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for m in metrics_for(spec, kind, cell['name']):
        value = obs['end_to_end'].get(m['name']) if not trace else \
            read_metric(m['name'], obs)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {
        'correct': bool(correct),
        'attempted': obs['attempted'],
        'failed': obs['failed'],
        'metrics': metrics,
        'device': {
            'platform': 'gpu' if device.type == 'cuda' else device.type,
            'kind': torch.cuda.get_device_name(device)
            if device.type == 'cuda' else 'cpu',
            'count': int(cell['chips']),
            'memory_peak_bytes': obs['memory_peak_bytes'],
        },
    }
    if trace and obs.get('trace') is not None:
        from benchmark import yardstick
        t = obs['trace']
        merged = yardstick.busy_intervals(t['device'], t['lo'], t['hi'])
        result['device']['busy_s'] = sum(e - s for s, e in merged) / 1e6
        result['device']['window_s'] = (t['hi'] - t['lo']) / 1e6
        result['breakdown'] = {
            'device_ops': yardstick.top_ops(
                [d for d in t['device'] if t['lo'] <= d[1] < t['hi']]),
            'idle_gaps': yardstick.idle_gaps(merged, t['host'], t['lo'],
                                             t['hi']),
        }
    result['checks'] = {n: {'value': v, 'limit': limits[n]}
                        for n, v in numbers.items()}
    return result, lines, obs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    spec = load_spec()
    cell = find_cell(spec, args.workload)[0]
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell['chips']):
        print('{} needs {} CUDA device(s); torch sees {}'.format(
            args.workload, cell['chips'], torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    for line in card_facts():
        print(line, flush=True)
    from benchmark import systems
    systems.PROCESS_START = PROCESS_START
    result, lines, obs = run_cell(spec, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  torch.device('cuda', 0))
    print('window {!r} s, {} attempted, {} failed; {}'.format(
        obs['window_s'], obs['attempted'], obs['failed'], ', '.join(
            '{} {!r}'.format(k, v) for k, v in obs.get('facts', {}).items())),
        flush=True)
    loaded = forbidden_loaded()
    if loaded:
        print('forbidden modules loaded: {}'.format(', '.join(loaded)),
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
