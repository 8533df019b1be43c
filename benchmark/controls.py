"""
The controls of `correct`: runs in the next precision below the one a
configuration states, which the comparison has to refuse. Not part of the
benchmark's own runs; run on the card at the cell's own size:

    python3 -m benchmark.controls --workload <name> --seeds 1,2,3 \
        --seconds 5 [--runs program,control]

prints, per seed, the compared numbers of each run asked for (the
control, the default, and the program as configured) beside the
configuration's limits, with the run's figures for the record.

A configuration's 'control' is {'program': {overrides}}: the program's own
lower-precision path (the detector's int8 chain for a bf16 detector,
calibrated by the port's quantize_checkpoint on frames of the pool at
the window's scale), the cell run through benchmark/run.py's run_cell with
the overrides merged into its configuration.
"""

import argparse
import copy
import json

import torch

from benchmark import run


def merged(base, overrides):
    """A copy of the configuration [base] with [overrides] merged in,
    nested dicts key by key."""

    out = copy.deepcopy(base)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = v
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--seconds', type=float, default=5.0)
    parser.add_argument('--runs', default='control',
                        help='comma-separated: program, control')
    args = parser.parse_args(argv)
    spec = run.load_spec()
    config = run.find_cell(spec, args.workload)[2]
    device = torch.device('cuda', 0)
    control = config['control']
    for seed in (int(s) for s in args.seeds.split(',')):
        rows = []
        runs = args.runs.split(',')
        if 'program' in runs:
            rows.append(('program', run.run_cell(
                spec, args.workload, seed, args.seconds, False, device)))
        if 'control' in runs:
            rows.append(('control', run.run_cell(
                spec, args.workload, seed, args.seconds, False, device,
                config=merged(config, control['program']))))
        for name, (result, _, obs) in rows:
            print(json.dumps({
                'workload': args.workload, 'seed': seed, 'run': name,
                'numbers': {k: v['value']
                            for k, v in result['checks'].items()},
                'limits': config['limits'], 'facts': obs['facts']}),
                flush=True)


if __name__ == '__main__':
    main()
