"""
The drivers of the program, one module per kind of configuration (a
configuration file's 'system'): each has run(cell, config, traffic, seed,
seconds, trace, device) -> the observation that benchmark/run.py and the
metric readers read.
"""

import time

# The set-up clock's start: benchmark/run.py sets the process's own
PROCESS_START = time.perf_counter()


def steps(marks):
    """{step: seconds} of set-up from (step, time at its end) marks, the
    first counted from the process's start."""

    times = [PROCESS_START] + [t for _, t in marks]
    return {name: round(b - a, 3)
            for (name, _), a, b in zip(marks, times, times[1:])}
