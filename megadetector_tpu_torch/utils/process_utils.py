"""
Subprocess execution helpers.

Behavioral contract follows the reference
(megadetector/utils/process_utils.py:18): run a command streaming output
line by line, returning (return code, output lines).

The port's own copy of megadetector_tpu/utils/process_utils.py: the same
public names, signatures, defaults and output bytes.
"""

import os
import subprocess


def execute(cmd, encoding=None, errors=None, env=None, verbose=False):
    """
    Run [cmd] (a string) in a shell, yielding output lines as they arrive.
    Raises CalledProcessError on nonzero exit.
    """

    popen = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, shell=True,
                             universal_newlines=True, encoding=encoding,
                             errors=errors, env=env)
    for stdout_line in iter(popen.stdout.readline, ''):
        yield stdout_line
    popen.stdout.close()
    return_code = popen.wait()
    if return_code:
        raise subprocess.CalledProcessError(return_code, cmd)


def execute_and_print(cmd, print_output=True, encoding=None, errors=None,
                      env=None, verbose=False, catch_exceptions=True):
    """
    Run [cmd], optionally echoing output. Returns
    {'status': return code, 'output': list of lines}.
    """

    to_return = {'status': 'unknown', 'output': []}
    output = []
    try:
        for s in execute(cmd, encoding=encoding, errors=errors, env=env,
                         verbose=verbose):
            output.append(s)
            if print_output:
                print(s, end='', flush=True)
        to_return['status'] = 0
    except subprocess.CalledProcessError as cpe:
        if not catch_exceptions:
            raise
        print('execute_and_print caught error: {} ({})'.format(
            cpe.output, str(cpe)))
        to_return['status'] = cpe.returncode
    to_return['output'] = output
    return to_return


def get_process_list():
    """List of (pid, name) for running processes (POSIX /proc walk)."""

    processes = []
    for pid in os.listdir('/proc'):
        if not pid.isdigit():
            continue
        try:
            with open('/proc/{}/comm'.format(pid)) as f:
                processes.append((int(pid), f.read().strip()))
        except OSError:
            continue
    return processes
