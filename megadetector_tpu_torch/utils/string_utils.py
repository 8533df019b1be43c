"""
String parsing helpers (reference: megadetector/utils/string_utils.py).

The port's own copy of megadetector_tpu/utils/string_utils.py: the same
public names, signatures, defaults and output bytes.
"""

import re


def is_float(s):
    """True when [s] (a string or number) parses as a float."""

    if s is None:
        return False
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def is_int(s):
    """True when [s] (a string or number) parses as an int (rejects
    floats with fractional parts, accepts '4.0'-style strings via int
    round-trip semantics of the reference: only base-10 integers)."""

    if s is None:
        return False
    try:
        int(str(s))
        return True
    except (TypeError, ValueError):
        return False


_SIZE_SUFFIXES = {
    'b': 1,
    'kb': 1024,
    'mb': 1024 ** 2,
    'gb': 1024 ** 3,
    'tb': 1024 ** 4,
    'pb': 1024 ** 5,
}


def human_readable_to_bytes(size):
    """
    '3 MB', '1.5GB', '200kb', or a bare number -> byte count (float).
    Case-insensitive; 'K'/'KB' both accepted.
    """

    if isinstance(size, (int, float)):
        return float(size)
    s = str(size).strip().lower()
    m = re.match(r'^([0-9.]+)\s*([a-z]*)$', s)
    if m is None:
        raise ValueError('Cannot parse size string {}'.format(size))
    value = float(m.group(1))
    suffix = m.group(2)
    if suffix in ('', 'bytes', 'byte'):
        return value
    if not suffix.endswith('b'):
        suffix += 'b'
    if suffix not in _SIZE_SUFFIXES:
        raise ValueError('Unknown size suffix in {}'.format(size))
    return value * _SIZE_SUFFIXES[suffix]


_ANSI_PATTERN = re.compile(r'\x1b\[[0-9;]*[a-zA-Z]')


def remove_ansi_codes(s):
    """Strip ANSI escape sequences from [s]."""

    return _ANSI_PATTERN.sub('', s)
