"""
The numeric and container helpers the port's detector and writer use: its
own copy of the functions of megadetector_tpu/utils/ct_utils.py that emit
MD-format JSON (float truncation and rounding, the YOLO -> MD box
convention, sorting, the JSON writer, --detector_options parsing).
"""

import json
import math
import os


def truncate_float(x, precision=3):
    """
    Truncate (round toward negative infinity) the fractional part of [x] to
    [precision] decimal digits, e.g. truncate_float(0.0003214884) ->
    0.000321: the float representation of 'classic' MD output.
    """

    factor = 10 ** precision
    return math.floor(x * factor) / factor


def round_float(x, precision=3):
    """Round [x] to [precision] digits via the native Python round()."""

    return round(x, precision)


def truncate_float_array(xs, precision=3):
    """Truncate every float in the iterable [xs]; returns a list."""

    return [truncate_float(x, precision=precision) for x in xs]


def round_float_array(xs, precision=3):
    """Round every float in the iterable [xs]; returns a list."""

    return [round_float(x, precision=precision) for x in xs]


def convert_yolo_to_xywh(yolo_box):
    """[x_center, y_center, w, h] -> [x_min, y_min, w, h]."""

    cx, cy, w, h = yolo_box
    return [cx - w / 2.0, cy - h / 2.0, w, h]


def sort_list_of_dicts_by_key(L, k, reverse=False, none_handling='smallest'):  # noqa
    """
    Sort a list of dicts by the value at key [k]. None values sort as
    smallest (default) or largest.
    """

    if none_handling not in ('smallest', 'largest'):
        raise ValueError('none_handling must be smallest or largest')
    none_bucket = 0 if none_handling == 'smallest' else 2

    def _key(d):
        v = d.get(k)
        if v is None:
            return (none_bucket, 0)
        return (1, v)

    return sorted(L, key=_key, reverse=reverse)


def write_json(path, content, indent=1, force_str=False, ensure_ascii=True,
               encoding='utf-8'):
    """
    json.dump as every results file is written: indent=1, '\\n' newlines,
    optional str() fallback for values JSON cannot hold.
    """

    default_handler = str if force_str else None
    parent_dir = os.path.dirname(path)
    if len(parent_dir) > 0:
        os.makedirs(parent_dir, exist_ok=True)
    with open(path, 'w', newline='\n', encoding=encoding) as f:
        json.dump(content, f, indent=indent, default=default_handler,
                  ensure_ascii=ensure_ascii)


def parse_kvp(s, kv_separator='='):
    """Parse 'key=value' into (key, value); value '' when no separator."""

    if kv_separator in s:
        k, v = s.split(kv_separator, 1)
        return k.strip(), v.strip()
    return s.strip(), ''


def parse_kvp_list(items, kv_separator='=', d=None):
    """
    Parse a list of 'key=value' strings (e.g. from --detector_options) into a
    dict. Items without a separator map to ''.
    """

    if d is None:
        d = {}
    if items is None:
        return d
    for item in items:
        k, v = parse_kvp(item, kv_separator=kv_separator)
        d[k] = v
    return d
