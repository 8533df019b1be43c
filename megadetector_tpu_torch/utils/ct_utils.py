"""
The numeric and container helpers the port's detector, drivers and writer
use: its own copy of the functions of megadetector_tpu/utils/ct_utils.py
that emit MD-format JSON (float truncation and rounding, the YOLO and xyxy
box conventions, sorting, the JSON writer, --detector_options parsing and
printing, argparse -> options objects).
"""

import inspect
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


def convert_xywh_to_xyxy(api_box):
    """[x_min, y_min, w, h] -> [x_min, y_min, x_max, y_max]."""

    x, y, w, h = api_box
    return [x, y, x + w, y + h]


def is_iterable(x):
    """True if x supports iteration (strings count as iterable)."""

    try:
        iter(x)
        return True
    except TypeError:
        return False


def args_to_object(args, obj):
    """
    Copy public fields from an argparse.Namespace onto [obj] (in place; also
    returned). The conventional bridge from CLI flags to options classes.
    """

    for n, v in inspect.getmembers(args):
        if not n.startswith('_'):
            setattr(obj, n, v)
    return obj


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


def dict_to_kvp_list(d, item_separator=' ', kv_separator='=',
                     non_string_value_handling='error'):
    """Serialize a flat dict back to 'k=v k=v ...' form."""

    assert non_string_value_handling in ('error', 'omit', 'convert')
    tokens = []
    for k, v in d.items():
        if not isinstance(v, str):
            if non_string_value_handling == 'error':
                raise ValueError('Non-string value for key {}'.format(k))
            elif non_string_value_handling == 'omit':
                continue
            v = str(v)
        tokens.append('{}{}{}'.format(k, kv_separator, v))
    return item_separator.join(tokens)
