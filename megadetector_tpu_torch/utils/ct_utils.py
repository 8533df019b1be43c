"""
The numeric and container helpers the port's detector, drivers and writer
use: its own copy of the functions of megadetector_tpu/utils/ct_utils.py
that emit MD-format JSON (float truncation and rounding, the YOLO and xyxy
box conventions, sorting, the JSON writer, --detector_options parsing and
printing, argparse -> options objects), and those the folder workflows
use (IoU, max confidence, dictionary inversion, list chunking, camera
folders, the datetime JSON handler), the empty and NaN tests of the
Wildlife Insights tools (isnan, is_empty, compare_values_nan_equal), and
the rest of the JAX module's public helpers (distances, sorting, parsing,
temporary folders, environment checks), so that the port has all of them.
"""

import argparse
import datetime
import inspect
import json
import math
import os
import tempfile
import uuid


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


def json_serialize_datetime(obj):
    """json.dump default handler serializing datetimes to ISO format."""

    if isinstance(obj, (datetime.datetime, datetime.date)):
        return obj.isoformat()
    raise TypeError('Object of type {} is not JSON serializable'.format(
        type(obj)))


def write_json(path,
               content,
               indent=1,
               force_str=False,
               serialize_datetimes=False,
               ensure_ascii=True,
               encoding='utf-8'):
    """
    json.dump as every results file is written: indent=1, '\\n' newlines,
    optional str() fallback for values JSON cannot hold and ISO datetimes.
    """

    def _default(obj):
        if serialize_datetimes:
            try:
                return json_serialize_datetime(obj)
            except TypeError:
                pass
        if force_str:
            return str(obj)
        raise TypeError('Object of type {} is not JSON serializable'.format(
            type(obj)))

    default_handler = None
    if force_str or serialize_datetimes:
        default_handler = _default
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


def get_iou(bb1, bb2):
    """Intersection-over-union of two boxes in MD xywh format."""

    ax0, ay0, ax1, ay1 = convert_xywh_to_xyxy(bb1)
    bx0, by0, bx1, by1 = convert_xywh_to_xyxy(bb2)

    assert ax0 < ax1 and ay0 < ay1, 'Malformed bounding box'
    assert bx0 < bx1 and by0 < by1, 'Malformed bounding box'

    ix0 = max(ax0, bx0)
    iy0 = max(ay0, by0)
    ix1 = min(ax1, bx1)
    iy1 = min(ay1, by1)

    if ix1 < ix0 or iy1 < iy0:
        return 0.0

    inter = (ix1 - ix0) * (iy1 - iy0)
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    iou = inter / float(union)
    assert 0.0 <= iou <= 1.0, 'Illegal IoU {}'.format(iou)
    return iou


def get_max_conf(im):
    """
    Maximum detection confidence for an image dict in the MD output format;
    0.0 for failures / empty / missing detection lists.
    """

    detections = im.get('detections', None) if isinstance(im, dict) else None
    if not detections:
        return 0.0
    return max(d['conf'] for d in detections)


def invert_dictionary(d, verify_unique=False):
    """Swap keys and values; optionally assert values were unique."""

    inverted = {v: k for k, v in d.items()}
    if verify_unique:
        assert len(inverted) == len(d), \
            'Cannot invert dictionary with non-unique values'
    return inverted


def split_list_into_n_chunks(L, n, chunk_strategy='greedy'): # noqa
    """
    Split list L into n chunks. 'greedy' keeps chunks contiguous
    (sizes differ by at most 1); 'balanced' deals round-robin.
    """

    if chunk_strategy == 'greedy':
        k, m = divmod(len(L), n)
        return [L[i * k + min(i, m):(i + 1) * k + min(i + 1, m)]
                for i in range(n)]
    elif chunk_strategy == 'balanced':
        chunks = [[] for _ in range(n)]
        for i, item in enumerate(L):
            chunks[i % n].append(item)
        return chunks
    else:
        raise ValueError(
            'Invalid chunk strategy {}'.format(chunk_strategy))


def image_file_to_camera_folder(image_fn):
    """
    Map an image path to its "camera folder": the containing folder, with
    trailing capture-point folders like RECNX101 / 100EK113 / DCIM variants
    stripped, since those subdivide one physical camera's images.
    """

    import re

    folder = os.path.dirname(image_fn.replace('\\', '/'))

    # Patterns produced by common trail cameras (Reconyx, Bushnell, ...)
    patterns = [r'RECNX\d+$', r'\d{3}RECNX$', r'DCIM$', r'\d{3}EK\d{3}$',
                r'\d{3}_BTCF$', r'\d{3}MEDIA$']
    stripped = True
    while stripped and len(folder) > 0:
        stripped = False
        leaf = os.path.basename(folder)
        for p in patterns:
            if re.match(p, leaf, re.IGNORECASE):
                folder = os.path.dirname(folder)
                stripped = True
                break
    return folder



def is_empty(v, strip_strings=True):
    """True for None, '', whitespace-only strings, and NaN."""

    if v is None:
        return True
    if isinstance(v, str):
        return len(v.strip() if strip_strings else v) == 0
    if isinstance(v, float) and math.isnan(v):
        return True
    return False


def isnan(v):
    """True if v is a float NaN (never raises)."""

    try:
        return math.isnan(v)
    except TypeError:
        return False


def compare_values_nan_equal(v0, v1):
    """Equality where NaN == NaN."""

    if isnan(v0) and isnan(v1):
        return True
    return v0 == v1


#%% The rest of the JAX module's public helpers


def convert_xywh_to_tf(api_box):
    """[x_min, y_min, w, h] -> TF-style [y_min, x_min, y_max, x_max]."""

    x, y, w, h = api_box
    return [y, x, y + h, x + w]


def point_dist(p1, p2):
    """Euclidean distance between two (x,y) points."""

    return math.hypot(p1[0] - p2[0], p1[1] - p2[1])


def rect_distance(r1, r2, format='x0y0x1y1'):
    """
    Minimum distance between two axis-aligned rectangles; 0 if they overlap
    or touch. [format] is 'x0y0x1y1' or 'x0y0wh' (MD-style).
    """

    assert format in ('x0y0x1y1', 'x0y0wh'), 'Illegal rectangle format'
    if format == 'x0y0wh':
        r1 = convert_xywh_to_xyxy(r1)
        r2 = convert_xywh_to_xyxy(r2)

    ax0, ay0, ax1, ay1 = r1
    bx0, by0, bx1, by1 = r2

    # Gap along each axis (0 when projections overlap)
    dx = max(bx0 - ax1, ax0 - bx1, 0.0)
    dy = max(by0 - ay1, ay0 - by1, 0.0)
    return math.hypot(dx, dy)


def sort_results_for_image(im):
    """
    Sort an image's detections (and each detection's classifications) in
    descending order by confidence, in place.
    """

    if not isinstance(im, dict) or im.get('detections') is None:
        return
    im['detections'] = sort_list_of_dicts_by_key(
        im['detections'], 'conf', reverse=True)
    for det in im['detections']:
        classifications = det.get('classifications')
        if classifications:
            det['classifications'] = sorted(
                classifications, key=lambda c: c[1], reverse=True)


def is_list_sorted(L, reverse=False): # noqa
    """True if list L is sorted ascending (or descending when reverse)."""

    pairs = zip(L, L[1:])
    if reverse:
        return all(a >= b for a, b in pairs)
    return all(a <= b for a, b in pairs)


def split_list_into_fixed_size_chunks(L, n): # noqa
    """Split list L into consecutive chunks of size n (last may be short)."""

    return [L[i:i + n] for i in range(0, len(L), n)]


def sort_dictionary_by_key(d, reverse=False):
    """Return a new dict with items sorted by key."""

    return dict(sorted(d.items(), key=lambda kv: kv[0], reverse=reverse))


def sort_dictionary_by_value(d, sort_values=None, reverse=False):
    """
    Return a new dict with items sorted by value (or by sort_values(value)).
    """

    if sort_values is None:
        return dict(sorted(d.items(), key=lambda kv: kv[1], reverse=reverse))
    return dict(sorted(d.items(), key=lambda kv: sort_values(kv[1]),
                       reverse=reverse))


def sets_overlap(set1, set2):
    """True if the two iterables share at least one element."""

    return not set(set1).isdisjoint(set(set2))


def min_none(a, b):
    """min() that treats None as missing (returns the other value)."""

    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def max_none(a, b):
    """max() that treats None as missing (returns the other value)."""

    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def round_floats_in_nested_dict(obj, decimal_places=5):
    """
    Round every float anywhere inside a nested dict/list structure, in place
    where possible. Returns the (possibly new) object.
    """

    if isinstance(obj, float):
        return round(obj, decimal_places)
    if isinstance(obj, dict):
        for k in obj:
            obj[k] = round_floats_in_nested_dict(obj[k], decimal_places)
        return obj
    if isinstance(obj, list):
        for i in range(len(obj)):
            obj[i] = round_floats_in_nested_dict(obj[i], decimal_places)
        return obj
    return obj


def dict_to_object(d, obj):
    """Copy public keys of dict [d] onto [obj] (in place; also returned)."""

    for k, v in d.items():
        if not k.startswith('_'):
            setattr(obj, k, v)
    return obj


def parse_bool_string(s, strict=False):
    """Parse 'true'/'false' (case-insensitive); optionally strict."""

    if isinstance(s, bool):
        return s
    sl = str(s).strip().lower()
    if sl in ('true', '1', 'yes', 'y', 't'):
        if strict and sl not in ('true', 'false'):
            assert sl == 'true'
        return True
    if sl in ('false', '0', 'no', 'n', 'f'):
        return False
    if strict:
        raise ValueError('Cannot parse bool from {}'.format(s))
    return bool(s)


def to_bool(v):
    """
    Convert strings / numbers / bools to a bool; returns None when the value
    cannot be interpreted.
    """

    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    if isinstance(v, str):
        sl = v.strip().lower()
        if sl in ('true', 'yes', 'y', 't', '1'):
            return True
        if sl in ('false', 'no', 'n', 'f', '0'):
            return False
    return None


def is_function_name(s, calling_namespace):
    """True if string [s] names a callable in the given namespace."""

    return s in calling_namespace and callable(calling_namespace[s])


def read_json(path, encoding='utf-8'):
    """Load a JSON file."""

    with open(path, 'r', encoding=encoding) as f:
        return json.load(f)


def pretty_print_object(obj, b_print=True):
    """JSON-ish dump of an arbitrary object (via __dict__ fallback)."""

    def _default(o):
        if hasattr(o, '__dict__'):
            return {k: v for k, v in vars(o).items()
                    if not k.startswith('_')}
        return str(o)

    s = json.dumps(obj, indent=2, sort_keys=True, default=_default)
    if b_print:
        print(s)
    return s


def make_temp_folder(top_level_folder='megadetector_tpu', subfolder=None,
                     append_guid=True):
    """Create (and return) a scratch folder under the system temp dir."""

    parts = [tempfile.gettempdir(), top_level_folder]
    if subfolder is not None:
        parts.append(subfolder)
    if append_guid:
        parts.append(str(uuid.uuid4()))
    folder = os.path.join(*parts)
    os.makedirs(folder, exist_ok=True)
    return folder


def make_test_folder(subfolder=None):
    """Create a scratch folder for tests."""

    return make_temp_folder(subfolder='tests' if subfolder is None
                            else os.path.join('tests', subfolder))


def is_sphinx_build():
    """True when running inside a Sphinx docs build."""

    return 'sphinx' in str(argparse._sys.argv[0]).lower() if hasattr(
        argparse, '_sys') else False


def is_running_in_gha():
    """True when running in GitHub Actions."""

    return os.environ.get('GITHUB_ACTIONS') == 'true'


def environment_is_wsl():
    """True when running under the Windows Subsystem for Linux
    (reference: ct_utils.py:environment_is_wsl)."""

    if os.name != 'posix':
        return False
    try:
        with open('/proc/version') as f:
            return 'microsoft' in f.read().lower()
    except OSError:
        return False


def run_all_module_tests():
    """
    Convenience wrapper that runs the tests of the port's helper copies
    (tests/test_torch_ported_utils.py) and returns pytest's exit code.
    Not invoked by pytest; for interactive debugging.
    """

    import subprocess
    import sys

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    test_file = os.path.join(repo_root, 'tests',
                             'test_torch_ported_utils.py')
    assert os.path.isfile(test_file), \
        'Test file not found: {}'.format(test_file)
    return subprocess.call(
        [sys.executable, '-m', 'pytest', '-q', test_file])
