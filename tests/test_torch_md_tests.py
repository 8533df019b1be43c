"""
The port's golden-file comparator, utils/md_tests.py (its own copy of
megadetector_tpu/utils/md_tests.py, which the weight gate runs), against
JAX's on the CPU: compare_results (three option sets),
compare_detection_lists and output_files_are_identical give JAX's
copy's exact results (error lists and exceptions included) on every
stored golden file and on a doctored copy of it (a conf moved, a box
moved, a detection dropped, a failure, an extra image).
"""

import copy
import glob
import json
import os

import numpy as np
import pytest

from megadetector_tpu.utils import md_tests as jax_md_tests
from megadetector_tpu_torch.utils import md_tests

DATA = os.path.join(os.path.dirname(__file__), 'data')


def _outcome(fn, *args, **kwargs):
    """fn's result, or the exception it raised (type and message)."""

    try:
        return fn(*args, **kwargs)
    except Exception as e:  # compared, not hidden
        return ('raised', type(e).__name__, str(e))


def _doctored(results, rng):
    out = copy.deepcopy(results)
    for i, im in enumerate(out['images']):
        dets = im.get('detections')
        if not dets:
            continue
        if i % 4 == 0:
            dets[0]['conf'] = min(1.0, dets[0]['conf'] + 0.01)
        elif i % 4 == 1:
            dets[0]['bbox'] = [v + 0.002 for v in dets[0]['bbox']]
        elif i % 4 == 2:
            dets.pop(rng.randint(len(dets)))
        else:
            im['detections'] = None
    out['images'].append({'file': 'extra.jpg', 'detections': []})
    return out


@pytest.mark.parametrize('golden', sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(
        DATA, '*golden_results*.json'))))
def test_md_tests_identical_to_jax(golden, tmp_path):
    with open(os.path.join(DATA, golden)) as f:
        results = json.load(f)
    rng = np.random.RandomState(1)
    doctored = _doctored(results, rng)
    options = [None]
    for t, conf, coord in ((0.005, 0.005, 0.001), (0.1, 0.02, 0.01)):
        pair = []
        for module in (md_tests, jax_md_tests):
            o = module.MDTestOptions()
            o.comparison_confidence_threshold = t
            o.max_conf_error, o.max_coord_error = conf, coord
            pair.append(o)
        options.append(pair)
    for a, b in ((results, results), (results, doctored),
                 (doctored, results)):
        for o in options:
            ours_o, ref_o = (None, None) if o is None else o
            assert _outcome(md_tests.compare_results, a, b, ours_o) == \
                _outcome(jax_md_tests.compare_results, a, b, ref_o)
    for im_a, im_b in zip(results['images'], doctored['images']):
        args = (im_a.get('detections'), im_b.get('detections'))
        assert _outcome(md_tests.compare_detection_lists, *args,
                        image_id=im_a['file']) == _outcome(
            jax_md_tests.compare_detection_lists, *args,
            image_id=im_a['file'])
    paths = []
    for name, data in (('a', results), ('b', doctored)):
        paths.append(str(tmp_path / (name + '.json')))
        with open(paths[-1], 'w') as f:
            json.dump(data, f)
    for x in paths:
        for y in paths:
            assert md_tests.output_files_are_identical(x, y) == \
                jax_md_tests.output_files_are_identical(x, y)
