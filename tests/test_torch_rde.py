"""
The port's repeat-detection elimination (postprocessing/
repeat_detection_elimination: repeat_detections_core,
find_repeat_detections, remove_repeat_detections) against the JAX
package's, byte for byte: the filtered results file, the filtering folder
(its detection index and rendered detections and tiles), under the option
sets a job uses (sort orders, category-agnostic matching, location levels,
context boxes, detection tiles, threads, a spawned process pool, a serial
loop); a reviewed folder applied; both CLIs. 'clustersort' (scipy in the
port, sklearn in the JAX package) gives sklearn's order on seeded point
sets and on points exactly at the distance threshold, and the port runs
with sklearn and tqdm hidden.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from megadetector_tpu.postprocessing.repeat_detection_elimination import \
    find_repeat_detections as jfind
from megadetector_tpu.postprocessing.repeat_detection_elimination import \
    remove_repeat_detections as jremove
from megadetector_tpu.postprocessing.repeat_detection_elimination import \
    repeat_detections_core as jrde
from megadetector_tpu_torch.postprocessing.repeat_detection_elimination \
    import find_repeat_detections as tfind
from megadetector_tpu_torch.postprocessing.repeat_detection_elimination \
    import remove_repeat_detections as tremove
from megadetector_tpu_torch.postprocessing.repeat_detection_elimination \
    import repeat_detections_core as trde

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_workflow_data as wd  # noqa: E402


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp('rde')
    images = str(root / 'images')
    files = wd.write_images(images, per_folder=10)
    data = wd.results(files, seed=1, classified=True)
    # One more repeat a camera, of another category, for the
    # category-agnostic option to merge
    for im in data['images']:
        if im['detections'] and im['file'].startswith('cam_a'):
            box = list(im['detections'][0]['bbox'])
            im['detections'].append({'category': '2', 'conf': 0.25,
                                     'bbox': box})
    return {'root': root, 'images': images,
            'results': wd.write_json(str(root / 'md.json'), data)}


OPTION_CASES = {
    'defaults': {},
    'clustersort': {'smartSort': 'clustersort',
                    'smartSortDistanceThreshold': 0.2},
    'no_sort': {'smartSort': None},
    'category_agnostic': {'categoryAgnosticComparisons': True},
    'camera_folders': {'nDirLevelsFromLeaf': 1},
    'context_and_tiles': {'bRenderOtherDetections': True,
                          'otherDetectionsThreshold': 0.05,
                          'bRenderDetectionTiles': True,
                          'detectionTilesMaxCrops': 4,
                          'detectionTilesPrimaryImageLocation': 'left',
                          'maxOutputImageWidth': 100},
    'spawned_processes': {'parallelizationUsesThreads': False,
                          'nWorkers': 2},
    'serial': {'bParallelizeComparisons': False,
               'bParallelizeRendering': False, 'excludeClasses': [3],
               'maxSuspiciousDetectionSize': 0.05},
    'no_folder': {'bWriteFilteringFolder': False},
}


def _run(module, job, out, fields):
    options = module.RepeatDetectionOptions()
    options.imageBase = job['images']
    options.outputBase = os.path.join(out, 'rde')
    options.occurrenceThreshold = 4
    for k, v in fields.items():
        setattr(options, k, v)
    return module.find_repeat_detections(
        job['results'], os.path.join(out, 'filtered.json'), options)


def _both(job, tag, run):
    dirs = []
    for side in ('jax', 'port'):
        out = str(job['root'] / tag / side)
        os.makedirs(out)
        run(side, out)
        dirs.append(out)
    return dirs[1], dirs[0]


def _summary(results, out):
    """The results object's fields, with its own folder's path cut and
    the filtering folder's timestamp made constant."""

    return wd.unstamped(json.dumps({
        'suspicious': results.suspicious_detections,
        'filter_file': results.filter_file and os.path.relpath(
            results.filter_file, out),
        'output_file': os.path.relpath(results.output_file, out),
        'data': results.detection_data}, default=str, sort_keys=True))


@pytest.mark.parametrize('case', sorted(OPTION_CASES))
def test_find_repeat_detections_identical(job, case):
    summaries = {}

    def run(side, out):
        module = trde if side == 'port' else jrde
        summaries[side] = _summary(
            _run(module, job, out, OPTION_CASES[case]), out)

    got, want = _both(job, case, run)
    names = wd.assert_same_tree(got, want)
    assert summaries['port'] == summaries['jax']
    with open(os.path.join(got, 'filtered.json')) as f:
        filtered = json.load(f)
    flipped = sum(d['conf'] < 0 for im in filtered['images']
                  for d in im['detections'] or [])
    assert flipped >= 8, case
    if case != 'no_folder':
        rendered = [n for n in names if n.endswith('.jpg')]
        assert len(rendered) >= 3 and any(
            n.endswith('detectionIndex.json') for n in names)


def test_remove_repeat_detections_identical(job, monkeypatch):
    """A reviewed folder (two renderings deleted: real animals) applied
    through the function (folder and index file) and the CLI."""

    def run(side, out):
        core, remove, cli = (trde, tremove, tfind) if side == 'port' else \
            (jrde, jremove, jfind)
        results = _run(core, job, out, {})
        folder = os.path.dirname(results.filter_file)
        for name in sorted(os.listdir(folder))[:2]:
            if name.endswith('.jpg'):
                os.remove(os.path.join(folder, name))
        remove.remove_repeat_detections(
            job['results'], os.path.join(out, 'reviewed.json'), folder)
        remove.remove_repeat_detections(
            job['results'], os.path.join(out, 'reviewed2.json'),
            results.filter_file)
        monkeypatch.setattr(sys, 'argv', [
            'remove_repeat_detections', job['results'],
            os.path.join(out, 'reviewed_cli.json'), folder])
        remove.main()
        monkeypatch.setattr(sys, 'argv', [
            'find_repeat_detections', job['results'], '--outputFile',
            os.path.join(out, 'cli.json'), '--imageBase', job['images'],
            '--outputBase', os.path.join(out, 'cli_rde'),
            '--occurrenceThreshold', '5', '--iouThreshold', '0.85',
            '--excludeClasses', '2'])
        cli.main()

    got, want = _both(job, 'reviewed', run)
    wd.assert_same_tree(got, want)
    with open(os.path.join(got, 'reviewed.json')) as f:
        reviewed = f.read()
    with open(os.path.join(got, 'filtered.json')) as f:
        assert reviewed != f.read()


def _candidates(points):
    """Candidate dicts whose box centers are [points] (zero-size boxes)."""

    return [{'bbox': [float(x), float(y), 0.0, 0.0], 'i': i}
            for i, (x, y) in enumerate(points)]


def _order(module, points, threshold):
    options = module.RepeatDetectionOptions()
    options.smartSort = 'clustersort'
    options.smartSortDistanceThreshold = threshold
    return [c['i'] for c in module._sort_candidates_for_directory(
        _candidates(points), options)]


@pytest.mark.parametrize('seed', range(6))
def test_clustersort_matches_sklearn(seed):
    rng = np.random.RandomState(seed)
    n = [2, 5, 12, 30, 60, 120][seed]
    points = rng.uniform(0, 1, (n, 2))
    for threshold in (0.05, 0.1, 0.3):
        assert _order(trde, points, threshold) == \
            _order(jrde, points, threshold)


@pytest.mark.parametrize('points,threshold,n_clusters', [
    # sklearn merges only below the threshold
    ([(0, 0), (1, 0), (5, 0)], 1.0, 3),
    ([(0, 0), (3, 4), (10, 0), (13, 4)], 5.0, 4),
    ([(0, 0), (3, 4), (10, 0), (13, 4)], 5.000001, 2),
    # Complete linkage: the farthest pair decides
    ([(0, 0), (2, 0), (4, 0), (9, 0)], 4.0, 3),
    ([(4, 0), (0, 0), (9, 0), (2, 0)], 4.5, 2),
])
def test_clustersort_at_the_threshold(points, threshold, n_clusters):
    from scipy.cluster.hierarchy import fcluster, linkage
    from sklearn.cluster import AgglomerativeClustering

    labels = AgglomerativeClustering(
        n_clusters=None, distance_threshold=threshold,
        linkage='complete').fit_predict(np.array(points, float))
    assert len(set(labels)) == n_clusters
    # fcluster at the threshold itself would merge the boundary pairs
    merged = fcluster(linkage(np.array(points, float), 'complete'),
                      t=threshold, criterion='distance')
    assert len(set(merged)) <= n_clusters
    assert _order(trde, points, threshold) == \
        _order(jrde, points, threshold)


def test_without_sklearn_and_tqdm(job, monkeypatch):
    """sklearn and tqdm hidden: the port's clustersort run writes the
    files it writes with them."""

    fields = dict(OPTION_CASES['clustersort'], bParallelizeRendering=False)
    with_modules = str(job['root'] / 'hidden' / 'with')
    _run(trde, job, with_modules, fields)
    monkeypatch.setitem(sys.modules, 'sklearn', None)
    monkeypatch.setitem(sys.modules, 'sklearn.cluster', None)
    monkeypatch.setitem(sys.modules, 'tqdm', None)
    without = str(job['root'] / 'hidden' / 'without')
    _run(trde, job, without, fields)
    with pytest.raises(ImportError):
        import sklearn.cluster  # noqa: F401
    wd.assert_same_tree(without, with_modules)
    shutil.rmtree(str(job['root'] / 'hidden'))
