"""
The inference-options comparison in the port against the JAX package's:
postprocessing/compare_batch_results.py byte for byte on synthetic results
(pairwise pages and categories, ground truth, class-agnostic and
confidence-sorted variants, a spawned rendering pool, n_way_comparison,
find_equivalent_threshold, the CLI), then
workflows/compare_inference_options.py end to end on the CPU with
torch_port_data's yolov5n at batch 8 over a grid of canvas modes and
test-time augmentation: each job's detections within the golden
tolerances of the JAX job's, and, given the JAX jobs' files, every later
stage (previews, review pages, agreement, summary) byte-identical.
"""

import json
import os
import shutil
import sys

import pytest
from PIL import Image

from megadetector_tpu.models.convert_weights import save_checkpoint
from megadetector_tpu.postprocessing import compare_batch_results as jcbr
from megadetector_tpu.utils import md_tests
from megadetector_tpu.workflows import compare_inference_options as jcio
from megadetector_tpu_torch.postprocessing import \
    compare_batch_results as tcbr
from megadetector_tpu_torch.workflows import \
    compare_inference_options as tcio

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_data as data  # noqa: E402
import torch_workflow_data as wd  # noqa: E402


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """Two synthetic results files over one folder (model B's a reseeded
    variant of model A's), and a ground truth."""

    root = tmp_path_factory.mktemp('compare')
    images = str(root / 'images')
    files = wd.write_images(images)
    a = wd.results(files, seed=4, classified=True)
    b = wd.results(files, seed=5, classified=True)
    # B agrees with A on a third of the images
    for im_a, im_b in zip(a['images'][::3], b['images'][::3]):
        im_b.clear()
        im_b.update(json.loads(json.dumps(im_a)))
    return {'root': root, 'images': images, 'files': files,
            'a': wd.write_json(str(root / 'a.json'), a),
            'b': wd.write_json(str(root / 'b.json'), b),
            'c': wd.write_json(str(root / 'c.json'),
                               wd.results(files, seed=6)),
            'gt': wd.write_json(str(root / 'gt.json'),
                                wd.ground_truth(files))}


def _both(root, tag, run):
    outs = {}
    for module, side in ((jcbr, 'jax'), (tcbr, 'port')):
        out = str(root / tag / side)
        os.makedirs(out)
        outs[side] = run(module, out)
    return (str(root / tag / 'port'), str(root / tag / 'jax'),
            outs['port'], outs['jax'])


def _categories(results):
    return json.dumps(results.categories_to_image_files, sort_keys=True)


PAIR_CASES = {
    'defaults': {},
    'per_category': {'detection_thresholds_a': {'animal': 0.4,
                                                'default': 0.2},
                     'max_images_per_category': 3,
                     'max_images_per_page': 2, 'random_seed': 3},
    'agnostic_sorted': {'class_agnostic_comparison': True,
                        'sort_by_confidence': True,
                        'category_names_to_include': ['animal', 'person'],
                        'show_category_names_on_detected_boxes': False},
    'ground_truth': {'ground_truth_file': 'GT'},
    'spawned_pool': {'parallelize_rendering': True,
                     'parallelize_rendering_with_threads': False,
                     'parallelize_rendering_n_cores': 2,
                     'required_token': 'cam_'},
    'unrendered': {'render_images': False,
                   'filenames_to_include': 'SOME'},
}


@pytest.mark.parametrize('case', sorted(PAIR_CASES))
def test_compare_batch_results_identical(pair, case):
    fields = dict(PAIR_CASES[case])
    if fields.get('ground_truth_file') == 'GT':
        fields['ground_truth_file'] = pair['gt']
    if fields.get('filenames_to_include') == 'SOME':
        fields['filenames_to_include'] = pair['files'][1::2]

    def run(module, out):
        options = module.BatchComparisonOptions()
        options.output_folder = out
        options.image_folder = pair['images']
        options.results_filename_a = pair['a']
        options.results_filename_b = pair['b']
        options.results_description_a = 'model A'
        for k, v in fields.items():
            setattr(options, k, v)
        results = module.compare_batch_results(options)
        return (_categories(results), os.path.relpath(
            results.html_output_file, out))

    got, want, ours, ref = _both(pair['root'], 'pair_' + case, run)
    names = wd.assert_same_tree(got, want)
    assert ours == ref
    assert len(json.loads(ours[0])) >= 3
    if fields.get('render_images', True):
        assert sum(n.endswith('.jpg') for n in names) >= 4


def test_n_way_comparison_identical(pair):
    def run(module, out):
        options = module.BatchComparisonOptions()
        options.output_folder = out
        options.image_folder = pair['images']
        results = module.n_way_comparison(
            [pair['a'], pair['b'], pair['c']], options,
            detection_thresholds=[0.2, 0.3, 0.25],
            model_names=['A', 'B', 'C'])
        options = module.BatchComparisonOptions()
        options.output_folder = None
        stats = module.n_way_comparison([pair['a'], pair['c']], options)
        return json.dumps([
            [os.path.relpath(results.html_output_file, out)],
            [(p.comparison_short_name, p.comparison_friendly_name,
              _categories(p)) for p in results.pairwise_results],
            [_categories(p) for p in stats.pairwise_results]])

    got, want, ours, ref = _both(pair['root'], 'n_way', run)
    wd.assert_same_tree(got, want)
    assert ours == ref and len(json.loads(ours)[1]) == 3


def test_thresholds_and_cli_identical(pair, monkeypatch):
    for threshold in (0.05, 0.3, 0.9, 1.5):
        for category in (None, '1', '3'):
            assert tcbr.find_equivalent_threshold(
                pair['a'], pair['b'], threshold, category=category) == \
                jcbr.find_equivalent_threshold(
                    pair['a'], pair['b'], threshold, category=category)
        for names in (None, 'animal', ['person', 'vehicle']):
            assert tcbr.find_image_level_detections_above_threshold(
                pair['a'], threshold, names) == \
                jcbr.find_image_level_detections_above_threshold(
                    pair['a'], threshold, names)

    def run(module, out):
        monkeypatch.setattr(sys, 'argv', [
            'compare_batch_results', out, pair['images'], pair['a'],
            pair['c'], '--detection_threshold_a', '0.3'])
        module.main()

    got, want, _, _ = _both(pair['root'], 'cli', run)
    wd.assert_same_tree(got, want)


#%% compare_inference_options end to end


@pytest.fixture(scope='module')
def grid(tmp_path_factory):
    """torch_port_data's images as JPEGs in two folders and its sharpened
    yolov5n; the JAX package's comparison over a 2 x 2 grid (canvas mode
    x augmentation) at batch 8."""

    root = tmp_path_factory.mktemp('grid')
    folder = root / 'images'
    for i, img in enumerate(data.images()):
        sub = folder / 'cam{}'.format(i % 2)
        sub.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(str(sub / 'im{}.jpg'.format(i)),
                                  quality=95)
    model = str(root / 'md_test.npz')
    save_checkpoint(data.sharpened_params(data.images()), model,
                    data.METADATA)
    jax_out = str(root / 'jax')
    jcio.compare_inference_options(_grid_options(jcio, str(folder), model,
                                                 jax_out))
    return {'root': root, 'folder': str(folder), 'model': model,
            'jax': jax_out}


def _grid_options(module, folder, model, out):
    options = module.InferenceComparisonOptions()
    options.input_folder = folder
    options.output_folder = out
    options.model_files = [model]
    options.canvas_modes = ['auto', 'square']
    options.augment_states = [False, True]
    options.batch_size = 8
    options.rendering_threshold = 0.05
    options.output_image_width = 160
    if module is jcio:
        # The test session's 8 virtual CPU devices would otherwise round
        # the JAX package's batch up to 8 per device
        options.detector_options = {'force_cpu': 'true',
                                    'use_mesh': 'false'}
    else:
        options.device = 'cpu'
    return options


def test_compare_inference_options_matches_jax(grid):
    out = str(grid['root'] / 'port')
    summary = tcio.compare_inference_options(_grid_options(
        tcio, grid['folder'], grid['model'], out))
    with open(os.path.join(grid['jax'], 'comparison_summary.json')) as f:
        ref = json.load(f)
    assert [j['job_name'] for j in summary['jobs']] == \
        [j['job_name'] for j in ref['jobs']] and len(ref['jobs']) == 4
    assert all(not j['skipped'] and j['images_per_second'] > 0
               for j in summary['jobs'])
    assert len(summary['pairwise_agreement']) == 6
    for job, ref_job in zip(summary['jobs'], ref['jobs']):
        with open(job['job_output_file']) as f:
            ours = json.load(f)
        counts = [len(im['detections']) for im in ours['images']]
        assert all(0 < n < 300 for n in counts), counts
        result = md_tests.compare_results(ref_job['job_output_file'], ours,
                                          data.golden_options())
        assert result['n_images_compared'] == len(data.SIZES)
        assert result['errors'] == [], (job['job_name'],
                                        result['errors'][:5])


def test_later_stages_identical_given_jax_detections(grid):
    """Both packages' comparisons over copies of the JAX jobs' results
    files (every job skipped): the previews, the review pages, the
    agreement and the summary byte for byte."""

    outs = {}
    for module, side in ((jcio, 'jax'), (tcio, 'port')):
        out = str(grid['root'] / 'given' / side)
        shutil.copytree(os.path.join(grid['jax'], 'json_files'),
                        os.path.join(out, 'json_files'))
        outs[side] = module.compare_inference_options(_grid_options(
            module, grid['folder'], grid['model'], out))
    assert all(j['skipped'] for j in outs['port']['jobs'])
    assert len(outs['port']['pairwise_agreement']) == 6
    names = wd.assert_same_tree(
        str(grid['root'] / 'given' / 'port'),
        str(grid['root'] / 'given' / 'jax'),
        replace=((str(grid['root'] / 'given' / 'jax').encode(),
                  str(grid['root'] / 'given' / 'port').encode()),))
    assert sum(n.startswith('image_review/') and n.endswith('.jpg')
               for n in names) == 4 * len(data.SIZES)


def test_cli_writes_the_port_job(grid, monkeypatch):
    out = str(grid['root'] / 'cli')
    monkeypatch.setattr(sys, 'argv', [
        'compare_inference_options', grid['folder'], out, '--model_files',
        grid['model'], '--batch_size', '8', '--no_image_review_pages',
        '--visualization_sample', '2', '--device', 'cpu'])
    tcio.main()
    with open(os.path.join(out, 'comparison_summary.json')) as f:
        summary = json.load(f)
    (job,) = summary['jobs']
    ref = os.path.join(grid['jax'], 'json_files',
                       os.path.basename(job['job_output_file']))
    result = md_tests.compare_results(ref, job['job_output_file'],
                                      data.golden_options())
    assert result['errors'] == [] and 'pairwise_agreement' not in summary
