"""
The port's crop folder, confidence calibration and plots against the JAX
package's, byte for byte: visualization_utils.crop_image and
path_utils.path_is_abs, create_crop_folder and
crop_results_to_image_results under every option, detector_calibration
(matching with and without ground truth, the fitted mapping, the
calibrated threshold, its plot as PNG bytes), the nine functions of
visualization/plot_utils (PNG bytes and returned values), every CLI of
the sixteen modules (files and printed text), and an AST check that each
public function and class of the sixteen JAX modules, and the two
helpers, exist in the port with the same signature.
"""

import ast
import importlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_postprocessing_data as pdata  # noqa: E402
import torch_workflow_data as wd  # noqa: E402

from megadetector_tpu.utils import path_utils as jpath  # noqa: E402
from megadetector_tpu.visualization import \
    visualization_utils as jvis  # noqa: E402
from megadetector_tpu_torch.utils import path_utils as tpath  # noqa: E402
from megadetector_tpu_torch.visualization import \
    visualization_utils as tvis  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

POSTPROCESSING = (
    'load_api_results', 'add_max_conf', 'convert_output_format',
    'merge_detections', 'remap_detection_categories',
    'categorize_detections_by_size', 'md_to_coco', 'md_to_labelme',
    'md_to_wi', 'separate_detections_into_folders', 'top_folders_to_bottom',
    'create_crop_folder', 'detector_calibration',
    'render_detection_confusion_matrix', 'analyze_classification_results')
MODULES = tuple('postprocessing/' + m for m in POSTPROCESSING) + \
    ('visualization/plot_utils',)


def _pair(path):
    """(JAX module, the port's module) of [path] ('postprocessing/x')."""

    return tuple(importlib.import_module(
        '{}.{}'.format(package, path.replace('/', '.')))
        for package in ('megadetector_tpu', 'megadetector_tpu_torch'))


CROP = _pair('postprocessing/create_crop_folder')
CAL = _pair('postprocessing/detector_calibration')
PLOT = _pair('visualization/plot_utils')


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('pp_crops')
    images = str(root / 'images')
    files = wd.write_images(images)
    sizes = pdata.image_sizes(images, files)
    a = pdata.results_a(files, sizes)
    b = pdata.results_b(a)
    truth = pdata.coco_truth(a, sizes)
    paths = {name: wd.write_json(str(root / '{}.json'.format(name)), d)
             for name, d in (('a', a), ('b', b), ('truth', truth),
                             ('species', pdata.class_truth(files)))}
    return dict(paths, root=root, images=images, files=files, a_data=a,
                b_data=b, truth_data=truth)


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


# %% The two helpers


@pytest.mark.parametrize('expansion', [0, 5])
@pytest.mark.parametrize('threshold', [0.0, 0.15, 0.5])
def test_crop_image_matches(data, expansion, threshold):
    detections = [d for im in data['a_data']['images'][:6]
                  for d in im['detections'] or []]
    detections.append({'category': '1', 'conf': 0.9,
                       'bbox': [0.9, 0.9, 0.3, 0.3]})
    image = jvis.load_image(os.path.join(data['images'],
                                         data['files'][0]))
    got = tvis.crop_image(detections, image, threshold, expansion)
    want = jvis.crop_image(detections, image,
                           confidence_threshold=threshold,
                           expansion=expansion)
    assert len(got) == len(want) == sum(d['conf'] >= threshold
                                        for d in detections)
    for a, b in zip(got, want):
        assert a.size == b.size and a.mode == b.mode
        assert a.tobytes() == b.tobytes()


def test_path_is_abs_matches():
    paths = ['/a/b.jpg', 'a/b.jpg', './a', '', 'C:\\x\\y.jpg', 'c:/x.jpg',
             'D:', '\\\\server\\share\\x.jpg', '\\x.jpg', 'cam:1/x.jpg',
             '~/x.jpg', '1:/x']
    for p in paths:
        got, want = tpath.path_is_abs(p), jpath.path_is_abs(p)
        assert bool(got) == bool(want), p
        assert type(got) is type(want), p


# %% create_crop_folder, crop_results_to_image_results


CROP_CASES = {
    'threads': {},
    'serial_square': {'n_threads': 1, 'square_crops': True, 'expansion': 4},
    'categories_flat': {'categories_to_crop': ['1'], 'flatten_folders': True,
                        'confidence_threshold': 0.3, 'quality': 80},
    'keep_existing': {'overwrite': False, 'existing': True},
    'no_files': {'no_files': True, 'confidence_threshold': 0.5},
}


def _crop_side(side, data, out, settings):
    """One side's create_crop_folder, then crop_results_to_image_results
    on seeded crop classifications; returns both dicts."""

    settings = dict(settings)
    existing = settings.pop('existing', False)
    no_files = settings.pop('no_files', False)
    m = CROP[side]
    options = m.CreateCropFolderOptions()
    options.__dict__.update(settings)
    crops = os.path.join(out, 'crops')
    if existing:
        os.makedirs(os.path.join(crops, 'cam_a'))
        with open(os.path.join(crops, 'cam_a', 'img_01_crop_000.jpg'),
                  'wb') as f:
            f.write(b'kept')
    tagged = None if no_files else os.path.join(out, 'tagged.json')
    crops_md = None if no_files else os.path.join(out, 'crops_md.json')
    data_out = m.create_crop_folder(data['a'], data['images'], crops,
                                    tagged, crops_md, options)
    if no_files:
        return data_out, None
    with open(crops_md) as f:
        crop_results = json.load(f)
    rng = np.random.RandomState(11)
    for im in crop_results['images']:
        if rng.uniform() < 0.9:
            scores = rng.dirichlet(np.ones(4))
            im['detections'][0]['classifications'] = [
                [str(int(c) + 1), round(float(scores[c]), 3)]
                for c in np.argsort(-scores)[:2]]
    crop_results['classification_categories'] = {
        str(i + 1): n for i, n in enumerate(wd.CLASS_NAMES)}
    classified = wd.write_json(os.path.join(out, 'crops_classified.json'),
                               crop_results)
    mapped = m.crop_results_to_image_results(
        tagged, classified, os.path.join(out, 'mapped.json'))
    return data_out, mapped


@pytest.mark.parametrize('case', sorted(CROP_CASES))
def test_create_crop_folder_identical(data, case, capsys):
    settings = CROP_CASES[case]
    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'crop_' + case,
        lambda side, out: _crop_side(side, data, out, settings))
    assert got == want
    wd.assert_same_tree(got_dir, want_dir)
    # The crops the options select, each written (the video cannot be
    # read); every crop classified maps back onto its detection
    threshold = settings.get('confidence_threshold', 0.1)
    categories = settings.get('categories_to_crop')
    selected = [(im['file'], d) for im in got[0]['images']
                for d in im['detections'] or [] if d['conf'] >= threshold
                and (categories is None or d['category'] in categories)]
    assert len(selected) == sum('crop_filename' in d
                                for im in got[0]['images']
                                for d in im['detections'] or [])
    crops = set(wd.tree(os.path.join(got_dir, 'crops')))
    assert {d['crop_filename'] for fn, d in selected
            if not fn.endswith('.mp4')} == crops
    assert 'crop error' in capsys.readouterr().out
    if got[1] is not None:
        with open(os.path.join(got_dir, 'crops_classified.json')) as f:
            classified = {im['file']: im['detections'][0].get(
                'classifications') for im in json.load(f)['images']}
        n_mapped = 0
        for im, im_a in zip(got[1]['images'], data['a_data']['images']):
            for d, d_a in zip(im['detections'] or [],
                              im_a['detections'] or []):
                if classified.get(d.get('crop_filename')):
                    assert d['classifications'] == \
                        classified[d['crop_filename']]
                    n_mapped += 1
                else:
                    assert d.get('classifications') == \
                        d_a.get('classifications')
        assert n_mapped == sum(bool(v) for v in classified.values()) > 0
    if case == 'serial_square':
        for rel in crops:
            with Image.open(os.path.join(got_dir, 'crops', rel)) as im:
                assert im.size[0] == im.size[1]


# %% detector_calibration


CAL_CASES = {
    'paths': {},
    'dicts_gt_file': {'dicts': True, 'gt': 'file', 'return_data': True},
    'gt_dict_options': {'gt': 'dict', 'iou_threshold': 0.4,
                        'confidence_threshold': 0.1,
                        'categories_to_compare': ['1']},
    'self': {'self': True, 'max_samples_per_category': 5},
}


@pytest.mark.parametrize('case', sorted(CAL_CASES))
def test_compare_model_confidence_values_identical(data, case):
    """The match rows, the grouped pairs (downsampled too), the fitted
    mapping, the calibrated threshold, and the plot's PNG bytes."""

    settings = dict(CAL_CASES[case])
    dicts = settings.pop('dicts', False)
    gt = settings.pop('gt', None)
    same = settings.pop('self', False)

    def run(side, out):
        m = CAL[side]
        options = m.CalibrationOptions()
        options.__dict__.update(settings)
        options.model_name_b = 'Model A again' if same else 'Model B'
        a = json.loads(json.dumps(data['a_data'])) if dicts else data['a']
        b = data['a'] if same else (
            json.loads(json.dumps(data['b_data'])) if dicts else data['b'])
        truth = {'file': data['truth'], 'dict': json.loads(json.dumps(
            data['truth_data'])), None: None}[gt]
        results = m.compare_model_confidence_values(a, b, truth, options)
        grouped = [{k: (x.tolist(), y.tolist()) for k, (x, y) in
                    results.category_to_matched_confidence_values(n)
                    .items()} for n in (None, 3)]
        confs_a = np.concatenate([np.asarray(v[0]) for v in
                                  grouped[0].values()])
        confs_b = np.concatenate([np.asarray(v[1]) for v in
                                  grouped[0].values()])
        quantiles = m.fit_confidence_mapping(confs_a, confs_b, n_bins=10)
        mapped = [m.map_confidence(t, *quantiles) for t in (0.05, 0.3, 0.9)]
        threshold = m.calibrate_threshold(a, b, 0.3, options=options)
        m.plot_matched_confidence_values(
            results, os.path.join(out, 'plots', 'matched.png'), options,
            n_hist_bins=20)
        m.plot_matched_confidence_values(
            results.category_to_matched_confidence_values(),
            os.path.join(out, 'dict.png'))
        return (type(results).__name__, results.calibration_matches,
                results.data_a, results.data_b, grouped,
                [q.tolist() for q in quantiles], mapped, threshold)

    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'cal_' + case, run)
    assert got == want
    wd.assert_same_tree(got_dir, want_dir)
    matches = got[1]
    assert len(matches) > 5
    assert all(len(m) == 6 for m in matches)
    if gt is None:
        assert all(m[5] is None for m in matches)
    else:
        assert {m[5] for m in matches} == {True, False}
    if same:
        assert all(m[0] == m[1] and m[2] == 1.0 for m in matches)
        assert got[7] == pytest.approx(0.3)
    else:
        assert got[7] < 0.3


def test_calibration_degenerate_cases_identical(data, tmp_path):
    """No common match: the threshold comes back unchanged; a figure
    returned without a file renders the same PNG; the match columns."""

    empty = wd.write_json(str(tmp_path / 'empty.json'), {
        'images': [{'file': im['file'], 'detections': []}
                   for im in data['a_data']['images']],
        'detection_categories': data['a_data']['detection_categories'],
        'info': {}})
    pngs = []
    for m in CAL:
        assert m.calibrate_threshold(data['a'], empty, 0.37) == 0.37
        assert m.compare_model_confidence_values(
            data['a'], empty).calibration_matches == []
        assert [int(c) for c in m.CalibrationMatchColumns] == list(range(6))
        fig = m.plot_matched_confidence_values({}, None)
        buffer = io.BytesIO()
        fig.savefig(buffer, format='png')
        pngs.append(buffer.getvalue())
        PLOT[0]._get_plt().close(fig)
    assert pngs[0] == pngs[1]


# %% plot_utils


PLOT_CASES = {
    'precision_recall_curve': lambda m, y, s, out: [
        a.tolist() for a in m.precision_recall_curve(y, s)],
    'average_precision': lambda m, y, s, out: m.average_precision(y, s),
    'plot_precision_recall_curve': lambda m, y, s, out: (
        m.plot_precision_recall_curve(y, s, os.path.join(out, 'pr.png'),
                                      title='PR'),
        m.plot_precision_recall_curve(y, s)),
    'expected_calibration_error': lambda m, y, s, out: (
        m.expected_calibration_error(y, s),
        m.expected_calibration_error(y, s, n_bins=4)),
    'calibration_ece': lambda m, y, s, out: [
        np.asarray(v).tolist() for v in m.calibration_ece(y, s, 7)],
    'plot_calibration_curve': lambda m, y, s, out: (
        m.plot_calibration_curve(y, s, os.path.join(out, 'cal.png'),
                                 n_bins=8, title='Reliability'),
        m.plot_calibration_curve(y, s)),
    'plot_confidence_histogram': lambda m, y, s, out: [
        a.tolist() for a in m.plot_confidence_histogram(
            s, os.path.join(out, 'hist.png'), n_bins=20, title='h')],
    'plot_confusion_matrix': lambda m, y, s, out: [
        _png(m.plot_confusion_matrix(
            np.array([[5, 1, 0], [2, 7, 1], [0, 3, 9]]), ['a', 'b', 'c'],
            **kwargs)) for kwargs in (
                {'normalize': True, 'output_file': os.path.join(
                    out, 'cm.png')},
                {'vmax': 6, 'use_colorbar': False, 'y_label': False,
                 'fmt': '{:.1f}', 'title': 'T'})],
    'plot_stacked_bar_chart': lambda m, y, s, out: [
        _png(m.plot_stacked_bar_chart(
            np.array([[1, 2, 3], [3, 4, 0]]), **kwargs)) for kwargs in (
                {'series_labels': ['s1', 's2'],
                 'col_labels': ['l1', 'l2', 'l3'], 'x_label': 'x',
                 'y_label': 'y', 'log_scale': True,
                 'output_file': os.path.join(out, 'sb.png')},
                {})],
}


def _png(fig):
    """The figure's PNG bytes when it is still open (no output file),
    else its size; then closed."""

    plt = PLOT[0]._get_plt()
    if not plt.fignum_exists(fig.number):
        return fig.get_size_inches().tolist()
    buffer = io.BytesIO()
    fig.savefig(buffer, format='png')
    plt.close(fig)
    return buffer.getvalue()


@pytest.mark.parametrize('name', sorted(PLOT_CASES))
def test_plot_utils_identical(data, name):
    rng = np.random.RandomState(5)
    y = rng.uniform(size=200) < 0.4
    s = np.clip(0.5 * y + rng.uniform(0, 0.6, 200), 0, 1)
    s[:3] = [0.0, 1.0, 1.0]
    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'plot_' + name,
        lambda side, out: PLOT_CASES[name](PLOT[side], y.tolist(),
                                           s.tolist(), out))
    assert got == want
    if os.listdir(want_dir):
        wd.assert_same_tree(got_dir, want_dir)


# %% The CLIs


def _cli_cases(d, out):
    """{case: [argv lists run in turn, printed text compared]}."""

    copy = os.path.join(out, 'images')
    return {
        'add_max_conf': [['add_max_conf', d['a'], out + '/m.json']],
        'convert_output_format': [
            ['convert_output_format', d['a'], out + '/a.csv',
             '--min_confidence', '0.2', '--omit_bounding_boxes'],
            ['convert_output_format', out + '/a.csv', out + '/a.json']],
        'merge_detections': [
            ['merge_detections', d['a'], out + '/m.json', '--source_files',
             d['b'], d['c'], '--source_confidence_thresholds', '0.3',
             '0.5', '--iou_threshold', '0.4'],
            ['merge_detections', d['a'], out + '/m2.json',
             '--source_files', d['b'], '--target_confidence_threshold',
             '0.6']],
        'remap_detection_categories': [
            ['remap_detection_categories', d['a'], out + '/r.json',
             '{"1": "person", "2": "animal", "3": "vehicle"}'],
            ['remap_detection_categories', d['a'], out + '/r2.json',
             d['map'], '--extra_category_handling', 'drop']],
        'categorize_detections_by_size': [
            ['categorize_detections_by_size', d['a'], out + '/c.json',
             '--thresholds', '0.01', '0.05', '--category_names', 'm', 'l',
             '--categories_to_separate', '1', '--merge_source_categories'],
            ['categorize_detections_by_size', d['a'], out + '/c2.json',
             '--thresholds', '0.3', '--measurement', 'width']],
        'md_to_coco': [['md_to_coco', d['a'], out + '/coco.json',
                        '--image_folder', d['images'],
                        '--confidence_threshold', '0.1']],
        'md_to_labelme': [['md_to_labelme', d['a'], copy,
                           '--confidence_threshold', '0.2', '--overwrite']],
        'md_to_wi': [['md_to_wi', d['a'], out + '/wi.json',
                      '--detection_threshold', '0.3']],
        'separate_detections_into_folders': [
            ['separate_detections_into_folders', d['a'], copy,
             out + '/sep', '--animal_threshold', '0.3',
             '--human_threshold', '0.5', '--nthreads', '2',
             '--classification_thresholds', 'deer=0.3,fox=0.4',
             '--render_boxes', '--skip_failures']],
        'top_folders_to_bottom': [
            ['separate_detections_into_folders', d['a'], copy,
             out + '/sep', '--threshold', '0.2', '--move_images',
             '--skip_empty_images', '--nthreads', '1'],
            ['top_folders_to_bottom', out + '/sep', out + '/bottom',
             '--move']],
        'create_crop_folder': [
            ['create_crop_folder', d['a'], d['images'], out + '/crops',
             '--output_file', out + '/t.json', '--crops_output_file',
             out + '/c.json', '--square_crops', '--expansion', '2',
             '--confidence_threshold', '0.3']],
        'detector_calibration': [['detector_calibration', d['a'], d['b'],
                                  '0.3']],
        'render_detection_confusion_matrix': [
            ['render_detection_confusion_matrix', d['a'], d['truth'],
             out + '/cm.html', '--confidence_threshold', '0.3',
             '--iou_threshold', '0.4']],
        'analyze_classification_results': [
            ['analyze_classification_results', d['a'], d['species'],
             out + '/analysis', '--classification_confidence_threshold',
             '0.4']],
    }


CLI_MODULES = {name: 'postprocessing/' + name for name in (
    'add_max_conf', 'convert_output_format', 'merge_detections',
    'remap_detection_categories', 'categorize_detections_by_size',
    'md_to_coco', 'md_to_labelme', 'md_to_wi',
    'separate_detections_into_folders', 'top_folders_to_bottom',
    'create_crop_folder', 'detector_calibration',
    'render_detection_confusion_matrix', 'analyze_classification_results')}


@pytest.fixture(scope='module')
def cli_data(data):
    c = pdata.results_b(data['a_data'], seed=4)
    return dict(data, c=wd.write_json(str(data['root'] / 'c.json'), c),
                map=wd.write_json(str(data['root'] / 'map.json'),
                                  {'1': 'animal', '2': 'person'}))


@pytest.mark.parametrize('case', sorted(CLI_MODULES))
def test_cli_identical(cli_data, case, monkeypatch, capsys):
    """Each CLI through main() on both sides: the files written and the
    text printed (its own folder's path taken out) identical."""

    def run(side, out):
        if case in ('md_to_labelme', 'separate_detections_into_folders',
                    'top_folders_to_bottom'):
            shutil.copytree(cli_data['images'], os.path.join(out, 'images'))
        capsys.readouterr()
        for argv in _cli_cases(cli_data, out)[case]:
            module = _pair(CLI_MODULES[argv[0]])[side]
            monkeypatch.setattr(sys, 'argv', argv)
            module.main()
        return capsys.readouterr().out.replace(out, '<out>')

    (got, got_dir), (want, want_dir) = pdata.both(
        cli_data['root'], 'cli_' + case, run)
    assert got == want
    if case == 'detector_calibration':
        assert 'Model-B threshold equivalent to 0.300' in got
    else:
        wd.assert_same_tree(got_dir, want_dir)


@pytest.mark.parametrize('case', sorted(CLI_MODULES))
def test_cli_help_identical(case, monkeypatch, capsys):
    """No arguments: the same help text, and exit 0."""

    texts = []
    for module in _pair(CLI_MODULES[case]):
        monkeypatch.setattr(sys, 'argv', [case])
        with pytest.raises(SystemExit) as e:
            module.main()
        assert e.value.code == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and texts[0].startswith('usage: ' + case)


@pytest.mark.parametrize('argv, error', [
    (['--threshold', '1.5'], AssertionError),
    (['--threshold', '0.2', '--animal_threshold', '0.2',
      '--human_threshold', '0.2', '--vehicle_threshold', '0.2'],
     ValueError)])
def test_separate_cli_refusals(data, monkeypatch, argv, error):
    for module in _pair('postprocessing/separate_detections_into_folders'):
        monkeypatch.setattr(sys, 'argv', ['sep', data['a'], data['images'],
                                          str(data['root'] / 'never')] +
                            argv)
        with pytest.raises(error):
            module.main()
    assert not os.path.exists(str(data['root'] / 'never'))


# %% Signatures


def _public(path, names=None):
    """{name: signature} of the public functions and classes of [path]
    (a class: its bases and each method's arguments)."""

    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if names is not None and getattr(node, 'name', None) not in names:
            continue
        if isinstance(node, ast.FunctionDef) and \
                not node.name.startswith('_'):
            out[node.name] = ast.unparse(node.args)
        elif isinstance(node, ast.ClassDef) and \
                not node.name.startswith('_'):
            out[node.name] = (
                [ast.unparse(b) for b in node.bases],
                {n.name: ast.unparse(n.args) for n in node.body
                 if isinstance(n, ast.FunctionDef)})
    return out


@pytest.mark.parametrize('module', list(MODULES) + [
    'utils/path_utils:path_is_abs',
    'visualization/visualization_utils:crop_image'])
def test_public_signatures_match(module):
    path, _, name = module.partition(':')
    names = {name} if name else None
    want = _public(os.path.join(REPO, 'megadetector_tpu', path + '.py'),
                   names)
    got = _public(os.path.join(REPO, 'megadetector_tpu_torch',
                               path + '.py'), names)
    assert want and got == want
