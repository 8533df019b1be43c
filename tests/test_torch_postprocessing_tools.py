"""
The port's copies of the detection-postprocessing tools against the JAX
package's, on the same inputs, byte for byte: load_api_results (JSON and
legacy CSV, pandas frames), add_max_conf, convert_output_format,
merge_detections, remap_detection_categories,
categorize_detections_by_size, md_to_coco, md_to_labelme, md_to_wi,
separate_detections_into_folders, top_folders_to_bottom,
render_detection_confusion_matrix and analyze_classification_results,
every options class's branches. Inputs come from
tests/torch_postprocessing_data.py (seeded JPEGs, two models' results, a
COCO ground truth, species labels).
"""

import importlib
import json
import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_postprocessing_data as pdata  # noqa: E402
import torch_workflow_data as wd  # noqa: E402

from megadetector_tpu.utils import ct_utils  # noqa: E402


def _pair(name):
    """(JAX module, the port's module) of postprocessing/[name]."""

    return tuple(importlib.import_module(
        '{}.postprocessing.{}'.format(package, name))
        for package in ('megadetector_tpu', 'megadetector_tpu_torch'))


LOAD = _pair('load_api_results')
ADD_MAX_CONF = _pair('add_max_conf')
CONVERT = _pair('convert_output_format')
MERGE = _pair('merge_detections')
REMAP = _pair('remap_detection_categories')
SIZE = _pair('categorize_detections_by_size')
COCO = _pair('md_to_coco')
LABELME = _pair('md_to_labelme')
WI = _pair('md_to_wi')
SEPARATE = _pair('separate_detections_into_folders')
TOP = _pair('top_folders_to_bottom')
CONFUSION = _pair('render_detection_confusion_matrix')
ANALYSIS = _pair('analyze_classification_results')


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """Seeded JPEGs, model A's and model B's results, a results file with
    other categories, a COCO ground truth and species labels."""

    root = tmp_path_factory.mktemp('pp_tools')
    images = str(root / 'images')
    files = wd.write_images(images)
    sizes = pdata.image_sizes(images, files)
    a = pdata.results_a(files, sizes)
    b = pdata.results_b(a)
    c = pdata.results_b(a, seed=4)
    other = dict(b, detection_categories={'1': 'animal', '2': 'human'})
    truth = pdata.coco_truth(a, sizes)
    paths = {name: wd.write_json(str(root / '{}.json'.format(name)), d)
             for name, d in (('a', a), ('b', b), ('c', c), ('other', other),
                             ('truth', truth),
                             ('species', pdata.class_truth(files)))}
    return dict(paths, root=root, images=images, files=files, sizes=sizes,
                a_data=a, truth_data=truth)


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def _assert_same_file(got, want):
    assert _read(got) == _read(want), (got, want)


# %% load_api_results


LOAD_CASES = {
    'default': {},
    'raw_paths': {'normalize_paths': False, 'force_forward_slashes': False},
    'slashes_only': {'normalize_paths': False},
    'replacements': {'filename_replacements': {'cam_': 'camera_',
                                               '.jpg': '.JPG'}},
}


@pytest.mark.parametrize('case', sorted(LOAD_CASES))
def test_load_and_write_api_results_identical(data, case):
    """The frames (dtypes included) and other fields equal; the rewritten
    file identical with and without max_detection_conf."""

    with open(data['a']) as f:
        a = json.load(f)
    # Windows separators and a dotted path, as files written elsewhere
    a['images'][0]['file'] = a['images'][0]['file'].replace('/', '\\')
    a['images'][1]['file'] = './' + a['images'][1]['file']
    source = wd.write_json(str(data['root'] / 'load_{}.json'.format(case)),
                           a)
    loaded = [m.load_api_results(source, **LOAD_CASES[case]) for m in LOAD]
    pd.testing.assert_frame_equal(loaded[1][0], loaded[0][0])
    assert loaded[1][1] == loaded[0][1]
    for prune in (True, False):
        (got, got_dir), (want, want_dir) = pdata.both(
            data['root'], 'write_{}_{}'.format(case, prune),
            lambda side, out: LOAD[side].write_api_results(
                loaded[side][0], loaded[side][1],
                os.path.join(out, 'rt.json'), prune_max_conf=prune))
        assert got == want
        _assert_same_file(os.path.join(got_dir, 'rt.json'),
                          os.path.join(want_dir, 'rt.json'))


def test_load_md_or_speciesnet_file_identical(data, tmp_path):
    assert LOAD[1].load_md_or_speciesnet_file(data['a'], verbose=True) == \
        LOAD[0].load_md_or_speciesnet_file(data['a'])
    bad = wd.write_json(str(tmp_path / 'bad.json'), {'predictions': []})
    for m in LOAD:
        with pytest.raises(AssertionError):
            m.load_md_or_speciesnet_file(bad)


CSV_CASES = {
    'default': {},
    'raw_paths': {'normalize_paths': False},
    'replacements': {'filename_replacements': {'cam_b': 'CAM_B'},
                     'nrows': 5},
}


@pytest.mark.parametrize('case', sorted(CSV_CASES))
def test_api_results_csv_identical(data, case):
    """The legacy CSV pair: the written file identical, the frames read
    back equal."""

    rng = np.random.RandomState(7)
    a = data['a_data']
    df = pd.DataFrame({
        'image_path': ['./' + im['file'] if i % 4 == 0 else im['file']
                       for i, im in enumerate(a['images'])],
        'max_confidence': [ct_utils.get_max_conf(im) for im in a['images']],
        'detections': [im['detections'] or [] for im in a['images']],
        'extra': rng.randint(0, 9, len(a['images'])),
    })
    (_, got_dir), (_, want_dir) = pdata.both(
        data['root'], 'csv_' + case,
        lambda side, out: LOAD[side].write_api_results_csv(
            df, os.path.join(out, 'sub', 'r.csv')))
    got_csv = os.path.join(got_dir, 'sub', 'r.csv')
    _assert_same_file(got_csv, os.path.join(want_dir, 'sub', 'r.csv'))
    frames = [m.load_api_results_csv(got_csv, **CSV_CASES[case])
              for m in LOAD]
    pd.testing.assert_frame_equal(frames[1], frames[0])


# %% add_max_conf, convert_output_format


@pytest.mark.parametrize('write', [True, False])
def test_add_max_conf_identical(data, write):
    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'max_conf_{}'.format(write),
        lambda side, out: ADD_MAX_CONF[side].add_max_conf(
            data['a'], os.path.join(out, 'm.json') if write else None))
    assert got == want
    assert all('max_detection_conf' in im for im in got['images'])
    if write:
        _assert_same_file(os.path.join(got_dir, 'm.json'),
                          os.path.join(want_dir, 'm.json'))


JSON_TO_CSV_CASES = {
    'default_path': {},
    'min_confidence': {'min_confidence': 0.3},
    'no_boxes': {'omit_bounding_boxes': True, 'min_confidence': 0.1},
}


@pytest.mark.parametrize('case', sorted(JSON_TO_CSV_CASES))
def test_convert_output_format_identical(data, case):
    """JSON -> CSV (the default path beside the input, or a given one),
    then CSV -> JSON; both files identical, and without a filter the
    round trip gives back A's detections exactly."""

    kwargs = JSON_TO_CSV_CASES[case]

    def run(side, out):
        source = os.path.join(out, 'a.json')
        shutil.copyfile(data['a'], source)
        target = None if case == 'default_path' else \
            os.path.join(out, 'out.csv')
        csv_path = CONVERT[side].convert_json_to_csv(source, target,
                                                     **kwargs)
        json_path = CONVERT[side].convert_csv_to_json(
            csv_path, None if case == 'default_path' else
            os.path.join(out, 'rt.json'),
            **({} if case == 'default_path' else {'detector_name': 'B'}))
        return os.path.relpath(csv_path, out), \
            os.path.relpath(json_path, out)

    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'convert_' + case, run)
    assert got == want
    for rel in got:
        _assert_same_file(os.path.join(got_dir, rel),
                          os.path.join(want_dir, rel))
    if case == 'default_path':
        with open(os.path.join(got_dir, got[1])) as f:
            rt = json.load(f)
        assert [im['detections'] for im in rt['images']] == \
            [im['detections'] for im in data['a_data']['images']]


def test_convert_output_format_refuses_other_suffixes(data, monkeypatch):
    for m in CONVERT:
        monkeypatch.setattr(sys, 'argv', ['convert', 'x.txt'])
        with pytest.raises(ValueError):
            m.main()


# %% merge_detections


MERGE_CASES = {
    'default': (None, 'b'),
    'thresholds': ({'source_confidence_thresholds': [0.5],
                    'iou_threshold': 0.3}, ['b']),
    'empty_only': ({'merge_empty_only': True,
                    'target_confidence_threshold': 0.5}, ['b']),
    'categories': ({'categories_to_include': ['2', '3']}, ['b']),
    'sizes': ({'min_detection_size': 0.01, 'max_detection_size': 0.1},
              ['b']),
    'two_sources': ({'source_confidence_thresholds': [0.2, 0.4]},
                    ['b', 'c']),
}


@pytest.mark.parametrize('case', sorted(MERGE_CASES))
@pytest.mark.parametrize('write', [True, False])
def test_merge_detections_identical(data, case, write):
    settings, sources = MERGE_CASES[case]
    sources = data[sources] if isinstance(sources, str) else \
        [data[s] for s in sources]

    def run(side, out):
        options = None
        if settings is not None:
            options = MERGE[side].MergeDetectionsOptions()
            options.__dict__.update(settings)
        return MERGE[side].merge_detections(
            sources, data['a'],
            os.path.join(out, 'merged.json') if write else None, options)

    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'merge_{}_{}'.format(case, write), run)
    assert got == want
    if write:
        _assert_same_file(os.path.join(got_dir, 'merged.json'),
                          os.path.join(want_dir, 'merged.json'))
    # A's own detections stay first and unchanged in every image, B's
    # (and C's) follow
    transferred = 0
    for im, im_a in zip(got['images'], data['a_data']['images']):
        n = len(im_a['detections'] or [])
        assert (im['detections'] or [])[:n] == (im_a['detections'] or [])
        transferred += len(im['detections'] or []) - n
    assert transferred > 0


def test_merge_detections_refuses_other_categories(data):
    for m in MERGE:
        with pytest.raises(AssertionError):
            m.merge_detections(data['other'], data['a'], None)
        options = m.MergeDetectionsOptions()
        with pytest.raises(AssertionError):
            m.merge_detections([data['b'], data['c']], data['a'], None,
                               options)


# %% remap_detection_categories, categorize_detections_by_size


REMAP_CASES = {
    'permuted': ({'1': 'person', '2': 'animal', '3': 'vehicle'}, 'error'),
    'drop': ({'1': 'animal', '2': 'person'}, 'drop'),
    'keep': ({'5': 'animal', '7': 'person'}, 'keep'),
    'keep_two': ({'4': 'vehicle'}, 'keep'),
}


@pytest.mark.parametrize('case', sorted(REMAP_CASES))
def test_remap_detection_categories_identical(data, case):
    target, handling = REMAP_CASES[case]
    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'remap_' + case,
        lambda side, out: REMAP[side].remap_detection_categories(
            data['a'], os.path.join(out, 'r.json'), dict(target),
            extra_category_handling=handling))
    assert got == want
    _assert_same_file(os.path.join(got_dir, 'r.json'),
                      os.path.join(want_dir, 'r.json'))


def test_remap_detection_categories_refusals(data, tmp_path):
    existing = str(tmp_path / 'exists.json')
    shutil.copyfile(data['a'], existing)
    for m in REMAP:
        with pytest.raises(ValueError):
            m.remap_detection_categories(data['a'], None, {'1': 'animal'})
        with pytest.raises(AssertionError):
            m.remap_detection_categories(data['a'], None, {},
                                         extra_category_handling='skip')
        with pytest.raises(AssertionError):
            m.remap_detection_categories(
                data['a'], existing,
                {'1': 'animal', '2': 'person', '3': 'vehicle'},
                overwrite=False)


SIZE_CASES = {
    'default': None,
    'width': {'measurement': 'width', 'size_thresholds': [0.3]},
    'height_animals': {'measurement': 'height', 'size_thresholds': [0.25],
                       'categories_to_separate': ['1']},
    'two_thresholds': {'size_thresholds': [0.01, 0.05],
                       'size_category_names': ['medium', 'large']},
    'merged': {'size_thresholds': [0.05, 0.01],
               'size_category_names': ['large', 'medium'],
               'separate_unique_categories': False},
    'upper_bounds': {'size_thresholds': [0.002, 0.02],
                     'size_category_names': ['tiny', 'small'],
                     'default_category_is_smallest': False},
}


@pytest.mark.parametrize('case', sorted(SIZE_CASES))
def test_categorize_detections_by_size_identical(data, case):
    settings = SIZE_CASES[case]

    def run(side, out):
        options = None
        if settings is not None:
            options = SIZE[side].SizeCategorizationOptions()
            options.__dict__.update(settings)
        return SIZE[side].categorize_detections_by_size(
            data['a'], os.path.join(out, 's.json'), options)

    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'size_' + case, run)
    assert got == want
    _assert_same_file(os.path.join(got_dir, 's.json'),
                      os.path.join(want_dir, 's.json'))
    if settings is not None:
        assert len(got['detection_categories']) > 3


def test_categorize_detections_by_size_refusals(data):
    for m in SIZE:
        options = m.SizeCategorizationOptions()
        options.size_thresholds = [0.1, 0.2]
        with pytest.raises(AssertionError):
            m.categorize_detections_by_size(data['a'], None, options)
        options = m.SizeCategorizationOptions()
        options.measurement = 'area'
        with pytest.raises(ValueError):
            m.categorize_detections_by_size(data['a'], None, options)


# %% md_to_coco, md_to_labelme, md_to_wi


COCO_CASES = {
    'folder': {'image_folder': True, 'confidence_threshold': 0.1},
    'stored_sizes': {},
    'validate': {'image_folder': True, 'validate_image_sizes': True,
                 'wrong_sizes': True},
    'failed_plain': {'include_failed_images': True,
                     'preserve_nonstandard_metadata': False,
                     'image_folder': True},
    'write_none': {'write': False, 'confidence_threshold': 0.5},
}


@pytest.mark.parametrize('case', sorted(COCO_CASES))
def test_md_to_coco_identical(data, case, capsys):
    settings = dict(COCO_CASES[case])
    source = data['a']
    if settings.pop('wrong_sizes', False):
        a = json.loads(json.dumps(data['a_data']))
        a['images'][0]['width'] += 7
        source = wd.write_json(str(data['root'] / 'wrong_sizes.json'), a)
    if settings.pop('image_folder', False):
        settings['image_folder'] = data['images']
    write = settings.pop('write', True)
    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'coco_' + case,
        lambda side, out: COCO[side].md_to_coco(
            source, os.path.join(out, 'coco.json') if write else None,
            **settings))
    assert got == want
    if write:
        _assert_same_file(os.path.join(got_dir, 'coco.json'),
                          os.path.join(want_dir, 'coco.json'))
    out = capsys.readouterr().out
    if case == 'validate':
        assert out.count('size mismatch') == 2


LABELME_CASES = {
    'default': {},
    'threshold_prefix': {'confidence_threshold': 0.3,
                         'extension_prefix': '.md'},
    'keep_existing': {'existing': True},
    'overwrite_verbose': {'existing': True, 'overwrite': True,
                          'verbose': True},
}


@pytest.mark.parametrize('case', sorted(LABELME_CASES))
def test_md_to_labelme_identical(data, case):
    """One labelme file beside each image (a copy of the folder a side),
    the list of files written the same relative to each copy."""

    settings = dict(LABELME_CASES[case])
    existing = settings.pop('existing', False)

    def run(side, out):
        folder = os.path.join(out, 'images')
        shutil.copytree(data['images'], folder)
        if existing:
            with open(os.path.join(folder, 'cam_a', 'img_01.json'),
                      'w') as f:
                f.write('{}')
        written = LABELME[side].md_to_labelme(data['a'], folder, **settings)
        return [os.path.relpath(p, folder) for p in written]

    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'labelme_' + case, run)
    assert got == want and len(got) > 0
    wd.assert_same_tree(got_dir, want_dir)


WI_CASES = {
    'default': {},
    'taxonomy': {'classification_threshold': 0.3,
                 'classification_name_to_wi_taxonomy': {
                     'deer': 'uuid;mammalia;cetartiodactyla;cervidae;;;deer',
                     'fox': 'uuid2;mammalia;carnivora;canidae;;;fox'}},
    'strict': {'detection_threshold': 0.6},
}


@pytest.mark.parametrize('case', sorted(WI_CASES))
def test_md_to_wi_identical(data, case):
    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'wi_' + case,
        lambda side, out: WI[side].md_to_wi(
            data['a'], os.path.join(out, 'wi.json'), **WI_CASES[case]))
    assert got == want
    _assert_same_file(os.path.join(got_dir, 'wi.json'),
                      os.path.join(want_dir, 'wi.json'))
    assert len(got['predictions']) == len(data['a_data']['images'])


# %% separate_detections_into_folders, top_folders_to_bottom


SEPARATE_CASES = {
    'threads': {'threshold': 0.2},
    'serial_metadata_threshold': {'n_threads': 1},
    'per_category': {'threshold': 0.3, 'category_name_to_threshold': {
        'person': 0.5, 'vehicle': 0.1}},
    'render': {'threshold': 0.25, 'render_boxes': True,
               'line_thickness': 2, 'box_expansion': 3},
    'move_skip_empty': {'threshold': 0.2, 'move_images': True,
                        'skip_empty_images': True},
    'move_render': {'threshold': 0.2, 'move_images': True,
                    'render_boxes': True},
    'skip_failures': {'threshold': 0.2, 'skip_failures': True},
    'classes': {'threshold': 0.2, 'classification_thresholds': {
        'deer': 0.3, 'fox': 0.3}},
    'keep_existing': {'threshold': 0.2, 'overwrite': False,
                      'existing': True},
}


def _separate(side, data, out, settings):
    """Run one side's separate_detections_into_folders on a copy of the
    image folder; returns its mapping relative to [out]."""

    settings = dict(settings)
    existing = settings.pop('existing', False)
    m = SEPARATE[side]
    source = os.path.join(out, 'input')
    shutil.copytree(data['images'], source)
    options = m.SeparateDetectionsIntoFoldersOptions()
    options.results_file = data['a']
    options.base_input_folder = source
    options.base_output_folder = os.path.join(out, 'separated')
    options.__dict__.update(settings)
    if existing:
        target = os.path.join(options.base_output_folder, 'empty', 'cam_a',
                              'img_00.jpg')
        os.makedirs(os.path.dirname(target))
        with open(target, 'wb') as f:
            f.write(b'kept')
    return pdata.relative(m.separate_detections_into_folders(options), out)


@pytest.mark.parametrize('case', sorted(SEPARATE_CASES))
def test_separate_detections_into_folders_identical(data, case, capsys):
    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'separate_' + case,
        lambda side, out: _separate(side, data, out, SEPARATE_CASES[case]))
    assert got == want
    wd.assert_same_tree(got_dir, want_dir)
    # Every image written lands in one folder (the video is missing), and
    # nothing else is written but the file that was already there
    written = set(wd.tree(os.path.join(got_dir, 'separated')))
    targets = {os.path.relpath(v, 'separated') for k, v in got.items()
               if k != 'cam_c/clip.mp4'}
    assert len(targets) == len(got) - 1
    assert targets <= written <= targets | {'empty/cam_a/img_00.jpg'}
    assert 'not found' in capsys.readouterr().out


def test_separate_detections_into_folders_refusals(data, tmp_path):
    a = json.loads(json.dumps(data['a_data']))
    a['images'].append({'file': '/abs/x.jpg', 'detections': []})
    absolute = wd.write_json(str(tmp_path / 'abs.json'), a)
    for side, m in enumerate(SEPARATE):
        options = m.SeparateDetectionsIntoFoldersOptions(threshold=0.2)
        options.results_file = data['a']
        options.base_input_folder = data['images']
        options.base_output_folder = str(tmp_path / 'missing{}'.format(side))
        options.allow_missing_files = False
        with pytest.raises(FileNotFoundError):
            m.separate_detections_into_folders(options)
        options.results_file = absolute
        options.base_output_folder = str(tmp_path / 'abs{}'.format(side))
        with pytest.raises(AssertionError):
            m.separate_detections_into_folders(options)


TOP_CASES = {
    'copy': {},
    'move': {'copy_or_move': 'move'},
    'root_files': {'include_root_files': True},
}


@pytest.mark.parametrize('case', sorted(TOP_CASES))
def test_top_folders_to_bottom_identical(data, case):
    def run(side, out):
        _separate(side, data, out, {'threshold': 0.2})
        separated = os.path.join(out, 'separated')
        with open(os.path.join(separated, 'readme.txt'), 'w') as f:
            f.write('root file')
        options = TOP[side].TopFoldersToBottomOptions(
            separated, os.path.join(out, 'by_camera'))
        options.__dict__.update(TOP_CASES[case])
        return TOP[side].top_folders_to_bottom(options)

    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'top_' + case, run)
    assert got == want
    for rel, remapped in got.items():
        parts = rel.split('/')
        assert remapped == rel if len(parts) == 1 else \
            remapped == '/'.join(parts[1:-1] + [parts[0], parts[-1]])
    assert ('readme.txt' in got) == (case == 'root_files')
    wd.assert_same_tree(got_dir, want_dir)


def test_top_folders_to_bottom_refusals(tmp_path):
    for m in TOP:
        options = m.TopFoldersToBottomOptions(str(tmp_path),
                                              str(tmp_path / '.'))
        with pytest.raises(AssertionError):
            m.top_folders_to_bottom(options)
        options = m.TopFoldersToBottomOptions(str(tmp_path),
                                              str(tmp_path / 'x'))
        options.copy_or_move = 'link'
        with pytest.raises(AssertionError):
            m.top_folders_to_bottom(options)


# %% render_detection_confusion_matrix, analyze_classification_results


CONFUSION_CASES = {
    'coco_file': {},
    'coco_dict': {'dict': True, 'confidence_threshold': 0.5,
                  'iou_threshold': 0.3},
    'labelme': {'labelme': True},
    'mapping': {'category_mapping': {'animal': 'deer', 'person': 'human'}},
    'no_file': {'write': False, 'results': 'b'},
}


@pytest.mark.parametrize('case', sorted(CONFUSION_CASES))
def test_render_detection_confusion_matrix_identical(data, case):
    settings = dict(CONFUSION_CASES[case])
    results = data[settings.pop('results', 'a')]
    write = settings.pop('write', True)
    truth = data['truth']
    if settings.pop('dict', False):
        truth = data['truth_data']
    if settings.pop('labelme', False):
        # Labelme files of A's detections above 0.4, written by the JAX
        # module beside a copy of the images
        truth = str(data['root'] / 'labelme_truth')
        if not os.path.isdir(truth):
            shutil.copytree(data['images'], truth)
            LABELME[0].md_to_labelme(data['a'], truth,
                                     confidence_threshold=0.4)

    def run(side, out):
        return CONFUSION[side].render_detection_confusion_matrix(
            results, json.loads(json.dumps(truth))
            if isinstance(truth, dict) else truth,
            os.path.join(out, 'cm.html') if write else None, **settings)

    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'confusion_' + case, run)
    assert got == want and got['per_category']
    if write:
        _assert_same_file(os.path.join(got_dir, 'cm.html'),
                          os.path.join(want_dir, 'cm.html'))


ANALYSIS_CASES = {
    'dicts': {'dicts': True},
    'files': {},
    'image_base': {'image_base_dir': 'images', 'max_mispredictions_per_cell':
                   2},
    'thresholds': {'classification_confidence_threshold': 0.3,
                   'detection_confidence_threshold': 0.5,
                   'empty_category_names': ('empty',)},
    'no_output': {'no_output': True},
}


@pytest.mark.parametrize('case', sorted(ANALYSIS_CASES))
def test_analyze_classification_results_identical(data, case):
    """The results (a dict with the reference's attributes) and the HTML
    report; then the deep-dive pages of every misprediction cell."""

    settings = dict(ANALYSIS_CASES[case])
    dicts = settings.pop('dicts', False)
    no_output = settings.pop('no_output', False)

    def run(side, out):
        m = ANALYSIS[side]
        options = m.ClassificationAnalysisOptions()
        options.md_results_file = json.loads(json.dumps(data['a_data'])) \
            if dicts else data['a']
        with open(data['species']) as f:
            options.ground_truth = json.load(f) if dicts \
                else data['species']
        options.output_dir = None if no_output else \
            os.path.join(out, 'analysis')
        options.__dict__.update(settings)
        results = m.analyze_classification_results(options)
        attributes = {
            name: getattr(results, name) for name in (
                'per_category_results', 'active_categories', 'accuracy',
                'macro_f1', 'micro_f1', 'micro_precision', 'micro_recall',
                'html_output_file')}
        attributes['confusion_matrix_array'] = \
            results.confusion_matrix_array.tolist()
        pages = {}
        if not no_output:
            cells = [tuple(k.split('|')) for k in results['mispredictions']]
            pages = m.render_misprediction_pages(options, cells,
                                                 max_images_per_cell=3)
        return pdata.relative((type(results).__name__, dict(results),
                               attributes, pages), out)

    (got, got_dir), (want, want_dir) = pdata.both(
        data['root'], 'analysis_' + case, run)
    assert got == want
    assert got[1]['n_images_evaluated'] == len(data['files'])
    if not no_output:
        assert got[3]
        wd.assert_same_tree(got_dir, want_dir)
