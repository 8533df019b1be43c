"""
The port's copies of the COCO Camera Traps database tools against the
JAX package's, on the same inputs, byte for byte: annotation_constants,
integrity_check_json_db (every option, its refusals, the CLI),
add_width_and_height_to_db (threads, a missing file, overwrite),
subset_json_db and sample_json_db (queries, case, list files, caps and
seeds), coco_tools (remap, threshold, combine, sizes, resize and its
CLI) and cct_to_md. Inputs come from tests/torch_cct_data.py.
"""

import copy
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_cct_data as cd  # noqa: E402

CONSTANTS = cd.pair('data_management.annotation_constants')
INTEGRITY = cd.pair('data_management.integrity_check_json_db')
SIZES = cd.pair('data_management.add_width_and_height_to_db')
SUBSET = cd.pair('data_management.subset_json_db')
COCO = cd.pair('data_management.coco_tools')
CCT_TO_MD = cd.pair('data_management.cct_to_md')


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp('cct_world')
    folder, db = cd.cct_world(root)
    sized = cd.with_sizes(db, folder)
    paths = {}
    for name, data in (('db', db), ('sized', sized)):
        paths[name + '_file'] = str(root / '{}.json'.format(name))
        with open(paths[name + '_file'], 'w') as f:
            json.dump(data, f, indent=1)
    return dict(paths, root=root, folder=folder, db=db, sized_db=sized)


def test_annotation_constants_identical():
    ref, ours = CONSTANTS
    names = [n for n in dir(ref) if not n.startswith('_')]
    assert names == [n for n in dir(ours) if not n.startswith('_')]
    for name in names:
        assert getattr(ours, name) == getattr(ref, name), name


INTEGRITY_CASES = {
    'default': {},
    'image_checks': {'bCheckImageSizes': True, 'bCheckImageExistence': True},
    'unused_and_location': {'bFindUnusedImages': True,
                            'bRequireLocation': True},
    'max_images': {'iMaxNumImages': 5, 'bFindUnusedImages': True},
    'quiet': {'verbose': False},
}


@pytest.mark.parametrize('case', sorted(INTEGRITY_CASES))
@pytest.mark.parametrize('source', ['db', 'sized'])
def test_integrity_check_identical(world, case, source, capsys):
    outs = []
    for module in INTEGRITY:
        options = module.IntegrityCheckOptions()
        options.baseDir = world['folder']
        for k, v in INTEGRITY_CASES[case].items():
            setattr(options, k, v)
        outs.append(module.integrity_check_json_db(world[source + '_file'],
                                                    options)
                    + (capsys.readouterr().out,))
    assert outs[1] == outs[0]
    if case == 'image_checks':
        # the missing image, and its size unread
        assert len(outs[1][2]['validation_errors']) == 2


def _broken(kind):
    _, db = cd.cct_world('/nonexistent', n=4)
    if kind == 'category':
        db['annotations'][0]['category_id'] = 99
    elif kind == 'image':
        db['annotations'][0]['image_id'] = 'nowhere'
    elif kind == 'duplicate_image':
        db['images'][1]['id'] = db['images'][0]['id']
    elif kind == 'duplicate_annotation':
        db['annotations'][1]['id'] = db['annotations'][0]['id']
    elif kind == 'duplicate_category':
        db['categories'][1]['id'] = 0
    elif kind == 'field':
        del db['categories']
    elif kind == 'location':
        del db['images'][2]['location']
    elif kind == 'bbox':
        db['annotations'][0]['bbox'] = [1, 2, 3]
    return db


@pytest.mark.parametrize('kind', [
    'category', 'image', 'duplicate_image', 'duplicate_annotation',
    'duplicate_category', 'field', 'location', 'bbox'])
def test_integrity_check_refusals_identical(kind):
    messages = []
    for module in INTEGRITY:
        options = module.IntegrityCheckOptions()
        options.bRequireLocation = True
        with pytest.raises(AssertionError) as info:
            module.integrity_check_json_db(_broken(kind), options)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


def test_integrity_check_negative_box_and_cli_identical(world, monkeypatch,
                                                        capsys):
    db = copy.deepcopy(world['sized_db'])
    db['annotations'][1]['bbox'][2] = -1.0
    outs = [m.integrity_check_json_db(db, m.IntegrityCheckOptions())[2]
            for m in INTEGRITY]
    assert outs[1] == outs[0] and len(outs[0]['validation_errors']) == 1
    capsys.readouterr()
    printed = []
    for module in INTEGRITY:
        monkeypatch.setattr(sys, 'argv', [
            'integrity_check_json_db', world['sized_file'], '--baseDir',
            world['folder'], '--bCheckImageSizes', '--bFindUnusedImages'])
        module.main()
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0] and '1 errors' in printed[0]


@pytest.mark.parametrize('n_workers,overwrite,start', [
    (1, False, 'db'), (4, False, 'db'), (4, False, 'sized'),
    (2, True, 'sized')])
def test_add_width_and_height_identical(world, tmp_path, n_workers,
                                        overwrite, start):
    def run(side, out):
        db = copy.deepcopy(world['db'] if start == 'db' else
                           world['sized_db'])
        if start == 'sized':
            db['images'][0]['width'] = 1
        return SIZES[side].add_width_and_height_to_db(
            db, world['folder'], os.path.join(out, 'sized.json'),
            n_workers=n_workers, overwrite_existing=overwrite)

    (ours, got), (ref, want) = cd.both(tmp_path, 'sizes', run)
    assert ours == ref
    cd.assert_same_tree(got, want)
    sizes = {im['file_name']: (im.get('width'), im.get('height'))
             for im in cd.with_sizes(world['db'], world['folder'])['images']}
    for im in ours['images']:
        if 'error' in im:
            assert im['file_name'] == world['db']['images'][-1]['file_name']
        elif not (start == 'sized' and im is ours['images'][0] and
                  not overwrite):
            assert (im['width'], im['height']) == sizes[im['file_name']]


def test_add_width_and_height_cli_identical(world, tmp_path, monkeypatch):
    def run(side, out):
        monkeypatch.setattr(sys, 'argv', [
            'add_width_and_height_to_db', world['db_file'], world['folder'],
            os.path.join(out, 'out.json')])
        SIZES[side].main()

    (_, got), (_, want) = cd.both(tmp_path, 'cli', run)
    cd.assert_same_tree(got, want)


SAMPLE_CASES = {
    'default_cap': ({'default': 2}, 0),
    'per_category': ({'default': -1, 'deer': 1, 'no_annotations': 0}, 3),
    'seed_7': ({'default': 3, 'fox': 1}, 7),
    'no_cap': ({'default': -1}, 0),
}


@pytest.mark.parametrize('case', sorted(SAMPLE_CASES))
def test_sample_json_db_identical(world, tmp_path, case, capsys):
    caps, seed = SAMPLE_CASES[case]

    def run(side, out):
        options = SUBSET[side].DbSamplingOptions()
        options.category_name_to_max_count = dict(caps)
        options.random_seed = seed
        value = SUBSET[side].sample_json_db(
            copy.deepcopy(world['db']), options,
            os.path.join(out, 'sample.json'), verbose=True)
        return value, capsys.readouterr().out

    (ours, got), (ref, want) = cd.both(tmp_path, 'sample', run)
    assert ours == ref
    cd.assert_same_tree(got, want)
    # a path in: the file read, the same sample
    from_file = []
    for module in SUBSET:
        options = module.DbSamplingOptions()
        options.category_name_to_max_count = dict(caps)
        options.random_seed = seed
        from_file.append(module.sample_json_db(world['db_file'], options))
    assert from_file[1] == from_file[0] == ours[0]


SUBSET_CASES = {
    'camera': ('cam0/', False),
    'case': ('CAM1/LOC0', True),
    'case_sensitive_miss': ('CAM1/LOC0', False),
    'list': (['loc1/img_0', 'cam0/loc0'], False),
    'list_file': ('LIST', False),
}


@pytest.mark.parametrize('case', sorted(SUBSET_CASES))
def test_subset_json_db_identical(world, tmp_path, case):
    query, ignore_case = SUBSET_CASES[case]
    if query == 'LIST':
        query = str(tmp_path / 'files.json')
        with open(query, 'w') as f:
            json.dump([im['file_name'] for im in world['db']['images'][::3]],
                      f)

    def run(side, out):
        return SUBSET[side].subset_json_db(
            world['db'], query, os.path.join(out, 'subset.json'),
            ignore_case=ignore_case)

    (ours, got), (ref, want) = cd.both(tmp_path, 'subset', run)
    assert ours == ref
    cd.assert_same_tree(got, want)
    assert (len(ours['images']) == 0) == (case == 'case_sensitive_miss')


def test_subset_json_db_cli_identical(world, tmp_path, monkeypatch):
    def run(side, out):
        monkeypatch.setattr(sys, 'argv', [
            'subset_json_db', world['db_file'], os.path.join(out, 'o.json'),
            'LOC1', '--ignore_case'])
        SUBSET[side].main()

    (_, got), (_, want) = cd.both(tmp_path, 'cli', run)
    cd.assert_same_tree(got, want)


REMAP_CASES = {
    'all': ({'animal': 1, 'nothing': 0},
            {'deer': 'animal', 'fox': 'animal', 'Elk': 'animal',
             'empty': 'nothing'}, False),
    'unused_dropped': ({'deer': 3, 'fox': 4}, {'deer': 'deer', 'fox': 'fox'},
                       True),
}


@pytest.mark.parametrize('case', sorted(REMAP_CASES))
def test_remap_coco_categories_identical(world, tmp_path, case):
    out_ids, mapping, allow = REMAP_CASES[case]

    def run(side, out):
        return COCO[side].remap_coco_categories(
            world['sized_file'], out_ids, mapping, os.path.join(out, 'r.json'),
            allow_unused_categories=allow)

    (ours, got), (ref, want) = cd.both(tmp_path, 'remap', run)
    assert ours == ref
    cd.assert_same_tree(got, want)


@pytest.mark.parametrize('mapping,error', [
    ({'deer': 'animal'}, ValueError),
    ({'deer': 'x', 'fox': 'x', 'Elk': 'x', 'empty': 'y'}, AssertionError)])
def test_remap_coco_categories_refusals_identical(world, mapping, error):
    messages = []
    for module in COCO:
        with pytest.raises(error) as info:
            module.remap_coco_categories(world['db'], {'animal': 1, 'x': 2},
                                         mapping)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


def _scored(db):
    db = copy.deepcopy(db)
    for i, ann in enumerate(db['annotations']):
        if i % 6 != 5:
            ann['score'] = round(0.07 * i, 3)
    return db


@pytest.mark.parametrize('handling,threshold', [
    ('warning', 0.3), ('warning', 0.0)])
def test_threshold_coco_dataset_identical(world, tmp_path, handling,
                                          threshold, capsys):
    def run(side, out):
        value = COCO[side].threshold_coco_dataset(
            _scored(world['db']), threshold, os.path.join(out, 't.json'),
            missing_confidence_handling=handling)
        return value, capsys.readouterr().out

    (ours, got), (ref, want) = cd.both(tmp_path, 'threshold', run)
    assert ours == ref
    cd.assert_same_tree(got, want)
    messages = []
    for module in COCO:
        with pytest.raises(ValueError) as info:
            module.threshold_coco_dataset(_scored(world['db']), threshold)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


@pytest.mark.parametrize('prefixes', [False, True])
def test_combine_cct_files_identical(world, tmp_path, prefixes):
    parts = []
    for camera in ('cam0/', 'cam1/'):
        path = str(tmp_path / '{}.json'.format(camera[:-1]))
        SUBSET[0].subset_json_db(world['sized_file'], camera, path)
        parts.append(path)

    def run(side, out):
        return COCO[side].combine_cct_files(
            parts, os.path.join(out, 'combined.json'),
            filename_prefixes={parts[0]: 'a/', parts[1]: 'b/'}
            if prefixes else None)

    (ours, got), (ref, want) = cd.both(tmp_path, 'combine', run)
    assert ours == ref
    cd.assert_same_tree(got, want)
    assert sorted(im['id'] for im in ours['images']) == \
        sorted(im['id'] for im in world['sized_db']['images'])
    assert len(ours['annotations']) == len(world['db']['annotations'])


def test_combine_cct_dictionaries_ids_and_refusal_identical(world):
    a = SUBSET[0].subset_json_db(world['db'], 'cam0/')
    b = copy.deepcopy(a)
    for im in b['images']:
        im['file_name'] = 'other/' + im['file_name']
    b['categories'] = [dict(c, id=c['id'] + 10) for c in b['categories']]
    for ann in b['annotations']:
        ann['category_id'] += 10
    outs = [m.combine_cct_dictionaries([a, b]) for m in COCO]
    assert outs[1] == outs[0]
    assert len({im['id'] for im in outs[0]['images']}) == \
        2 * len(a['images'])
    messages = []
    for module in COCO:
        with pytest.raises(AssertionError) as info:
            module.combine_cct_dictionaries([a, a])
        messages.append(str(info.value))
    assert messages[1] == messages[0]
    assert COCO[1].combine_cct_dictionaries(
        [a, a], require_uniqueness=False) == \
        COCO[0].combine_cct_dictionaries([a, a], require_uniqueness=False)


@pytest.mark.parametrize('n_workers', [1, 3])
def test_get_image_sizes_identical(world, tmp_path, n_workers):
    files = [im['file_name'] for im in world['db']['images']]

    def run(side, out):
        return COCO[side].get_image_sizes(
            files, world['folder'], os.path.join(out, 'sizes.json'),
            n_workers=n_workers)

    (ours, got), (ref, want) = cd.both(tmp_path, 'sizes', run)
    assert ours == ref and list(ours) == files
    cd.assert_same_tree(got, want)


@pytest.mark.parametrize('target,handling', [
    ((32, -1), 'copy'), ((-1, 30), 'copy'), ((-1, -1), 'link'),
    ((40, 40), 'copy')])
def test_resize_coco_dataset_identical(world, tmp_path, target, handling):
    present = copy.deepcopy(world['sized_db'])
    present['images'] = present['images'][:-1]

    def run(side, out):
        return COCO[side].resize_coco_dataset(
            world['folder'], present, os.path.join(out, 'images'),
            os.path.join(out, 'resized.json'), target_size=target,
            correct_size_image_handling=handling)

    (ours, got), (ref, want) = cd.both(tmp_path, 'resize', run)
    assert ours == ref
    cd.assert_same_tree(got, want)


COCO_CLI = {
    'threshold': lambda w, out: ['threshold', w['scored'],
                                 os.path.join(out, 't.json'),
                                 '--confidence_threshold', '0.2',
                                 '--missing_confidence_handling', 'warning'],
    'combine': lambda w, out: ['combine', w['sized_file'], w['scored'],
                               '--output_file', os.path.join(out, 'c.json'),
                               '--no_require_uniqueness'],
    'sizes': lambda w, out: ['sizes', w['folder'],
                             os.path.join(out, 's.json'), '--n_workers', '2'],
    'resize': lambda w, out: ['resize', w['folder'], w['present'],
                              os.path.join(out, 'im'),
                              os.path.join(out, 'r.json'), '--width', '24'],
}


@pytest.mark.parametrize('command', sorted(COCO_CLI))
def test_coco_tools_cli_identical(world, tmp_path, monkeypatch, command,
                                  capsys):
    inputs = dict(world)
    inputs['scored'] = str(tmp_path / 'scored.json')
    with open(inputs['scored'], 'w') as f:
        json.dump(_scored(world['sized_db']), f)
    present = copy.deepcopy(world['sized_db'])
    present['images'] = present['images'][:-1]
    inputs['present'] = str(tmp_path / 'present.json')
    with open(inputs['present'], 'w') as f:
        json.dump(present, f)

    def run(side, out):
        monkeypatch.setattr(sys, 'argv', ['coco_tools'] +
                            COCO_CLI[command](inputs, out))
        COCO[side].main()
        return capsys.readouterr().out

    (ours, got), (ref, want) = cd.both(tmp_path, 'cli', run)
    assert ours == ref
    cd.assert_same_tree(got, want)


@pytest.mark.parametrize('source', ['sized', 'db', 'dict'])
def test_cct_to_md_identical(world, tmp_path, source):
    def run(side, out):
        data = world['sized_db'] if source == 'dict' else \
            world[source + '_file']
        return CCT_TO_MD[side].cct_to_md(data, os.path.join(out, 'md.json'))

    (ours, got), (ref, want) = cd.both(tmp_path, 'md', run)
    assert ours == ref
    cd.assert_same_tree(got, want)
    n_boxes = sum(len(im['detections']) for im in ours['images'])
    assert n_boxes == (0 if source == 'db' else sum(
        'bbox' in a for a in world['db']['annotations']))


def test_cct_to_md_values_and_cli_identical(tmp_path, monkeypatch):
    cct = {'images': [{'id': 'im0', 'file_name': 'a.jpg', 'width': 100,
                       'height': 50}],
           'annotations': [{'id': 0, 'image_id': 'im0', 'category_id': 3,
                            'bbox': [10, 5, 20, 10]},
                           {'id': 1, 'image_id': 'gone', 'category_id': 3,
                            'bbox': [1, 1, 1, 1]}],
           'categories': [{'id': 3, 'name': 'deer'}, {'id': 0,
                                                      'name': 'empty'}]}
    path = str(tmp_path / 'cct.json')
    with open(path, 'w') as f:
        json.dump(cct, f)
    outs = [m.cct_to_md(cct) for m in CCT_TO_MD]
    assert outs[1] == outs[0]
    assert outs[1]['images'][0]['detections'][0]['bbox'] == \
        [0.1, 0.1, 0.2, 0.2]

    def run(side, out):
        monkeypatch.setattr(sys, 'argv', ['cct_to_md', path,
                                          os.path.join(out, 'md.json')])
        CCT_TO_MD[side].main()

    (_, got), (_, want) = cd.both(tmp_path, 'cli', run)
    cd.assert_same_tree(got, want)
