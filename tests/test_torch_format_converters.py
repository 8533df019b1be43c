"""
The port's copies of the data-format converters against the JAX
package's, on the same seeded inputs, byte for byte: coco_to_yolo
(options, the dataset YAML, the split symlink views), yolo_to_coco and
its dataset validation, coco_to_labelme, labelme_to_coco and
find_empty_labelme_files, labelme_to_yolo (its process pool equal to one
worker), yolo_output_to_md_output (.txt rows and val predictions),
cct_to_wi, wi_download_csv_to_coco and camtrap_dp_to_coco, and every
CLI through sys.argv; the public signatures of all 19 modules of the
slice. Inputs come from tests/torch_format_data.py.
"""

import ast
import copy
import csv
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_cct_data as cd  # noqa: E402
import torch_format_data as fd  # noqa: E402
from torch_postprocessing_data import both, relative  # noqa: E402

COCO_TO_YOLO = cd.pair('data_management.coco_to_yolo')
YOLO_TO_COCO = cd.pair('data_management.yolo_to_coco')
COCO_TO_LABELME = cd.pair('data_management.coco_to_labelme')
LABELME_TO_COCO = cd.pair('data_management.labelme_to_coco')
LABELME_TO_YOLO = cd.pair('data_management.labelme_to_yolo')
YOLO_OUTPUT = cd.pair('data_management.yolo_output_to_md_output')
CCT_TO_WI = cd.pair('data_management.cct_to_wi')
WI_DOWNLOAD = cd.pair('data_management.wi_download_csv_to_coco')
CAMTRAP = cd.pair('data_management.camtrap_dp_to_coco')

TAXONOMY = {
    'deer': {'common_name': 'White-tailed Deer', 'wi_taxon_id': 'u1',
             'class': 'Mammalia', 'order': 'Cetartiodactyla',
             'family': 'Cervidae', 'genus': 'Odocoileus',
             'species': 'virginianus'},
    'fox': {'common_name': 'Red Fox', 'wi_taxon_id': 'u2',
            'class': 'Mammalia', 'order': 'Carnivora', 'family': 'Canidae',
            'genus': 'Vulpes', 'species': 'vulpes'}}


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp('format_world')
    folder, db, db_file = fd.world(root)
    results = fd.md_results(db)
    results_file = str(root / 'results.json')
    with open(results_file, 'w') as f:
        json.dump(results, f, indent=1)
    return dict(root=root, folder=folder, db=db, db_file=db_file,
                results=results, results_file=results_file)


def _same(root, tag, run, mask=()):
    """run(module, out folder) for the JAX module and the port's copy:
    the same value (folders taken out) and the same files."""

    (ours, ours_dir), (ref, ref_dir) = both(root, tag, run)
    assert relative(ours, ours_dir) == relative(ref, ref_dir)
    return cd.assert_same_tree(ours_dir, ref_dir, mask)


COCO_TO_YOLO_CASES = {
    'default': {},
    'exclude_empty': {'category_names_to_exclude': ['empty']},
    'no_empty_files': {'allow_empty_annotations': False},
    'unclipped': {'clip_boxes': False},
    'flat': {'flatten_paths': True, 'class_file_name': 'names.txt'},
    'labels_only': {'input_image_folder': None},
    'no_output': {'write_output': False},
}


@pytest.mark.parametrize('case', sorted(COCO_TO_YOLO_CASES))
def test_coco_to_yolo_identical(world, tmp_path, case, capsys):
    db = copy.deepcopy(world['db'])
    # A box that starts left of the image: clipped (and counted)
    db['annotations'][1]['bbox'] = [-4.0, 3.0, 20.0, 10.0]
    db_file = str(tmp_path / 'db.json')
    with open(db_file, 'w') as f:
        json.dump(db, f)
    kwargs = dict(COCO_TO_YOLO_CASES[case])
    printed = []

    image_folder = kwargs.pop('input_image_folder', world['folder'])

    def run(side, out):
        value = COCO_TO_YOLO[side].coco_to_yolo(image_folder, out, db_file,
                                                **kwargs)
        printed.append(capsys.readouterr().out)
        return value

    if case == 'no_output':
        (ours, _), (ref, _) = both(tmp_path, case, run)
        assert ours == ref
    else:
        files = _same(tmp_path, case, run)
        assert any(f.endswith('.txt') for f in files)
    assert printed[1] == printed[0]


def test_coco_to_yolo_reference_case(world, tmp_path):
    """tests/test_data_management.py:89 on the port: 0-based classes
    sorted by id, center-format rows, the round trip through
    yolo_to_coco."""

    db = {'images': [{'id': 'im0', 'file_name': 'loc1/im0.jpg',
                      'width': 100, 'height': 80}],
          'annotations': [
              {'id': 0, 'image_id': 'im0', 'category_id': 1,
               'bbox': [10, 10, 30, 20]},
              {'id': 1, 'image_id': 'im0', 'category_id': 2,
               'bbox': [50, 40, 20, 20]}],
          'categories': [{'id': 0, 'name': 'empty'},
                         {'id': 1, 'name': 'Deer'},
                         {'id': 2, 'name': 'fox'}]}
    input_file = str(tmp_path / 'cct.json')
    with open(input_file, 'w') as f:
        json.dump(db, f)
    image_folder = str(tmp_path / 'yolo')
    os.makedirs(os.path.join(image_folder, 'loc1'))
    Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (80, 100, 3), np.uint8)).save(
        os.path.join(image_folder, 'loc1/im0.jpg'))
    out = COCO_TO_YOLO[1].coco_to_yolo(None, image_folder, input_file,
                                       category_names_to_exclude=['empty'])
    assert out['class_list'] == ['Deer', 'fox']
    cls, cx, cy, w, h = out['image_to_yolo_rows']['loc1/im0.jpg'][0]
    assert (cls, cx, cy, w, h) == pytest.approx((0, 0.25, 0.25, 0.3, 0.25))
    coco = YOLO_TO_COCO[1].yolo_to_coco(
        image_folder, os.path.join(image_folder, 'classes.txt'))
    boxes = sorted(a['bbox'] for a in coco['annotations'])
    assert boxes[0] == pytest.approx([10, 10, 30, 20], abs=0.1)
    assert coco == YOLO_TO_COCO[0].yolo_to_coco(
        image_folder, os.path.join(image_folder, 'classes.txt'))


@pytest.mark.parametrize('class_list', ['list', 'file'])
def test_write_yolo_dataset_file_identical(tmp_path, class_list):
    names = ['animal', 'person', 'vehicle']
    class_file = str(tmp_path / 'classes.txt')
    with open(class_file, 'w') as f:
        f.write('\n'.join(names) + '\n\n')

    def run(side, out):
        return COCO_TO_YOLO[side].write_yolo_dataset_file(
            os.path.join(out, 'dataset.yaml'), out,
            names if class_list == 'list' else class_file,
            train_folder_relative='train', val_folder_relative='val',
            test_folder_relative='test' if class_list == 'file' else None)

    _same(tmp_path, class_list, run)


@pytest.mark.parametrize('lowercase,class_list', [
    (False, True), (True, False)])
def test_create_yolo_symlinks_identical(world, tmp_path, lowercase,
                                        class_list):
    source = str(tmp_path / 'yolo')
    COCO_TO_YOLO[1].coco_to_yolo(world['folder'], source, world['db_file'])
    # One upper-case extension, for force_lowercase_image_extension
    os.rename(os.path.join(source, 'cam0/loc0/img_00.jpg'),
              os.path.join(source, 'cam0/loc0/img_00.JPG'))
    links = []

    def run(side, out):
        value = COCO_TO_YOLO[side].create_yolo_symlinks(
            source, os.path.join(out, 'images'), os.path.join(out, 'labels'),
            class_list_file=os.path.join(source, 'classes.txt')
            if class_list else None,
            force_lowercase_image_extension=lowercase)
        links.append(sorted(
            (os.path.relpath(os.path.join(b, n), out),
             os.readlink(os.path.join(b, n)))
            for b, _, ns in os.walk(out) for n in ns))
        return value

    files = _same(tmp_path, 'links', run)
    assert links[1] == links[0]
    assert ('images/cam0/loc0/img_00.jpg' in files) == lowercase
    assert ('labels/object.data' in files) == class_list


def test_create_yolo_symlinks_reference_case(tmp_path):
    """tests/test_breadth_utils_r3.py:448 on the port."""

    src = tmp_path / 'yolo'
    (src / 'cam1').mkdir(parents=True)
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(
        str(src / 'cam1' / 'im_0.jpg'))
    with open(str(src / 'cam1' / 'im_0.txt'), 'w') as f:
        f.write('0 0.5 0.5 0.2 0.2\n')
    classes = str(tmp_path / 'classes.txt')
    with open(classes, 'w') as f:
        f.write('animal\n')
    images_out, labels_out = str(tmp_path / 'images'), str(
        tmp_path / 'labels')
    COCO_TO_YOLO[1].create_yolo_symlinks(str(src), images_out, labels_out,
                                         class_list_file=classes)
    assert os.path.isfile(os.path.join(images_out, 'cam1', 'im_0.jpg'))
    assert os.path.isfile(os.path.join(labels_out, 'cam1', 'im_0.txt'))
    assert os.path.isfile(os.path.join(labels_out, 'object.data'))


@pytest.fixture(scope='module')
def yolo_set(world, tmp_path_factory):
    """A YOLO folder from the world's database (coco_to_yolo, copied
    images), a broken label file, a label without an image, an unreadable
    image, and the class list as a .txt and a dataset YAML."""

    root = tmp_path_factory.mktemp('yolo_set')
    folder = str(root / 'yolo')
    out = COCO_TO_YOLO[1].coco_to_yolo(world['folder'], folder,
                                       world['db_file'],
                                       class_file_name='../classes.txt')
    COCO_TO_YOLO[1].write_yolo_dataset_file(
        str(root / 'dataset.yaml'), folder, out['class_list'],
        train_folder_relative='.')
    with open(os.path.join(folder, 'cam1/loc0/img_01.txt'), 'a') as f:
        f.write('# a comment\n9 0.5 0.5 0.1 0.1\n0 0.95 0.5 0.2 0.1\n'
                '1 0.5\n\n')
    with open(os.path.join(folder, 'cam0/orphan.txt'), 'w') as f:
        f.write('0 0.5 0.5 0.1 0.1\n')
    with open(os.path.join(folder, 'cam0/broken.jpg'), 'wb') as f:
        f.write(b'not a jpeg')
    return dict(folder=folder, classes=str(root / 'classes.txt'),
                yaml=str(root / 'dataset.yaml'))


@pytest.mark.parametrize('class_file', ['classes', 'yaml', None])
def test_validate_yolo_dataset_identical(yolo_set, class_file):
    reports = [module.validate_yolo_dataset(
        yolo_set['folder'], yolo_set[class_file] if class_file else None)
        for module in YOLO_TO_COCO]
    assert reports[1] == reports[0]
    # The world's last image is listed but not on disk: its labels stay
    assert reports[1]['labels_without_images'] == ['cam0/orphan',
                                                   'cam1/loc1/img_15']
    assert reports[1]['images_without_labels'] == ['cam0/broken']
    assert len(reports[1]['label_errors']) == 1
    assert YOLO_TO_COCO[1].load_yolo_class_list(yolo_set['yaml']) == \
        YOLO_TO_COCO[0].load_yolo_class_list(yolo_set['yaml']) == \
        YOLO_TO_COCO[1].load_yolo_class_list(yolo_set['classes'])


def test_validate_label_file_identical(yolo_set, tmp_path, capsys):
    """tests/test_breadth_utils_r3.py:218's cases on the port, verbose,
    and an unreadable file."""

    label = os.path.join(yolo_set['folder'], 'cam1/loc0/img_01.txt')
    outs = []
    for module in YOLO_TO_COCO:
        outs.append([module.validate_label_file(
            label, category_id_to_name={0: 'a', 1: 'b'}, verbose=True),
            module.validate_label_file(str(tmp_path / 'missing.txt')),
            capsys.readouterr().out])
    assert outs[1] == outs[0]
    # Category 2 (not in the mapping) on the image's own rows, 9, the box
    # past the right edge, the short line
    assert len(outs[1][0]['errors']) == 5
    assert outs[1][1]['errors'][0].startswith('Read error')


@pytest.mark.parametrize('empty,error,class_file', [
    ('no_annotations', 'no_annotations', 'classes'),
    ('empty_annotations', 'skip', 'yaml'),
    ('skip', 'no_annotations', 'classes')])
def test_yolo_to_coco_identical(yolo_set, tmp_path, empty, error,
                                class_file):
    def run(side, out):
        return YOLO_TO_COCO[side].yolo_to_coco(
            yolo_set['folder'], yolo_set[class_file],
            os.path.join(out, 'coco.json'), empty_image_handling=empty,
            error_image_handling=error)

    _same(tmp_path, empty, run)
    with pytest.raises(AssertionError):
        YOLO_TO_COCO[1].yolo_to_coco(yolo_set['folder'],
                                     yolo_set['classes'],
                                     empty_image_handling='drop')


@pytest.fixture(scope='module')
def labelme_set(world, tmp_path_factory):
    """Copies of the world's images with labelme files from its database
    (coco_to_labelme of the port), one image's file emptied of shapes, one
    holding a polygon and a shape with a confidence, one removed, one
    unreadable, and a shape outside the image."""

    root = tmp_path_factory.mktemp('labelme_set')
    folder = str(root / 'labelme')
    shutil.copytree(world['folder'], folder)
    COCO_TO_LABELME[1].coco_to_labelme(world['db_file'], folder)
    path = os.path.join(folder, 'cam0/loc1/img_02.json')
    with open(path) as f:
        data = json.load(f)
    data['shapes'].append({'label': 'fox', 'shape_type': 'polygon',
                           'points': [[1, 1], [5, 1], [3, 4]]})
    data['shapes'].append({'label': 'deer', 'shape_type': 'rectangle',
                           'points': [[30, 20], [2, 4]], 'conf': 0.5})
    data['shapes'].append({'label': 'deer', 'shape_type': 'rectangle',
                           'points': [[500, 500], [600, 600]]})
    with open(path, 'w') as f:
        json.dump(data, f)
    os.remove(os.path.join(folder, 'cam1/loc1/img_03.json'))
    with open(os.path.join(folder, 'cam0/loc0/img_04.json'), 'w') as f:
        f.write('{"broken": ')
    return dict(folder=folder)


@pytest.mark.parametrize('source,overwrite', [
    ('file', False), ('dict', False), ('unsized', True)])
def test_coco_to_labelme_identical(world, tmp_path, source, overwrite):
    db = copy.deepcopy(world['db'])
    if source == 'unsized':
        for im in db['images']:
            im.pop('width', None)
            im.pop('height', None)
    images = []

    def run(side, out):
        shutil.copytree(world['folder'], out, dirs_exist_ok=True)
        # A file written earlier: kept unless overwrite
        with open(os.path.join(out, 'cam0/loc0/img_00.json'), 'w') as f:
            f.write('{}')
        images.append(out)
        return COCO_TO_LABELME[side].coco_to_labelme(
            world['db_file'] if source == 'file' else db, out,
            overwrite=overwrite)

    _same(tmp_path, source, run)
    record = COCO_TO_LABELME[1].get_labelme_dict_for_image_from_coco_record(
        world['db']['images'][0], [], world['db']['categories'],
        info={'k': 1})
    assert record == COCO_TO_LABELME[0]\
        .get_labelme_dict_for_image_from_coco_record(
            world['db']['images'][0], [], world['db']['categories'],
            info={'k': 1})
    with pytest.raises(AssertionError):
        COCO_TO_LABELME[1].get_labelme_dict_for_image_from_coco_record(
            world['db']['images'][0], [world['db']['annotations'][1]],
            world['db']['categories'])


LABELME_TO_COCO_CASES = {
    'default': {},
    'labelled_only': {'include_images_without_labels': False},
    'folders': {'use_folders_as_labels': True},
    'given_ids': {'category_id_to_category_name': {3: 'fox', '7': 'deer'},
                  'empty_category_name': 'blank'},
    'flat': {'recursive': False},
}


@pytest.mark.parametrize('case', sorted(LABELME_TO_COCO_CASES))
def test_labelme_to_coco_identical(labelme_set, tmp_path, case, capsys):
    printed = []

    def run(side, out):
        value = LABELME_TO_COCO[side].labelme_to_coco(
            labelme_set['folder'], os.path.join(out, 'coco.json'),
            **LABELME_TO_COCO_CASES[case])
        printed.append(capsys.readouterr().out)
        return value

    _same(tmp_path, case, run)
    assert printed[1] == printed[0]


def test_labelme_round_trip_reference_case(tmp_path):
    """tests/test_workflows.py:94 on the port."""

    folder = str(tmp_path / 'images')
    os.makedirs(folder)
    rng = np.random.RandomState(0)
    for name in ('a.jpg', 'b.jpg'):
        Image.fromarray(rng.randint(0, 255, (60, 80, 3), np.uint8)).save(
            os.path.join(folder, name))
    labelme = {'version': '5.3.0', 'flags': {},
               'shapes': [{'label': 'deer', 'points': [[10, 10], [40, 40]],
                           'group_id': None, 'shape_type': 'rectangle',
                           'flags': {}}],
               'imagePath': 'a.jpg', 'imageData': None,
               'imageHeight': 60, 'imageWidth': 80}
    with open(os.path.join(folder, 'a.json'), 'w') as f:
        json.dump(labelme, f)
    coco = LABELME_TO_COCO[1].labelme_to_coco(folder)
    assert len(coco['images']) == 2
    assert [a['bbox'] for a in coco['annotations'] if 'bbox' in a] == \
        [[10, 10, 30, 30]]
    assert {c['name'] for c in coco['categories']} >= {'deer', 'empty'}
    os.remove(os.path.join(folder, 'a.json'))
    files = COCO_TO_LABELME[1].coco_to_labelme(coco, folder)
    assert len(files) == 2
    with open(os.path.join(folder, 'a.json')) as f:
        shape = json.load(f)['shapes'][0]
    assert shape['label'] == 'deer'
    assert shape['points'] == [[10, 10], [40, 40]]


def test_find_empty_labelme_files_identical(tmp_path):
    """tests/test_breadth_utils_r3.py:431's case on both, and a nested
    non-recursive one."""

    for i in range(3):
        Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(
            str(tmp_path / 'im_{}.jpg'.format(i)))
    os.makedirs(str(tmp_path / 'sub'))
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(
        str(tmp_path / 'sub' / 'x.jpg'))
    with open(str(tmp_path / 'im_0.json'), 'w') as f:
        json.dump({'shapes': []}, f)
    with open(str(tmp_path / 'im_1.json'), 'w') as f:
        json.dump({'shapes': [{'label': 'animal',
                               'points': [[1, 1], [5, 5]]}]}, f)
    outs = [[module.find_empty_labelme_files(str(tmp_path), recursive=r)
             for r in (True, False)] for module in LABELME_TO_COCO]
    assert outs[1] == outs[0]
    assert outs[1][0] == {
        'images_with_empty_json_files': ['im_0.jpg'],
        'images_with_no_json_files': ['im_2.jpg', 'sub/x.jpg'],
        'images_with_non_empty_json_files': ['im_1.jpg']}


@pytest.mark.parametrize('class_list,overwrite', [
    (None, True), (['fox', 'zebra'], False)])
def test_labelme_to_yolo_identical(labelme_set, tmp_path, class_list,
                                   overwrite):
    def run(side, out):
        shutil.copytree(labelme_set['folder'], out, dirs_exist_ok=True)
        with open(os.path.join(out, 'cam0/loc1/img_06.txt'), 'w') as f:
            f.write('kept\n')
        return LABELME_TO_YOLO[side].labelme_to_yolo(
            out, class_list=list(class_list) if class_list else None,
            overwrite=overwrite)

    _same(tmp_path, str(overwrite), run)


def test_labelme_to_yolo_reference_case(tmp_path):
    """tests/test_importers.py:104 on the port."""

    Image.fromarray(np.zeros((50, 100, 3), np.uint8)).save(
        str(tmp_path / 'a.jpg'))
    with open(str(tmp_path / 'a.json'), 'w') as f:
        json.dump({'shapes': [{'label': 'deer', 'points': [[10, 5], [30, 15]],
                               'shape_type': 'rectangle'}],
                   'imageWidth': 100, 'imageHeight': 50}, f)
    assert LABELME_TO_YOLO[1].labelme_to_yolo(str(tmp_path)) == ['deer']
    rows = fd.read(str(tmp_path / 'a.txt'), 'r').split()
    assert rows[0] == '0'
    assert abs(float(rows[1]) - 0.2) < 1e-5
    assert abs(float(rows[3]) - 0.2) < 1e-5


@pytest.mark.parametrize('n_workers,use_threads', [
    (1, True), (4, True), (4, False)])
def test_labelme_folder_to_yolo_identical(labelme_set, tmp_path, n_workers,
                                          use_threads, capsys):
    """The port in 1 worker, 4 threads and 4 spawned processes against
    JAX's one worker: the same statuses and files; a required token and
    'skip' run too."""

    folder = str(tmp_path / 'src')
    shutil.copytree(labelme_set['folder'], folder)
    os.remove(os.path.join(folder, 'cam0/loc0/img_04.json'))
    # One shape outside the image (skipped, printed), one 1-pixel image
    with open(os.path.join(folder, 'cam1/loc0/img_05.json')) as f:
        data = json.load(f)
    data['imageWidth'] = 1
    data['token'] = True
    with open(os.path.join(folder, 'cam1/loc0/img_05.json'), 'w') as f:
        json.dump(data, f)
    with open(os.path.join(folder, 'cam0/loc1/img_02.json')) as f:
        data = json.load(f)
    data['shapes'] = [s for s in data['shapes']
                      if s['shape_type'] == 'rectangle']
    with open(os.path.join(folder, 'cam0/loc1/img_02.json'), 'w') as f:
        json.dump(data, f)
    printed = []

    def run(side, out):
        shutil.copytree(folder, out, dirs_exist_ok=True)
        module = LABELME_TO_YOLO[side]
        value = [module.labelme_folder_to_yolo(
            out, n_workers=n_workers if side else 1,
            use_threads=use_threads if side else True)]
        value.append(module.labelme_folder_to_yolo(
            out, value[0]['category_name_to_category_id'],
            overwrite_behavior='skip'))
        value.append(module.labelme_folder_to_yolo(
            out, required_token='token',
            relative_filenames_to_convert=['cam1/loc0/img_05.json',
                                           'cam0/loc1/img_02.json']))
        printed.append(capsys.readouterr().out.replace(out, ''))
        return value

    _same(tmp_path, 'out', run)
    if use_threads:
        # (spawned workers print to their own stdout)
        assert printed[1] == printed[0]
    assert 'Skipping invalid shape' in printed[0]


def test_labelme_file_to_yolo_file_refusals(labelme_set, tmp_path):
    path = os.path.join(labelme_set['folder'], 'cam0/loc1/img_02.json')
    messages = []
    for module in LABELME_TO_YOLO:
        for args in ((path, {'deer': 0, 'fox': 1, 'Elk': 2}),
                     (path, {}),
                     (str(tmp_path / 'x.json'), {}),
                     (path.replace('.json', '.jpg'), {})):
            with pytest.raises(AssertionError) as info:
                module.labelme_file_to_yolo_file(
                    *args, yolo_file=str(tmp_path / 'out.txt'))
            messages.append(str(info.value).replace(
                module.__name__, ''))
    assert messages[4:] == messages[:4]


@pytest.mark.parametrize('kind', ['yaml', 'json', 'txt', 'csv'])
def test_read_classes_from_yolo_dataset_file_identical(tmp_path, kind):
    path = str(tmp_path / 'classes.{}'.format(kind))
    with open(path, 'w') as f:
        if kind == 'yaml':
            f.write('path: /data\ntrain: images\n\nnames:\n  0: animal\n'
                    '  1: person\n  2: vehicle\n')
        elif kind == 'json':
            json.dump({'0': 'animal', '2': 'vehicle'}, f)
        else:
            f.write('animal\n\nperson\n')
    if kind == 'csv':
        for module in YOLO_OUTPUT:
            with pytest.raises(ValueError):
                module.read_classes_from_yolo_dataset_file(path)
        return
    outs = [m.read_classes_from_yolo_dataset_file(path) for m in YOLO_OUTPUT]
    assert outs[1] == outs[0] and len(outs[0]) >= 2


@pytest.fixture(scope='module')
def yolo_predictions(world, tmp_path_factory):
    """The world's MD results as YOLO val predictions (pixels, 0-based
    classes) and as per-image .txt rows (one row without a confidence)."""

    root = tmp_path_factory.mktemp('yolo_predictions')
    predictions, id_to_file = [], {}
    txt_dir = str(root / 'txt')
    for i, im in enumerate(world['results']['images']):
        id_to_file[i] = im['file']
        if im['detections'] is None:
            predictions.append({'image_id': i, 'category_id': 0,
                                'bbox': [1, 1, 5, 5], 'score': 0.5})
            continue
        path = os.path.join(txt_dir, os.path.splitext(im['file'])[0] +
                            '.txt')
        os.makedirs(os.path.dirname(path), exist_ok=True)
        w, h = next((x['width'], x['height']) for x in world['db']['images']
                    if x['file_name'] == im['file'])
        with open(path, 'w') as f:
            for k, d in enumerate(im['detections']):
                x, y, bw, bh = d['bbox']
                row = '{} {} {} {} {}'.format(
                    int(d['category']) - 1, x + bw / 2, y + bh / 2, bw, bh)
                f.write(row + ('\n' if k == 0 else
                               ' {}\n'.format(d['conf'])))
                predictions.append({
                    'image_id': i, 'category_id': int(d['category']) - 1,
                    'bbox': [x * w, y * h, bw * w, bh * h],
                    'score': d['conf'] + 1e-5})
    pred_file = str(root / 'predictions.json')
    with open(pred_file, 'w') as f:
        json.dump(predictions, f)
    return dict(pred_file=pred_file, id_to_file=id_to_file, txt_dir=txt_dir)


@pytest.mark.parametrize('names,offset,truncate,mapping', [
    (True, True, True, True), (False, True, True, True),
    (True, False, False, True), (True, True, True, False)])
def test_yolo_json_output_to_md_output_identical(world, yolo_predictions,
                                                 tmp_path, names, offset,
                                                 truncate, mapping):
    def run(side, out):
        return YOLO_OUTPUT[side].yolo_json_output_to_md_output(
            yolo_predictions['pred_file'], world['folder'],
            os.path.join(out, 'md.json'),
            yolo_category_id_to_name={0: 'animal', 1: 'person'}
            if names else None,
            detector_name='yolo-test',
            image_id_to_relative_path=yolo_predictions['id_to_file']
            if mapping else None,
            offset_yolo_class_ids=offset,
            truncate_to_standard_md_precision=truncate)

    _same(tmp_path, 'json', run)


def test_yolo_txt_output_to_md_output_identical(world, yolo_predictions,
                                                tmp_path):
    def run(side, out):
        return YOLO_OUTPUT[side].yolo_txt_output_to_md_output(
            yolo_predictions['txt_dir'], world['folder'],
            os.path.join(out, 'md.json'), detector_tag='yolo-txt')

    _same(tmp_path, 'txt', run)


def test_yolo_txt_output_reference_case(tmp_path):
    """tests/test_data_management.py:135 on the port."""

    images = str(tmp_path / 'images')
    os.makedirs(images)
    Image.fromarray(np.zeros((80, 100, 3), np.uint8)).save(
        os.path.join(images, 'a.jpg'))
    labels = str(tmp_path / 'labels')
    os.makedirs(labels)
    with open(os.path.join(labels, 'a.txt'), 'w') as f:
        f.write('0 0.5 0.5 0.2 0.4 0.9\n')
    out = YOLO_OUTPUT[1].yolo_txt_output_to_md_output(
        labels, images, str(tmp_path / 'md.json'))
    det = out['images'][0]['detections'][0]
    assert (det['category'], det['conf']) == ('1', 0.9)
    assert det['bbox'] == pytest.approx([0.4, 0.3, 0.2, 0.4])


@pytest.mark.parametrize('case', ['files', 'dicts', 'deployments'])
def test_cct_to_wi_identical(world, tmp_path, case, capsys):
    db = copy.deepcopy(world['db'])
    del db['images'][4]['location']
    tax_file = str(tmp_path / 'taxonomy.json')
    with open(tax_file, 'w') as f:
        json.dump(TAXONOMY, f)
    printed = []

    def run(side, out):
        value = CCT_TO_WI[side].cct_to_wi(
            world['db_file'] if case == 'files' else db,
            tax_file if case == 'files' else TAXONOMY, out,
            project_info=None if case == 'files' else {
                'project_id': 'p7', 'project_name': 'smoke',
                'country_code': 'USA'},
            deployment_for_image=(lambda im: im['file_name'][:4])
            if case == 'deployments' else None)
        printed.append(capsys.readouterr().out.replace(out, ''))
        return value

    files = _same(tmp_path, case, run)
    assert files == ['cameras.csv', 'deployments.csv', 'images.csv',
                     'projects.csv']
    assert printed[1] == printed[0]
    for name in ('PROJECT', 'CAMERA', 'DEPLOYMENT', 'IMAGE'):
        attr = name + '_COLUMNS'
        assert getattr(CCT_TO_WI[1], attr) == getattr(CCT_TO_WI[0], attr)


def test_cct_to_wi_reference_case(tmp_path):
    """tests/test_ecosystem_tools.py:357 on the port."""

    cct = {'info': {'description': 'test'},
           'images': [{'id': 'im1', 'file_name': 'camA/x.jpg',
                       'datetime': '2023-01-01 10:00:00'}],
           'annotations': [{'id': 'a1', 'image_id': 'im1',
                            'category_id': 1}],
           'categories': [{'id': 1, 'name': 'red fox'}]}
    taxonomy = {'red fox': dict(TAXONOMY['fox'], common_name='Red Fox')}
    paths = CCT_TO_WI[1].cct_to_wi(cct, taxonomy, str(tmp_path / 'wi'),
                                   project_info={'project_id': 'proj1'})
    assert all(os.path.isfile(p) for p in paths.values())
    text = fd.read(paths['images'], 'r')
    assert 'camA/x.jpg' in text and 'Vulpes' in text
    assert 'camA' in fd.read(paths['deployments'], 'r')


@pytest.fixture(scope='module')
def wi_export(tmp_path_factory):
    """Two WI export CSVs (images_1.csv, images_0.csv) in a folder with an
    unrelated CSV: blanks, a blank-label disagreement, humans, repeated
    images, a missing timestamp."""

    root = tmp_path_factory.mktemp('wi_export')
    rows = [('p1', 'dep1', 'g1', 'gs://bucket/x/g1.JPG', 'Red Fox', '0',
             '2023-01-01 10:00:00'),
            ('p1', 'dep1', 'g2', 'gs://bucket/x/g2.JPG', 'Blank', '1',
             '2023-01-01 11:00:00'),
            ('p1', 'dep2', 'g3', 'gs://bucket/x/g3.JPG', 'Human', '0',
             '2023-01-01 12:00:00'),
            ('p1', 'dep2', 'g3', 'gs://bucket/x/g3.JPG', 'Red Fox', '0',
             '2023-01-01 12:00:00'),
            ('p2', 'dep3', 'g4', '', 'Homo Sapiens', '0', ''),
            ('p2', 'dep3', 'g5', 'gs://bucket/y/g5.JPG', 'Elk', 'true',
             '2023-01-02 08:00:00'),
            ('p2', 'dep3', 'g6', 'gs://bucket/y/g6.JPG', 'No CV Result', '',
             '2023-01-02 09:00:00')]
    header = ['project_id', 'deployment_id', 'image_id', 'location',
              'common_name', 'is_blank', 'timestamp']
    folder = str(root / 'export')
    os.makedirs(folder)
    for name, part in (('images_1.csv', rows[4:]), ('images_0.csv',
                                                    rows[:4])):
        with open(os.path.join(folder, name), 'w', newline='') as f:
            writer = csv.writer(f)
            writer.writerow(header)
            writer.writerows(part)
    with open(os.path.join(folder, 'deployments.csv'), 'w') as f:
        f.write('deployment_id\ndep1\n')
    images = str(root / 'images')
    os.makedirs(os.path.join(images, 'dep1'))
    with open(os.path.join(images, 'dep1', 'g1.JPG'), 'wb') as f:
        f.write(b'x')
    return dict(folder=folder, one=os.path.join(folder, 'images_0.csv'),
                images=images)


WI_CASES = {
    'deployment': {},
    'none': {'image_flattening': 'none'},
    'guid': {'image_flattening': 'guid'},
    'project': {'image_flattening': 'project', 'verbose': True},
    'trust_is_blank': {'blank_disagreement_handling': 'trust_is_blank',
                       'include_blanks': False},
    'remapped': {'category_remappings': {'red fox': 'fox'}},
    'missing_images': {'exclude_missing_images': True},
}


@pytest.mark.parametrize('source', ['folder', 'one'])
@pytest.mark.parametrize('case', sorted(WI_CASES))
def test_wi_download_csv_to_coco_identical(wi_export, tmp_path, source,
                                           case, capsys):
    kwargs = dict(WI_CASES[case])
    if case == 'missing_images':
        kwargs['image_folder'] = wi_export['images']
    printed = []

    def run(side, out):
        value = WI_DOWNLOAD[side].wi_download_csv_to_coco(
            wi_export[source], os.path.join(out, 'coco.json'), **kwargs)
        printed.append(capsys.readouterr().out)
        return value

    _same(tmp_path, case, run)
    assert printed[1] == printed[0]


def test_wi_download_csv_to_coco_refusals(wi_export, tmp_path):
    for module in WI_DOWNLOAD:
        with pytest.raises(ValueError, match='disagrees'):
            module.wi_download_csv_to_coco(
                wi_export['folder'], blank_disagreement_handling='error')
        with pytest.raises(AssertionError):
            module.wi_download_csv_to_coco(wi_export['one'],
                                           exclude_missing_images=True)
        with pytest.raises(AssertionError, match='No images'):
            module.wi_download_csv_to_coco(str(tmp_path))


def test_wi_download_reference_case(tmp_path):
    """tests/test_ecosystem_tools.py:332 on the port."""

    path = str(tmp_path / 'images.csv')
    with open(path, 'w') as f:
        f.write('project_id,deployment_id,image_id,location,common_name,'
                'is_blank,timestamp\n'
                'p1,dep1,g1,gs://bucket/x/g1.JPG,Red Fox,0,'
                '2023-01-01 10:00:00\n'
                'p1,dep1,g2,gs://bucket/x/g2.JPG,Blank,1,'
                '2023-01-01 11:00:00\n'
                'p1,dep2,g3,gs://bucket/x/g3.JPG,Human,0,'
                '2023-01-01 12:00:00\n')
    coco = WI_DOWNLOAD[1].wi_download_csv_to_coco(path)
    assert len(coco['images']) == 3
    assert {c['name'] for c in coco['categories']} == {'empty', 'red fox',
                                                       'human'}
    assert coco['images'][0]['file_name'].startswith('dep')
    assert len(WI_DOWNLOAD[1].wi_download_csv_to_coco(
        path, include_blanks=False)['images']) == 2


def _camtrap_package(root, db, profile=None, level='event'):
    """A Camtrap DP 1.0 package over [db]: a deployment a location, an
    event a pair of images (timestamps out of order within it), event
    observations of the image's species (human, blank and unknown ones
    too)."""

    os.makedirs(root)
    names = {c['id']: c['name'] for c in db['categories']}
    label = {a['image_id']: names[a['category_id']]
             for a in db['annotations']}
    tables = {'deployments': [], 'events': [], 'media': [],
              'observations': []}
    for loc in sorted({im['location'] for im in db['images']}):
        tables['deployments'].append({'deploymentID': loc})
    for i, im in enumerate(db['images']):
        folder, name = im['file_name'].rsplit('/', 1)
        tables['media'].append({
            'mediaID': im['id'], 'deploymentID': im['location'],
            'timestamp': '2024-02-{:02d}T08:{:02d}:00'.format(
                1 + i // 2, 59 - i) if i != 5 else 'not a time',
            'filePath': folder, 'fileName': name})
        tables['events'].append({'eventID': 'ev{}'.format(i // 2),
                                 'mediaID': im['id']})
    for k in range(len(db['images']) // 2):
        im = db['images'][2 * k]
        species = label.get(im['id'], 'empty')
        kind = {'empty': 'blank', 'Elk': 'unknown'}.get(species, 'animal')
        row = {'eventID': 'ev{}'.format(k), 'observationLevel': level,
               'observationType': kind,
               'scientificName': species if kind == 'animal' else ''}
        tables['observations'].append(row)
        if k % 3 == 0:
            tables['observations'].append(dict(
                row, observationType='human', scientificName='Homo sapiens'))
    for name, rows in tables.items():
        with open(os.path.join(root, name + '.csv'), 'w', newline='') as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    with open(os.path.join(root, 'datapackage.json'), 'w') as f:
        json.dump({'name': 'test-package',
                   'profile': profile or CAMTRAP[1].CAMTRAP_DP_PROFILE,
                   'resources': [{'name': n, 'path': n + '.csv'}
                                 for n in tables]}, f)
    return root


def test_camtrap_dp_to_coco_identical(world, tmp_path):
    package = _camtrap_package(str(tmp_path / 'package'), world['db'])

    def run(side, out):
        return CAMTRAP[side].camtrap_dp_to_coco(
            package, os.path.join(out, 'coco.json'))

    _same(tmp_path, 'package', run)
    assert CAMTRAP[1].CAMTRAP_DP_PROFILE == CAMTRAP[0].CAMTRAP_DP_PROFILE


@pytest.mark.parametrize('fault', ['profile', 'level', 'missing'])
def test_camtrap_dp_to_coco_refusals(world, tmp_path, fault):
    package = _camtrap_package(
        str(tmp_path / 'package'), world['db'],
        profile='https://example.org/other.json'
        if fault == 'profile' else None,
        level='media' if fault == 'level' else 'event')
    if fault == 'missing':
        os.remove(os.path.join(package, 'events.csv'))
    messages = []
    for module in CAMTRAP:
        error = ValueError if fault == 'level' else AssertionError
        with pytest.raises(error) as info:
            module.camtrap_dp_to_coco(package)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


def _cli_cases(world, yolo_set, labelme_set, yolo_predictions, wi_export,
               root):
    """(module pair, argv after the program name, the folder it writes
    into) for each converter CLI."""

    package = _camtrap_package(os.path.join(root, 'package'), world['db'])
    tax = os.path.join(root, 'taxonomy.json')
    with open(tax, 'w') as f:
        json.dump(TAXONOMY, f)
    return {
        'coco_to_yolo': (COCO_TO_YOLO, lambda out: [
            world['folder'], out, world['db_file'], '--exclude_categories',
            'empty', 'Elk']),
        'yolo_to_coco': (YOLO_TO_COCO, lambda out: [
            yolo_set['folder'], yolo_set['classes'],
            os.path.join(out, 'coco.json'), '--empty_image_handling',
            'empty_annotations']),
        'coco_to_labelme': (COCO_TO_LABELME, lambda out: [
            world['db_file'], out, '--overwrite']),
        'labelme_to_coco': (LABELME_TO_COCO, lambda out: [
            labelme_set['folder'], os.path.join(out, 'coco.json'),
            '--no_empty_images']),
        'labelme_to_yolo': (LABELME_TO_YOLO, lambda out: [out]),
        'yolo_json': (YOLO_OUTPUT, lambda out: [
            yolo_predictions['pred_file'], world['folder'],
            os.path.join(out, 'md.json')]),
        'yolo_txt': (YOLO_OUTPUT, lambda out: [
            yolo_predictions['txt_dir'], world['folder'],
            os.path.join(out, 'md.json')]),
        'cct_to_wi': (CCT_TO_WI, lambda out: [
            world['db_file'], tax, out, '--project_id', 'p9']),
        'wi_download': (WI_DOWNLOAD, lambda out: [
            wi_export['folder'], os.path.join(out, 'coco.json'),
            '--image_flattening', 'guid', '--exclude_blanks']),
        'camtrap_dp_to_coco': (CAMTRAP, lambda out: [
            package, os.path.join(out, 'coco.json')]),
    }


CLI_NAMES = ['coco_to_yolo', 'yolo_to_coco', 'coco_to_labelme',
             'labelme_to_coco', 'labelme_to_yolo', 'yolo_json', 'yolo_txt',
             'cct_to_wi', 'wi_download', 'camtrap_dp_to_coco']


@pytest.mark.parametrize('name', CLI_NAMES)
def test_converter_cli_identical(world, yolo_set, labelme_set,
                                 yolo_predictions, wi_export, tmp_path, name,
                                 monkeypatch, capsys):
    """Each converter's main() through sys.argv writes what JAX's writes
    and prints what it prints; without arguments both print the same
    help and exit 0."""

    pair, argv = _cli_cases(world, yolo_set, labelme_set, yolo_predictions,
                            wi_export, str(tmp_path / 'inputs'))[name]
    printed = []

    def run(side, out):
        if name in ('coco_to_labelme', 'labelme_to_yolo'):
            shutil.copytree(world['folder'] if name == 'coco_to_labelme'
                            else labelme_set['folder'], out,
                            dirs_exist_ok=True)
        fd.run_main(pair[side], [name] + argv(out), monkeypatch)
        printed.append(capsys.readouterr().out.replace(out, ''))

    _same(tmp_path, name, run)
    assert printed[1] == printed[0]
    helps = []
    for module in pair:
        with pytest.raises(SystemExit) as info:
            fd.run_main(module, [name], monkeypatch)
        assert info.value.code in (0, None)
        helps.append(capsys.readouterr().out)
    assert helps[1] == helps[0] and 'usage: ' + name in helps[0]


# The slice's 19 modules under data_management/
SLICE = ('importers', 'animl_to_md', 'zamba_to_md', 'yolo_output_to_md_output',
         'coco_to_yolo', 'yolo_to_coco', 'coco_to_labelme', 'labelme_to_coco',
         'labelme_to_yolo', 'cct_to_wi', 'wi_download_csv_to_coco',
         'camtrap_dp_to_coco', 'image_file_tools', 'ocr_tools',
         'lila/__init__', 'lila/lila_common', 'lila/lila_reports',
         'lila/download_lila_subset', 'lila/generate_lila_per_image_labels')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public(path):
    """{name: signature} of the public functions and classes of [path] (a
    class: its bases and each method's arguments), and the names of its
    public module-level assignments."""

    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and \
                not node.name.startswith('_'):
            out[node.name] = ast.unparse(node.args)
        elif isinstance(node, ast.ClassDef) and \
                not node.name.startswith('_'):
            out[node.name] = (
                [ast.unparse(b) for b in node.bases],
                {n.name: ast.unparse(n.args) for n in node.body
                 if isinstance(n, ast.FunctionDef)})
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and \
                        not target.id.startswith('_'):
                    out[target.id] = 'assigned'
    return out


@pytest.mark.parametrize('module', SLICE)
def test_public_signatures_match(module):
    paths = [os.path.join(REPO, package, 'data_management', module + '.py')
             for package in ('megadetector_tpu', 'megadetector_tpu_torch')]
    want, got = (_public(p) for p in paths)
    assert got == want
    assert want or module == 'lila/__init__'
