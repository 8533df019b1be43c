"""
The port's copies of image_file_tools and ocr_tools against the JAX
package's, on the same seeded images: remove_exif_from_image and
remove_exif (4 workers equal to 1), rename_images (dry runs, name
collisions, 4 copy workers equal to 1), generate_crops_from_cct, the
image-tools CLI; the info-bar crops, the datetime parser, the OCR
pipeline with an injected ocr_fn, and the refusal without an engine.
"""

import datetime
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_cct_data as cd  # noqa: E402
import torch_format_data as fd  # noqa: E402
from torch_postprocessing_data import both, relative  # noqa: E402

IMAGE_TOOLS = cd.pair('data_management.image_file_tools')
OCR = cd.pair('data_management.ocr_tools')


def _stamp(path, stamp, original=None):
    """Splice an EXIF block (DateTime [stamp], DateTimeOriginal
    [original]) into the JPEG at [path] after its start-of-image marker."""

    exif = Image.Exif()
    exif[306] = stamp
    if original is not None:
        exif.get_ifd(0x8769)[36867] = original
    block = exif.tobytes()
    data = fd.read(path)
    with open(path, 'wb') as f:
        f.write(data[:2] + b'\xff\xe1' + struct.pack('>H', len(block) + 2) +
                block + data[2:])


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """The CCT world's images with EXIF times on most (DateTimeOriginal on
    some), a PNG, and two files whose flattened names collide."""

    root = tmp_path_factory.mktemp('image_tools')
    folder, db, db_file = fd.world(root)
    for i, im in enumerate(db['images'][:-1]):
        if i % 4 != 3:
            _stamp(os.path.join(folder, im['file_name']),
                   '2024:01:{:02d} 10:00:00'.format(i + 1),
                   '2023:12:{:02d} 09:00:00'.format(i + 1)
                   if i % 3 == 0 else None)
    rng = np.random.RandomState(3)
    os.makedirs(os.path.join(folder, 'cam1~loc1'))
    Image.fromarray(rng.randint(0, 256, (30, 40, 3), np.uint8)).save(
        os.path.join(folder, 'cam1~loc1', 'img_03.jpg'))
    Image.fromarray(rng.randint(0, 256, (30, 40, 4), np.uint8)).save(
        os.path.join(folder, 'cam1', 'alpha.png'))
    return dict(root=str(root), folder=folder, db=db, db_file=db_file)


@pytest.mark.parametrize('target', ['copy', 'in_place', 'png'])
def test_remove_exif_from_image_identical(tree, tmp_path, target):
    source = os.path.join(tree['folder'], 'cam0/loc0/img_00.jpg'
                          if target != 'png' else 'cam1/alpha.png')

    def run(side, out):
        path = os.path.join(out, os.path.basename(source))
        shutil.copyfile(source, path)
        value = IMAGE_TOOLS[side].remove_exif_from_image(
            path, os.path.join(out, 'clean' + os.path.splitext(path)[1])
            if target == 'copy' else None)
        return os.path.basename(value)

    files = cd.assert_same_tree(*[f for _, f in both(tmp_path, target,
                                                      run)])
    assert len(files) == 1 + (target == 'copy')
    with Image.open(os.path.join(tmp_path, target, 'port', files[0])) as im:
        assert not im.getexif()


def test_remove_exif_reference_case(tmp_path):
    """tests/test_ecosystem_tools.py:228 on the port."""

    src = tmp_path / 'tree' / 'camA'
    src.mkdir(parents=True)
    Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (30, 40, 3), np.uint8)).save(str(src / 'p1.jpg'))
    ours = IMAGE_TOOLS[1]
    with Image.open(ours.remove_exif_from_image(
            str(src / 'p1.jpg'), str(tmp_path / 'clean.jpg'))) as im:
        assert not im.getexif()
    mapping = ours.rename_images(str(tmp_path / 'tree'),
                                 str(tmp_path / 'flat'))
    out_name = list(mapping.values())[0]
    assert len(mapping) == 1 and 'camA' in out_name and \
        out_name.endswith('p1.jpg')
    assert os.path.isfile(str(tmp_path / 'flat' / out_name))
    crops = ours.generate_crops_from_cct({
        'images': [{'id': 'im1', 'file_name': 'camA/p1.jpg'}],
        'annotations': [{'id': 'a1', 'image_id': 'im1', 'category_id': 0,
                         'bbox': [5, 5, 20, 15]}],
        'categories': [{'id': 0, 'name': 'deer'}]},
        str(tmp_path / 'tree'), str(tmp_path / 'crops'))
    with Image.open(crops[0]) as im:
        assert len(crops) == 1 and im.size == (20, 15)


@pytest.mark.parametrize('n_workers', [1, 4])
def test_remove_exif_identical(tree, tmp_path, n_workers, capsys):
    """The port with [n_workers] threads against JAX's one: the same
    files (every EXIF block gone) and the same list."""

    printed = []

    def run(side, out):
        shutil.copytree(tree['folder'], out, dirs_exist_ok=True)
        value = IMAGE_TOOLS[side].remove_exif(
            out, n_workers=n_workers if side else 1)
        printed.append(capsys.readouterr().out)
        return value

    files = cd.assert_same_tree(*[f for _, f in both(tmp_path, 'exif',
                                                      run)])
    assert printed[1] == printed[0]
    for name in files:
        with Image.open(os.path.join(tmp_path, 'exif', 'port', name)) as im:
            assert not im.getexif()


@pytest.mark.parametrize('dry_run,n_copy_workers', [
    (True, 8), (False, 1), (False, 4)])
def test_rename_images_identical(tree, tmp_path, dry_run, n_copy_workers,
                                 capsys):
    """The same mapping (EXIF times, DateTimeOriginal first, 'unknown'
    without one, a collision resolved by the used set) and the same copies
    whatever the number of copy workers."""

    printed = []

    def run(side, out):
        value = IMAGE_TOOLS[side].rename_images(
            tree['folder'], os.path.join(out, 'flat'), dry_run=dry_run,
            verbose=True, n_copy_workers=n_copy_workers if side else 1)
        printed.append(capsys.readouterr().out)
        return value

    (ours, ours_dir), (ref, ref_dir) = both(tmp_path, 'rename', run)
    assert ours == ref and printed[1] == printed[0]
    assert len(set(ours.values())) == len(ours)
    assert ours['cam1/loc1/img_03.jpg'] == 'cam1~loc1#unknown#img_03.jpg'
    assert ours['cam1~loc1/img_03.jpg'] == 'cam1~loc1#unknown#img_03_1.jpg'
    assert ours['cam0/loc0/img_00.jpg'] == \
        'cam0~loc0#2023-12-01_09-00-00#img_00.jpg'
    if dry_run:
        assert os.listdir(ours_dir) == []
    else:
        files = cd.assert_same_tree(ours_dir, ref_dir)
        assert sorted(files) == sorted('flat/' + v for v in ours.values())
        for rel, name in ours.items():
            assert fd.read(os.path.join(ours_dir, 'flat', name)) == \
                fd.read(os.path.join(tree['folder'], rel))
    with pytest.raises(AssertionError):
        IMAGE_TOOLS[1].rename_images(tree['folder'], tree['folder'])


@pytest.mark.parametrize('source,padding,flat', [
    ('file', 0, True), ('dict', 5, False)])
def test_generate_crops_from_cct_identical(tree, tmp_path, source, padding,
                                           flat, capsys):
    db = json.loads(json.dumps(tree['db']))
    # The missing image's annotation goes; one box covers no pixel
    db['annotations'] = [a for a in db['annotations']
                         if a['image_id'] != db['images'][-1]['id']]
    db['annotations'][0]['bbox'] = [5.2, 5.0, 0.5, 4.0]
    cct = _db_file(tmp_path, db) if source == 'file' else db
    printed = []

    def run(side, out):
        value = IMAGE_TOOLS[side].generate_crops_from_cct(
            cct, tree['folder'], out, padding=padding, flat_output=flat)
        printed.append(capsys.readouterr().out)
        return value

    (ours, ours_dir), (ref, ref_dir) = both(tmp_path, source, run)
    assert relative(ours, ours_dir) == relative(ref, ref_dir)
    files = cd.assert_same_tree(ours_dir, ref_dir)
    assert printed[1] == printed[0]
    boxes = [a for a in db['annotations'] if a.get('bbox')]
    assert len(files) == len(boxes) - (padding == 0)


def _db_file(root, db):
    path = os.path.join(str(root), 'db_crops.json')
    with open(path, 'w') as f:
        json.dump(db, f)
    return path


@pytest.mark.parametrize('command', ['remove-exif', 'rename',
                                     'crops-from-cct'])
def test_image_tools_cli_identical(tree, tmp_path, command, monkeypatch,
                                   capsys):
    db = json.loads(json.dumps(tree['db']))
    db['annotations'] = [a for a in db['annotations']
                         if a['image_id'] != db['images'][-1]['id']]
    db_file = _db_file(tmp_path, db)
    printed = []

    def run(side, out):
        if command == 'remove-exif':
            shutil.copytree(tree['folder'], out, dirs_exist_ok=True)
            argv = [out, '--n_workers', '2']
        elif command == 'rename':
            argv = [tree['folder'], os.path.join(out, 'flat')]
        else:
            argv = [db_file, tree['folder'], out, '--padding', '3']
        fd.run_main(IMAGE_TOOLS[side], ['image_file_tools', command] + argv,
                    monkeypatch)
        printed.append(capsys.readouterr().out)

    cd.assert_same_tree(*[f for _, f in both(tmp_path, command, run)])
    assert printed[1] == printed[0]
    helps = []
    for module in IMAGE_TOOLS:
        with pytest.raises(SystemExit) as info:
            fd.run_main(module, ['image_file_tools'], monkeypatch)
        assert info.value.code in (0, None)
        helps.append(capsys.readouterr().out)
    assert helps[1] == helps[0] and 'usage: image_file_tools' in helps[0]


def _info_bar_image(seed, where='bottom', text_rows=True):
    """An HWC uint8 image of noise with a solid dark info bar (a few
    lighter 'text' pixels in it) at the top or bottom."""

    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (100, 200, 3)).astype(np.uint8)
    rows = slice(-8, None) if where == 'bottom' else slice(0, 6)
    img[rows] = 20
    if text_rows:
        img[rows, 10:30:3] = 200
    return img


OPTION_SETS = [None, {'image_crop_fraction': [0.1, 0.02],
                      'row_uniformity_threshold': 0.5,
                      'uniformity_delta': 30, 'crop_padding': 0}]


def _options(module, values):
    if values is None:
        return None
    options = module.DatetimeExtractionOptions()
    for k, v in values.items():
        setattr(options, k, v)
    return options


@pytest.mark.parametrize('where', ['top', 'bottom', 'none'])
@pytest.mark.parametrize('options', [0, 1])
def test_crops_identical(where, options):
    img = _info_bar_image(4, where if where != 'none' else 'bottom')
    if where == 'none':
        img = np.random.RandomState(5).randint(
            0, 255, (100, 200, 3)).astype(np.uint8)
    outs = []
    for module in OCR:
        opts = _options(module, OPTION_SETS[options])
        crops = module.make_rough_crops(Image.fromarray(img), opts)
        solid = [module.crop_to_solid_region(c, opts) for c in crops]
        gray = module.crop_to_solid_region(crops[0]['image'].mean(axis=2),
                                           opts)
        outs.append(([(c['location'], c['image'].tobytes(),
                       c['image'].shape) for c in crops],
                     [(None if s is None else (s.tobytes(), s.shape), r)
                      for s, r in solid],
                     None if gray[0] is None else gray[0].tobytes()))
    assert outs[1] == outs[0]


DATETIME_STRINGS = [
    'CAM01 2023-04-01 12:34:56 28C', '04/01/2023 7:05', 'no date here',
    '2023/13/01 10:00', '2024.02.29 23:59', '31-12-1999 23:59:59',
    '12.31.2020 1:02:03 and 2021-01-01 00:00', 'x 2021-1-2 3:04 y',
    '02/30/2023 10:10', 12345, None]


def test_datetime_string_to_datetime_identical():
    outs = [[m.datetime_string_to_datetime(s) for s in DATETIME_STRINGS]
            for m in OCR]
    assert outs[1] == outs[0]
    assert outs[1][0] == datetime.datetime(2023, 4, 1, 12, 34, 56)
    assert outs[1][2] is None and outs[1][3] is None


def _ocr(texts):
    """An OCR engine that reads the strings of [texts] in turn (one a
    call) and records the crop shapes it was given."""

    calls = []

    def ocr_fn(arr):
        calls.append(arr.shape)
        text = texts[min(len(calls) - 1, len(texts) - 1)]
        if isinstance(text, Exception):
            raise text
        return text

    return ocr_fn, calls


@pytest.mark.parametrize('texts,where', [
    (['2024-02-29 23:59'], 'bottom'),
    (['garbage', 'CAM 04/01/2023 7:05:09'], 'top'),
    (['nothing'], 'bottom')])
def test_ocr_pipeline_identical(texts, where):
    """get_datetime_from_image, try_get_datetime_from_image over two
    option sets, find_text_in_crops on both crop forms, with the same
    injected engine."""

    img = _info_bar_image(6, where)
    outs = []
    for module in OCR:
        ocr_fn, calls = _ocr(texts)
        out = [module.get_datetime_from_image(img, ocr_fn=ocr_fn)]
        out.append(module.try_get_datetime_from_image(
            img, [_options(module, v) for v in OPTION_SETS],
            ocr_fn=_ocr(texts)[0]))
        crops = module.make_rough_crops(img)
        ocr_fn2, _ = _ocr(texts)
        found = module.find_text_in_crops(crops, ocr_fn=ocr_fn2)
        found_dict = module.find_text_in_crops(
            {c['location']: c['image'] for c in crops},
            ocr_fn=_ocr(texts)[0])
        out += [found, found_dict, calls]
        outs.append(out)
    assert outs[1] == outs[0]


def test_ocr_reference_case():
    """tests/test_ecosystem_tools.py:263 on the port."""

    ours = OCR[1]
    assert ours.datetime_string_to_datetime(
        'CAM01 2023-04-01 12:34:56 28C').hour == 12
    img = np.random.RandomState(0).randint(0, 255, (100, 200, 3)).astype(
        np.uint8)
    img[-8:] = 20
    crops = ours.make_rough_crops(img)
    bottom = [c for c in crops if c['location'] == 'bottom'][0]
    solid, _ = ours.crop_to_solid_region(bottom)
    assert solid is not None and solid.shape[0] >= 4
    dt, _ = ours.get_datetime_from_image(
        img, ocr_fn=lambda arr: '2024-02-29 23:59')
    assert dt is not None and dt.day == 29


def test_ocr_errors_identical():
    """An engine that raises: try_get_datetime_from_image keeps the error
    text; every option set failing leaves no datetime."""

    img = _info_bar_image(7)
    outs = [m.try_get_datetime_from_image(
        img, [None, None], ocr_fn=_ocr([RuntimeError('engine down')])[0])
        for m in OCR]
    assert outs[1] == outs[0] and outs[0]['error'] == 'engine down'


def test_without_an_engine_both_raise(monkeypatch):
    """No pytesseract and no ocr_fn: the same RuntimeError from each entry
    point, and try_get_datetime_from_image records it."""

    monkeypatch.setitem(sys.modules, 'pytesseract', None)
    img = _info_bar_image(8)
    messages = []
    for module in OCR:
        for call in (lambda: module.get_datetime_from_image(img),
                     lambda: module.find_text_in_crops(
                         module.make_rough_crops(img)),
                     lambda: module.find_text_in_crops(
                         module.make_rough_crops(img),
                         tesseract_config_string='--psm 6')):
            with pytest.raises(RuntimeError) as info:
                call()
            messages.append(str(info.value))
        messages.append(module.try_get_datetime_from_image(img)['error'])
    assert messages[4:] == messages[:4]
    assert 'No OCR engine' in messages[0]


def test_get_datetimes_for_folder_identical(tree, tmp_path):
    """Each image's datetime through an engine that answers by image size
    (a crop of the 48 px tall images reads as a time, the others not), an
    unreadable file, the JSON written."""

    folder = str(tmp_path / 'images')
    shutil.copytree(tree['folder'], folder)
    with open(os.path.join(folder, 'cam0', 'broken.jpg'), 'wb') as f:
        f.write(b'not a jpeg')

    def ocr_fn(arr):
        return '2022-05-{:02d} 06:07'.format(arr.shape[1] % 28 + 1)

    def run(side, out):
        return OCR[side].get_datetimes_for_folder(
            folder, os.path.join(out, 'times.json'), ocr_fn=ocr_fn)

    (ours, ours_dir), (ref, ref_dir) = both(tmp_path, 'folder', run)
    assert ours == ref
    cd.assert_same_tree(ours_dir, ref_dir)
    assert ours['cam0/broken.jpg'] is None
