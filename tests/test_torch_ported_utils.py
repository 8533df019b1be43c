"""
The port's own copies of the JAX package's jax-free helpers, each held
against the original on the same inputs: ops/boxes (letterbox,
auto_target_shape, resize_long_side, scale_coords, xyxy2xywh),
utils/ct_utils (with the drivers' convert_xywh_to_xyxy, args_to_object,
dict_to_kvp_list, is_iterable, and the Wildlife Insights tools' is_empty,
isnan and compare_values_nan_equal), utils/path_utils (with the video
helpers, flatten_path, and the download workflow's
insert_before_extension, make_executable, delete_file and
parallel_delete_files), models/registry (with download_model and
try_download_known_detector against a loopback server),
ops/quantization.is_quantized, models/yolov5.conv_geom and
visualization/visualization_utils.load_image (its rendering is held in
tests/test_torch_run_detector.py).
"""

import argparse
import json
import os

import numpy as np
import pytest

from PIL import Image

from megadetector_tpu.models import registry as jax_registry
from megadetector_tpu.ops import boxes as jax_boxes
from megadetector_tpu.utils import ct_utils as jax_ct
from megadetector_tpu.utils import path_utils as jax_path
from megadetector_tpu.visualization import visualization_utils as jax_vis
from megadetector_tpu_torch.models import registry
from megadetector_tpu_torch.ops import boxes
from megadetector_tpu_torch.utils import ct_utils, path_utils
from megadetector_tpu_torch.visualization import visualization_utils

SHAPES = [(240, 320), (320, 240), (300, 200), (97, 131), (1080, 1920),
          (1536, 2048), (64, 64), (33, 500)]


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('auto', [True, False])
def test_letterbox_matches(shape, auto):
    img = np.random.RandomState(sum(shape)).randint(
        0, 256, shape + (3,), dtype=np.uint8)
    for new_shape, scaleup in (((256, 256), True), ((640, 640), False),
                               (320, True)):
        ours = boxes.letterbox(img, new_shape, auto=auto, scaleup=scaleup,
                               stride=32)
        ref = jax_boxes.letterbox(img, new_shape, auto=auto,
                                  scaleup=scaleup, stride=32)
        assert np.array_equal(ours[0], ref[0])
        assert ours[1:] == ref[1:]
    assert boxes.auto_target_shape(shape, 1280, stride=64) == \
        jax_boxes.auto_target_shape(shape, 1280, stride=64)
    assert boxes.auto_target_shape(shape, 640, 32, scaleup=False) == \
        jax_boxes.auto_target_shape(shape, 640, 32, scaleup=False)
    for use_ceil in (False, True):
        ours, r = boxes.resize_long_side(img, 300, use_ceil=use_ceil)
        ref, r_ref = jax_boxes.resize_long_side(img, 300, use_ceil=use_ceil)
        assert r == r_ref and np.array_equal(ours, ref)


def test_scale_coords_and_xywh_match():
    rng = np.random.RandomState(0)
    coords = rng.uniform(-20, 700, (50, 4))
    for img1, img0, ratio_pad in (((640, 640), (480, 640), None),
                                  ((384, 640), (1080, 1920), None),
                                  ((640, 640), (300, 200),
                                   ((0.5, 0.5), (3.5, 12.0)))):
        ours = boxes.scale_coords(img1, coords.copy(), img0, ratio_pad)
        ref = jax_boxes.scale_coords(img1, coords.copy(), img0, ratio_pad)
        assert np.array_equal(ours, ref)
    assert np.array_equal(boxes.xyxy2xywh(coords),
                          jax_boxes.xyxy2xywh(coords))


def test_ct_utils_match(tmp_path):
    values = [0.0003214884, 0.99999, 0.1234567, 1e-9, 0.5, 0.0049999,
              0.125, 0.3335, 2.675, 0.0]
    for precision in (3, 4):
        assert ct_utils.truncate_float_array(values, precision) == \
            jax_ct.truncate_float_array(values, precision)
        assert ct_utils.round_float_array(values, precision) == \
            jax_ct.round_float_array(values, precision)
        for v in values:
            assert ct_utils.truncate_float(v, precision) == \
                jax_ct.truncate_float(v, precision)
            assert ct_utils.round_float(v, precision) == \
                jax_ct.round_float(v, precision)
    box = [0.5, 0.4, 0.2, 0.1]
    assert ct_utils.convert_yolo_to_xywh(box) == \
        jax_ct.convert_yolo_to_xywh(box)
    dicts = [{'k': 3}, {'k': None}, {'k': 1}, {'j': 2}]
    for kwargs in ({}, {'reverse': True}, {'none_handling': 'largest'}):
        assert ct_utils.sort_list_of_dicts_by_key(dicts, 'k', **kwargs) == \
            jax_ct.sort_list_of_dicts_by_key(dicts, 'k', **kwargs)
    items = ['a=1', 'b = two', 'flag', 'c=x=y']
    assert ct_utils.parse_kvp_list(items) == jax_ct.parse_kvp_list(items)
    assert ct_utils.parse_kvp_list(None) == jax_ct.parse_kvp_list(None)
    content = {'images': [{'file': 'a', 'v': np.float32(0.5)}]}
    ct_utils.write_json(str(tmp_path / 'ours.json'), content, force_str=True)
    jax_ct.write_json(str(tmp_path / 'ref.json'), content, force_str=True)
    assert (tmp_path / 'ours.json').read_bytes() == \
        (tmp_path / 'ref.json').read_bytes()


def test_path_utils_match(tmp_path):
    for rel in ('a.jpg', 'b.PNG', 'c.txt', 'sub/d.jpeg', 'sub/deeper/e.tif',
                'sub/f.json', 'g.webp'):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b'x')
    for recursive in (False, True):
        for relative in (False, True):
            assert path_utils.find_images(
                str(tmp_path), recursive=recursive,
                return_relative_paths=relative) == jax_path.find_images(
                    str(tmp_path), recursive=recursive,
                    return_relative_paths=relative)
    listing = tmp_path / 'list.txt'
    listing.write_text('x.jpg\n\n  y.jpg  \n')
    as_json = tmp_path / 'list.json'
    as_json.write_text(json.dumps(['p.jpg', 'q.jpg']))
    for f in (listing, as_json):
        assert path_utils.read_list_from_file(str(f)) == \
            jax_path.read_list_from_file(str(f))


EMPTY_VALUES = [None, '', '  ', ' x ', 'x', float('nan'), 0.0, 0, 1.5,
                np.float64('nan'), np.float32(1.0), 'nan', ('a',)]


@pytest.mark.parametrize('strip', [True, False])
def test_wi_ct_utils_match(strip):
    for v in EMPTY_VALUES:
        assert ct_utils.is_empty(v, strip_strings=strip) == \
            jax_ct.is_empty(v, strip_strings=strip), v
        assert ct_utils.isnan(v) == jax_ct.isnan(v), v
        for w in EMPTY_VALUES:
            assert ct_utils.compare_values_nan_equal(v, w) == \
                jax_ct.compare_values_nan_equal(v, w), (v, w)
    assert ct_utils.is_empty(float('nan')) and ct_utils.is_empty('  ')
    assert not ct_utils.is_empty('  ', strip_strings=False)
    assert ct_utils.compare_values_nan_equal(float('nan'), float('nan'))


def test_wi_path_utils_match(tmp_path, monkeypatch):
    for name, s, sep in (('a/b.jpg', 'x', '.'), ('a/b.c.JPG', '00', '_'),
                         ('noext', 'tag', '.'), ('d/e.sh', '', '.')):
        if s:
            assert path_utils.insert_before_extension(name, s, sep) == \
                jax_path.insert_before_extension(name, s, sep)
    import datetime
    fixed = datetime.datetime(2024, 5, 6, 7, 8, 9)

    class Frozen(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return fixed

    monkeypatch.setattr(datetime, 'datetime', Frozen)
    assert path_utils.insert_before_extension('a/b.jpg') == \
        jax_path.insert_before_extension('a/b.jpg') == \
        'a/b.2024.05.06.07.08.09.jpg'
    monkeypatch.undo()
    for module, tag in ((path_utils, 'ours'), (jax_path, 'ref')):
        script = tmp_path / (tag + '.sh')
        script.write_text('echo x\n')
        script.chmod(0o640)
        assert module.make_executable(str(script)) is True
        assert oct(script.stat().st_mode & 0o777) == oct(0o751)
        assert module.make_executable(str(tmp_path / 'missing'),
                                      catch_exceptions=True) is False
        with pytest.raises(OSError):
            module.make_executable(str(tmp_path / 'missing'))
        files = []
        for i in range(25):
            f = tmp_path / tag / 'f{:02d}.bin'.format(i)
            f.parent.mkdir(exist_ok=True)
            f.write_bytes(b'x')
            files.append(str(f))
        assert module.delete_file(files[0]) is True
        assert module.delete_file(files[0]) is False
        module.parallel_delete_files(files + [str(tmp_path / 'gone')],
                                     max_workers=4)
        assert os.listdir(str(tmp_path / tag)) == []


@pytest.mark.parametrize('box', [[0.1, 0.2, 0.3, 0.4], [0, 0, 1, 1],
                                 [0.5, 0.25, 0.0, 0.125]])
def test_driver_ct_utils_match(box):
    assert ct_utils.convert_xywh_to_xyxy(box) == \
        jax_ct.convert_xywh_to_xyxy(box)
    for x in (box, 'abc', 3, None, {'a': 1}, (i for i in box)):
        assert ct_utils.is_iterable(x) == jax_ct.is_iterable(x)
    d = {'dtype': 'bf16', 'conv_backend': 'pallas', 'n': 3}
    for handling in ('omit', 'convert'):
        for sep in ((' ', '='), (',', ':')):
            assert ct_utils.dict_to_kvp_list(
                d, *sep, non_string_value_handling=handling) == \
                jax_ct.dict_to_kvp_list(d, *sep,
                                        non_string_value_handling=handling)
    for module in (ct_utils, jax_ct):
        with pytest.raises(ValueError, match='n'):
            module.dict_to_kvp_list(d)
    args = argparse.Namespace(frame_sample=4, device='cpu', _hidden=1)
    ours, ref = ct_utils.args_to_object(args, argparse.Namespace()), \
        jax_ct.args_to_object(args, argparse.Namespace())
    assert vars(ours) == vars(ref) == {'frame_sample': 4, 'device': 'cpu'}


def test_video_path_utils_match(tmp_path):
    for rel in ('a.mp4', 'b.AVI', 'c.jpg', 'sub/d.mov', 'sub/deeper/e.mkv',
                'sub/f.txt', 'g.mpeg', 'h.flv', 'i.mpg'):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b'x')
    assert path_utils.VIDEO_EXTENSIONS == jax_path.VIDEO_EXTENSIONS
    for recursive in (False, True):
        for relative in (False, True):
            ours = path_utils.find_videos(str(tmp_path), recursive=recursive,
                                          return_relative_paths=relative)
            assert ours == jax_path.find_videos(
                str(tmp_path), recursive=recursive,
                return_relative_paths=relative)
    assert len(ours) == 7
    names = ['x.MP4', 'y.jpg', 'z.avi/frame000000.jpg', 'w.mkv', 'v']
    assert path_utils.find_video_strings(names) == \
        jax_path.find_video_strings(names) == ['x.MP4', 'w.mkv']
    for name in names + ['a/b\\c:d.jpg', 'C:\\x\\y.mp4']:
        assert path_utils.is_video_file(name) == jax_path.is_video_file(name)
        assert path_utils.flatten_path(name) == jax_path.flatten_path(name)
        assert path_utils.flatten_path(name, '/', '#') == \
            jax_path.flatten_path(name, '/', '#')


def test_registry_matches():
    assert registry.model_string_to_model_version == \
        jax_registry.model_string_to_model_version
    assert registry.DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD == \
        jax_registry.DEFAULT_OUTPUT_CONFIDENCE_THRESHOLD
    assert registry.DEFAULT_RENDERING_CONFIDENCE_THRESHOLD == \
        jax_registry.DEFAULT_RENDERING_CONFIDENCE_THRESHOLD == 0.2
    for name in ('md_v5a.0.0.pt', 'MDV5B.npz', 'md_v1000.0.0-redwood.pt',
                 'something_else.npz', 'md_v4.1.0.pb'):
        version = registry.get_detector_version_from_filename(name)
        assert version == jax_registry.get_detector_version_from_filename(
            name)
        assert registry.get_detector_metadata_from_version_string(
            version) == \
            jax_registry.get_detector_metadata_from_version_string(version)


def test_registry_model_folder_lookup(tmp_path, monkeypatch):
    monkeypatch.setenv('MD_MODEL_FOLDER', str(tmp_path))
    assert registry.get_default_model_folder() == \
        jax_registry.get_default_model_folder()
    assert registry.find_converted_checkpoint('v5a.0.1') is None
    (tmp_path / 'md_v5a.0.1.npz').write_bytes(b'')
    assert registry.find_converted_checkpoint('v5a.0.1') == \
        jax_registry.find_converted_checkpoint('v5a.0.1')


def test_load_image_matches(tmp_path):
    rng = np.random.RandomState(1)
    rgba = rng.randint(0, 256, (20, 30, 4), dtype=np.uint8)
    Image.fromarray(rgba, 'RGBA').save(str(tmp_path / 'a.png'))
    gray = rng.randint(0, 256, (12, 9), dtype=np.uint8)
    Image.fromarray(gray, 'L').save(str(tmp_path / 'b.png'))
    rotated = Image.fromarray(rng.randint(0, 256, (10, 16, 3),
                                          dtype=np.uint8))
    exif = rotated.getexif()
    exif[274] = 6
    rotated.save(str(tmp_path / 'c.jpg'), exif=exif)
    for name in ('a.png', 'b.png', 'c.jpg'):
        for ignore in (False, True):
            ours = visualization_utils.load_image(str(tmp_path / name),
                                                  ignore)
            ref = jax_vis.load_image(str(tmp_path / name), ignore)
            assert ours.mode == ref.mode and ours.size == ref.size
            assert np.array_equal(np.asarray(ours), np.asarray(ref))


#%% registry downloads (over loopback), is_quantized, conv_geom


@pytest.fixture
def model_site(tmp_path, monkeypatch):
    """A loopback server holding a fake checkpoint for every known model,
    with every known_models URL of each package pointed at it (so nothing
    can reach the network): MD5s are the fake files' own, and v5b.0.0 has
    none. MD_MODEL_FOLDER is a temporary folder."""

    import hashlib
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_format_data import free_port
    from megadetector_tpu_torch.utils import url_utils

    served = tmp_path / 'served'
    served.mkdir()
    rng = np.random.RandomState(0)
    blobs = {}
    for version in sorted(registry.known_models):
        name = registry.known_models[version]['url'].split('/')[-1]
        blobs[name] = rng.bytes(int(rng.randint(500, 3000)))
        (served / name).write_bytes(blobs[name])
    base = url_utils.SingletonHTTPServer.start_server(
        str(served), port=free_port(), host='127.0.0.1')
    for module in (jax_registry, registry):
        for version, entry in list(module.known_models.items()):
            name = entry['url'].split('/')[-1]
            entry = dict(entry, url=base + '/' + name)
            if 'md5' in entry:
                entry['md5'] = hashlib.md5(blobs[name]).hexdigest()
            if version == 'v5b.0.0':
                entry.pop('md5')
            monkeypatch.setitem(module.known_models, version, entry)
    monkeypatch.setenv('MD_MODEL_FOLDER', str(tmp_path / 'models'))
    yield dict(served=served, blobs=blobs, root=tmp_path)
    url_utils.SingletonHTTPServer.stop_server()


def test_download_model_matches(model_site, capsys):
    out = []
    for side, module in enumerate((jax_registry, registry)):
        folder = str(model_site['root'] / 'dl{}'.format(side))
        os.makedirs(folder)
        got = []
        for version in ('v5a.0.0', 'v5b.0.0'):
            path = module.download_model(version, model_folder=folder)
            got.append((os.path.basename(path), open(path, 'rb').read()))
        # A corrupt file is re-downloaded (the MD5 check)
        path = os.path.join(folder, 'md_v5a.0.0.pt')
        with open(path, 'wb') as f:
            f.write(b'corrupt')
        module.download_model('v5a.0.0', model_folder=folder)
        got.append(open(path, 'rb').read())
        # The default folder is MD_MODEL_FOLDER
        got.append(os.path.relpath(module.download_model('v5b.0.0'),
                                   str(model_site['root'])))
        printed = capsys.readouterr().out.replace(folder, '<folder>')
        out.append((got, printed.count('MD5 mismatch')))
    assert out[0] == out[1]
    assert out[1][0][0] == ('md_v5a.0.0.pt',
                            model_site['blobs']['md_v5a.0.0.pt'])
    assert out[1][0][2] == model_site['blobs']['md_v5a.0.0.pt']
    assert out[1][1] == 1


def test_download_model_refusals_match(model_site, monkeypatch):
    for side, module in enumerate((jax_registry, registry)):
        folder = str(model_site['root'] / 'bad{}'.format(side))
        with pytest.raises(AssertionError):
            module.download_model('v9', model_folder=folder)
        monkeypatch.setitem(module.known_models, 'v5a.0.0', dict(
            module.known_models['v5a.0.0'], md5='0' * 32))
        with pytest.raises(IOError, match='MD5'):
            module.download_model('v5a.0.0', model_folder=folder)


def test_download_model_force_redownloads_where_jax_does_not(model_site):
    """A known fault of the JAX function: force_download=True hands the
    existing file to url_utils.download_url, which skips a file that is on
    disk, so nothing is fetched again. The port fetches it."""

    out = []
    for side, module in enumerate((jax_registry, registry)):
        folder = str(model_site['root'] / 'force{}'.format(side))
        os.makedirs(folder)
        stale = os.path.join(folder, 'md_v5b.0.0.pt')
        with open(stale, 'wb') as f:
            f.write(b'stale copy')
        path = module.download_model('v5b.0.0', force_download=True,
                                     model_folder=folder)
        out.append(open(path, 'rb').read())
    assert out[0] == b'stale copy'
    assert out[1] == model_site['blobs']['md_v5b.0.0.pt']


def test_try_download_known_detector_matches(model_site, monkeypatch):
    existing = str(model_site['root'] / 'mine.npz')
    open(existing, 'wb').close()
    monkeypatch.setenv('MY_DETECTOR', existing)
    models = model_site['root'] / 'models'
    out = []
    for module in (jax_registry, registry):
        got = [module.try_download_known_detector(name, verbose=True)
               for name in (None, existing, 'MY_DETECTOR', 'not_a_model',
                            'MDV5B')]
        # A converted checkpoint on disk wins over a download
        converted = models / 'md_v5a.0.1.npz'
        converted.write_bytes(b'')
        got.append(module.try_download_known_detector('mdv5a'))
        converted.unlink()
        got.append(module.try_download_known_detector('mdv5a'))
        out.append(got)
        for f in models.iterdir():
            f.unlink()
    assert out[0] == out[1]
    assert out[1][4] == str(models / 'md_v5b.0.1.pt')
    assert out[1][5] == str(models / 'md_v5a.0.1.npz')
    assert out[1][6] == str(models / 'md_v5a.0.1.pt')


def test_is_quantized_matches():
    import torch
    from megadetector_tpu.ops import quantization as jax_q
    from megadetector_tpu_torch.models.yolov5 import Conv, QConv
    from megadetector_tpu_torch.ops import quantization as q

    nodes = [{'w_q': np.zeros((1, 1, 1, 1), np.int8), 'w_scale': 1.0},
             {'w': np.zeros((1, 1, 1, 1), np.float32)}, {}, None, [],
             'w_q', {'cv1': {'w_q': 1}}]
    for node in nodes:
        assert q.is_quantized(node) == jax_q.is_quantized(node)
    conv = Conv(8, 16, 3, 1)
    assert not q.is_quantized(conv)
    qconv = QConv(conv, {'w_q': torch.zeros((16, 3, 3, 8), dtype=torch.int8),
                         'w_scale': torch.ones(16), 'b': torch.zeros(16)})
    assert q.is_quantized(qconv)


@pytest.mark.parametrize('stride,pad,k', [
    (1, None, 3), (2, None, 6), ((2, 1), 0, 1), (1, 2, 5),
    (1, [(0, 1), (1, 0)], 3), ((1, 2), None, 1)])
def test_conv_geom_matches(stride, pad, k):
    from megadetector_tpu.models import yolov5 as jax_yolov5
    from megadetector_tpu_torch.models import yolov5

    assert yolov5.conv_geom(stride, pad, k) == \
        jax_yolov5.conv_geom(stride, pad, k)


#%% The rest of ct_utils, path_utils and visualization_utils: each function
# of the three JAX modules that the port had not needed, against its
# original


CT_CALLS = [
    ('convert_xywh_to_tf', ([0.1, 0.2, 0.3, 0.4],), {}),
    ('point_dist', ((1.0, 2.0), (4.0, -2.0)), {}),
    ('rect_distance', ((0, 0, 1, 1), (3, 4, 5, 6)), {}),
    ('rect_distance', ((0, 0, 2, 2), (1, 1, 3, 3)), {}),
    ('rect_distance', ((0, 0, 1, 1), (2.5, 0.5, 1, 1)),
     {'format': 'x0y0wh'}),
    ('is_list_sorted', ([1, 2, 2, 5],), {}),
    ('is_list_sorted', ([1, 3, 2],), {}),
    ('is_list_sorted', ([5, 3, 3, 1],), {'reverse': True}),
    ('split_list_into_fixed_size_chunks', (list(range(11)), 4), {}),
    ('split_list_into_fixed_size_chunks', ([], 3), {}),
    ('sort_dictionary_by_key', ({'b': 1, 'a': 3, 'c': 2},), {}),
    ('sort_dictionary_by_key', ({'b': 1, 'a': 3, 'c': 2},),
     {'reverse': True}),
    ('sort_dictionary_by_value', ({'b': 1, 'a': 3, 'c': 2},), {}),
    ('sort_dictionary_by_value', ({'b': [1, 9], 'a': [3], 'c': []},),
     {'sort_values': len, 'reverse': True}),
    ('sets_overlap', ([1, 2], (2, 3)), {}),
    ('sets_overlap', ({'a'}, ['b']), {}),
    ('min_none', (None, 3), {}), ('min_none', (2, None), {}),
    ('min_none', (2, 1), {}), ('min_none', (None, None), {}),
    ('max_none', (None, 3), {}), ('max_none', (2, None), {}),
    ('max_none', (2, 5), {}),
    ('round_floats_in_nested_dict',
     ({'a': 1.234567891, 'b': [0.1111119, {'c': 2.0000049}], 'd': 'x',
       'e': 3},), {}),
    ('round_floats_in_nested_dict', ([1.23456, [7.654321]],),
     {'decimal_places': 2}),
    ('round_floats_in_nested_dict', (1.005,), {'decimal_places': 2}),
    ('to_bool', ('Yes',), {}), ('to_bool', (' f ',), {}),
    ('to_bool', (0.0,), {}), ('to_bool', (7,), {}),
    ('to_bool', ('maybe',), {}), ('to_bool', (None,), {}),
    ('to_bool', (False,), {}),
    ('is_function_name', ('len', {'len': len, 'x': 1}), {}),
    ('is_function_name', ('x', {'len': len, 'x': 1}), {}),
    ('is_function_name', ('y', {}), {}),
]


@pytest.mark.parametrize('name,args,kwargs', CT_CALLS,
                         ids=['{}-{}'.format(c[0], i)
                              for i, c in enumerate(CT_CALLS)])
def test_rest_of_ct_utils_match(name, args, kwargs):
    import copy
    ours = getattr(ct_utils, name)(*copy.deepcopy(args), **kwargs)
    ref = getattr(jax_ct, name)(*copy.deepcopy(args), **kwargs)
    assert ours == ref and type(ours) is type(ref)


@pytest.mark.parametrize('value', [True, 'TRUE', ' yes', 'y', 't', '1',
                                   'False', 'no', 'n', 'f', '0', 'other',
                                   '', 3])
@pytest.mark.parametrize('strict', [False, True])
def test_parse_bool_string_matches(value, strict):
    def call(module):
        try:
            return module.parse_bool_string(value, strict=strict)
        except (ValueError, AssertionError) as e:
            return type(e).__name__
    assert call(ct_utils) == call(jax_ct)


def test_ct_utils_objects_json_and_sorting_match(tmp_path, capsys):
    import types
    im = {'file': 'a', 'detections': [
        {'conf': 0.2, 'classifications': [['1', 0.1], ['2', 0.7]]},
        {'conf': 0.9},
        {'conf': 0.5, 'classifications': [['3', 0.4], ['4', 0.6]]}]}
    ours, ref = json.loads(json.dumps(im)), json.loads(json.dumps(im))
    assert ct_utils.sort_results_for_image(ours) is \
        jax_ct.sort_results_for_image(ref)
    assert ours == ref
    for failed in ({'file': 'b', 'detections': None}, 'not a dict'):
        ct_utils.sort_results_for_image(failed)
        jax_ct.sort_results_for_image(failed)

    d = {'a': 1, '_hidden': 2, 'b': [3]}
    o1 = ct_utils.dict_to_object(d, types.SimpleNamespace())
    o2 = jax_ct.dict_to_object(d, types.SimpleNamespace())
    assert vars(o1) == vars(o2) == {'a': 1, 'b': [3]}

    (tmp_path / 'x.json').write_text('{"k": [1, 2, "\\u00e9"]}',
                                     encoding='utf-8')
    assert ct_utils.read_json(str(tmp_path / 'x.json')) == \
        jax_ct.read_json(str(tmp_path / 'x.json'))

    obj = {'n': 1, 'o': types.SimpleNamespace(p=2, _q=3), 'z': {1, 2}}
    for b_print in (True, False):
        capsys.readouterr()
        ours = ct_utils.pretty_print_object(obj, b_print)
        printed = capsys.readouterr().out
        ref = jax_ct.pretty_print_object(obj, b_print)
        assert ours == ref and printed == capsys.readouterr().out


def test_ct_utils_temp_folders_and_environment_match(tmp_path,
                                                     monkeypatch):
    import tempfile
    import uuid
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    fixed = uuid.UUID('12345678123456781234567812345678')
    monkeypatch.setattr(uuid, 'uuid4', lambda: fixed)
    for kwargs in ({}, {'top_level_folder': 'x', 'subfolder': 's'},
                   {'append_guid': False}):
        ours = ct_utils.make_temp_folder(**kwargs)
        assert ours == jax_ct.make_temp_folder(**kwargs)
        assert os.path.isdir(ours) and ours.startswith(str(tmp_path))
    for sub in (None, 'unit'):
        assert ct_utils.make_test_folder(sub) == jax_ct.make_test_folder(sub)

    for value in ('true', 'false', None):
        if value is None:
            monkeypatch.delenv('GITHUB_ACTIONS', raising=False)
        else:
            monkeypatch.setenv('GITHUB_ACTIONS', value)
        assert ct_utils.is_running_in_gha() == jax_ct.is_running_in_gha()
    for argv0 in ('sphinx-build', '/usr/bin/python'):
        monkeypatch.setattr(argparse._sys, 'argv', [argv0])
        assert ct_utils.is_sphinx_build() == jax_ct.is_sphinx_build()
    assert ct_utils.environment_is_wsl() == jax_ct.environment_is_wsl()


def test_run_all_module_tests_calls_pytest_as_jax_does(monkeypatch):
    """Both run pytest -q on their module's test file in a child and
    return its code; the subprocess call is replaced here, nothing runs."""

    import subprocess
    import sys
    calls = []

    def fake_call(args):
        calls.append(args)
        return 3

    monkeypatch.setattr(subprocess, 'call', fake_call)
    assert ct_utils.run_all_module_tests() == 3
    assert jax_ct.run_all_module_tests() == 3
    ours, ref = calls
    assert ours[:4] == ref[:4] == [sys.executable, '-m', 'pytest', '-q']
    assert os.path.basename(ours[4]) == 'test_torch_ported_utils.py'
    assert os.path.basename(ref[4]) == 'test_ct_utils.py'
    assert os.path.dirname(ours[4]) == os.path.dirname(ref[4])


def _tree(root):
    """A small folder tree of images, text and empty folders."""

    rng = np.random.RandomState(3)
    for rel in ('a.jpg', 'b.PNG', 'c.txt', 'sub/d.jpeg', 'sub/deep/e.tif',
                'sub/f.json', 'g.webp', 'sub2/h.txt'):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(rng.bytes(int(rng.randint(1, 4000))))
    (root / 'empty' / 'nested').mkdir(parents=True)
    (root / 'sub2' / 'void').mkdir()
    return root


PATH_STRING_CALLS = [
    ('find_image_strings', (['a.jpg', 'b.txt', 'c.PNG', 'd', 'e.avif'],)),
    ('split_path', ('a/b/c.jpg',)), ('split_path', ('/x/y/',)),
    ('split_path', ('',)), ('split_path', ('file',)),
    ('top_level_folder', ('a/b/c',)), ('top_level_folder', ('/a/b/c',)),
    ('top_level_folder', ('',)), ('top_level_folder', ('/',)),
    ('clean_filename', ('  héllo wörld?<>.jpg ',)),
    ('clean_filename', ('ABC def.txt',),
     {'force_lower': True, 'replace_whitespace': '_', 'char_limit': 5}),
    ('clean_filename', ('\tx y\n',),
     {'remove_trailing_leading_whitespace': False}),
    ('clean_path', ('c:\\a/b?/ç d.jpg',)),
    ('clean_path', ('A/B/C.JPG',), {'force_lower': True}),
    ('fileparts', ('c/d/file.jpg',)), ('fileparts', ('noext',)),
    ('fileparts', ('/a/.hidden',)),
    ('path_join', ('a', 'b\\c', 'd.jpg')),
    ('path_join', ('a', 'b\\c'), {'convert_slashes': False}),
    ('windows_path_to_wsl_path', ('C:\\temp\\foo.jpg',)),
    ('windows_path_to_wsl_path', ('relative\\x',)),
    ('wsl_path_to_windows_path', ('/mnt/c/temp/foo',)),
    ('wsl_path_to_windows_path', ('/home/x',)),
    ('wsl_path_to_windows_path', ('/mnt/',)),
]


@pytest.mark.parametrize('call', PATH_STRING_CALLS,
                         ids=['{}-{}'.format(c[0], i)
                              for i, c in enumerate(PATH_STRING_CALLS)])
def test_path_string_helpers_match(call):
    name, args = call[0], call[1]
    kwargs = call[2] if len(call) > 2 else {}
    assert getattr(path_utils, name)(*args, **kwargs) == \
        getattr(jax_path, name)(*args, **kwargs)


def test_path_listing_helpers_match(tmp_path, capsys):
    root = _tree(tmp_path / 'tree')
    for kwargs in ({}, {'recursive': True}, {'return_relative_paths': True,
                                             'recursive': True},
                   {'sort_files': False, 'convert_slashes': False}):
        ours = path_utils.file_list(str(root), **kwargs)
        ref = jax_path.file_list(str(root), **kwargs)
        assert (sorted(ours), ours if kwargs.get('sort_files', True)
                else None) == (sorted(ref), ref if kwargs.get(
                    'sort_files', True) else None)
    for kwargs in ({}, {'recursive': True},
                   {'recursive': True, 'return_relative_paths': True},
                   {'convert_slashes': False}):
        assert path_utils.folder_list(str(root), **kwargs) == \
            jax_path.folder_list(str(root), **kwargs)
    for print_summary in (True, False):
        capsys.readouterr()
        ours = path_utils.folder_summary(str(root), print_summary)
        printed = capsys.readouterr().out
        assert ours == jax_path.folder_summary(str(root), print_summary)
        assert printed == capsys.readouterr().out
    files = path_utils.file_list(str(root), recursive=True)
    for kwargs in ({}, {'max_workers': 4}, {'return_relative_paths': False},
                   {'max_workers': 2, 'use_threads': False}):
        assert path_utils.get_file_sizes(str(root), **kwargs) == \
            jax_path.get_file_sizes(str(root), **kwargs)
    missing = files[:3] + [str(root / 'missing.jpg')]
    for kwargs in ({}, {'max_workers': 3}, {'convert_slashes': False}):
        assert path_utils.get_file_sizes(missing, **kwargs) == \
            jax_path.get_file_sizes(missing, **kwargs)
    assert path_utils.is_executable(files[0]) == \
        jax_path.is_executable(files[0]) is False
    os.chmod(files[0], 0o755)
    assert path_utils.is_executable(files[0]) == \
        jax_path.is_executable(files[0]) is True
    assert path_utils.is_executable(str(root / 'none')) == \
        jax_path.is_executable(str(root / 'none'))


def test_path_hashes_copies_and_writes_match(tmp_path):
    root = _tree(tmp_path / 'tree')
    files = path_utils.file_list(str(root), recursive=True) + \
        [str(root / 'missing.bin')]
    for algorithm in ('sha256', 'md5'):
        for fn in files:
            assert path_utils.compute_file_hash(fn, algorithm) == \
                jax_path.compute_file_hash(fn, algorithm)
        assert path_utils.parallel_compute_file_hashes(
            files, algorithm, max_workers=4) == \
            jax_path.parallel_compute_file_hashes(files, algorithm,
                                                  max_workers=4)
    with pytest.raises(FileNotFoundError):
        path_utils.compute_file_hash(files[-1], allow_failures=False)
    # A spawned process pool (JAX's lambda cannot be pickled to one)
    assert path_utils.parallel_compute_file_hashes(
        files, max_workers=2, use_threads=False) == \
        jax_path.parallel_compute_file_hashes(files)

    for move in (False, True):
        pairs = {}
        for package, out in ((path_utils, 'ours'), (jax_path, 'ref')):
            src = tmp_path / 'src_{}_{}'.format(out, move)
            src.mkdir()
            (src / 'x.bin').write_bytes(b'abc')
            dst = tmp_path / out / str(move) / 'deep' / 'x.bin'
            assert package.copy_file(str(src / 'x.bin'), str(dst),
                                     move=move) == str(dst)
            pairs[out] = (src, dst)
            assert (src / 'x.bin').exists() is not move
            (src / 'y.bin').write_bytes(b'new')
            assert package.copy_file(str(src / 'y.bin'), str(dst),
                                     overwrite=False) == str(dst)
            assert dst.read_bytes() == b'abc'
    mapping = {f: str(tmp_path / 'copies' / os.path.basename(f))
               for f in files[:-1]}
    for package, use_threads in ((jax_path, True), (path_utils, True),
                                 (path_utils, False)):
        if os.path.isdir(str(tmp_path / 'copies')):
            import shutil
            shutil.rmtree(str(tmp_path / 'copies'))
        package.parallel_copy_files(mapping, max_workers=3,
                                    use_threads=use_threads)
        for src, dst in mapping.items():
            with open(src, 'rb') as a, open(dst, 'rb') as b:
                assert a.read() == b.read()

    strings = ['a', 'b c', 'é']
    for ext in ('.txt', '.json'):
        path_utils.write_list_to_file(str(tmp_path / ('o' + ext)), strings)
        jax_path.write_list_to_file(str(tmp_path / ('r' + ext)), strings)
        assert (tmp_path / ('o' + ext)).read_bytes() == \
            (tmp_path / ('r' + ext)).read_bytes()

    target = tmp_path / 'writable.txt'
    for overwrite in (True, False):
        assert path_utils.test_file_write(str(target), overwrite) == \
            jax_path.test_file_write(str(target), overwrite)
    assert path_utils.test_file_write(str(tmp_path / 'no' / 'x')) == \
        jax_path.test_file_write(str(tmp_path / 'no' / 'x'))


def test_remove_empty_folders_matches(tmp_path):
    results = []
    for package, name in ((path_utils, 'ours'), (jax_path, 'ref')):
        root = _tree(tmp_path / name)
        first = package.remove_empty_folders(str(root))
        listing = sorted(os.path.relpath(os.path.join(r, d), str(root))
                         for r, ds, _ in os.walk(str(root)) for d in ds)
        empty = root / 'only_empty'
        (empty / 'a' / 'b').mkdir(parents=True)
        second = package.remove_empty_folders(str(empty), remove_root=True)
        third = package.remove_empty_folders(str(root / 'nothing'))
        results.append((first, listing, second, empty.exists(), third))
    assert results[0] == results[1]


def _archive_inputs(tmp_path, name):
    root = _tree(tmp_path / name)
    files = path_utils.file_list(str(root), recursive=True)
    # Fixed times: archives record each file's mtime
    for fn in files:
        os.utime(fn, (1600000000, 1600000000))
    return root, files


def test_zip_and_tar_helpers_write_jax_bytes(tmp_path):
    outputs = {}
    for package, name in ((path_utils, 'ours'), (jax_path, 'ref')):
        root, files = _archive_inputs(tmp_path, name)
        out = tmp_path / ('out_' + name)
        out.mkdir()
        got = [
            package.zip_file(files[0], str(out / 'one.zip')),
            package.zip_file(files[1], str(out / 'one.zip'),
                             overwrite=False),
            package.zip_file(files[2], str(out / 'low.zip'),
                             compress_level=1),
            package.zip_folder(str(root / 'sub'), str(out / 'sub.zip')),
            package.zip_folder(str(root / 'sub'), str(out / 'sub.zip'),
                               verbose=True),
            package.zip_files_into_single_zipfile(
                files, str(out / 'all.zip'), arc_name_base=str(root)),
            package.zip_files_into_single_zipfile(
                files[:2], str(out / 'flat.zip')),
            package.add_files_to_single_tar_file(
                files, str(out / 'all.tar'), str(root)),
            package.add_files_to_single_tar_file(
                files[:1], str(out / 'all.tar'), str(root), overwrite=True),
        ]
        outputs[name] = ([os.path.relpath(g, str(tmp_path)).split(
            os.sep, 1)[1] for g in got],
            {fn: (out / fn).read_bytes() for fn in sorted(os.listdir(
                str(out)))})
    assert outputs['ours'] == outputs['ref']


def test_parallel_zip_and_unzip_helpers_match(tmp_path):
    outputs = {}
    for package, name in ((path_utils, 'ours'), (jax_path, 'ref')):
        root, files = _archive_inputs(tmp_path, name)
        zips = package.parallel_zip_files(files[:3], max_workers=2)
        assert zips == [f + '.zip' for f in files[:3]]
        folders = [str(root / 'sub'), str(root / 'sub2')]
        assert package.parallel_zip_folders(folders, max_workers=2) == \
            [f + '.zip' for f in folders]
        each = package.zip_each_file_in_folder(str(root), overwrite=True)
        token = package.zip_each_file_in_folder(
            str(root), recursive=True, required_token='deep',
            overwrite=True)
        unzip_src = tmp_path / ('unzip_' + name)
        unzip_src.mkdir()
        import shutil
        for z in zips:
            shutil.copy(z, str(unzip_src))
        unzipped = package.parallel_unzip_files(
            sorted(str(unzip_src / f) for f in os.listdir(str(unzip_src))),
            max_workers=2)
        tree = {}
        for r, _, fs in os.walk(str(root)):
            for f in fs:
                p = os.path.join(r, f)
                with open(p, 'rb') as fh:
                    tree[os.path.relpath(p, str(root))] = fh.read()
        for r, _, fs in os.walk(str(unzip_src)):
            for f in fs:
                p = os.path.join(r, f)
                with open(p, 'rb') as fh:
                    tree['unzip/' + os.path.relpath(p, str(unzip_src))] = \
                        fh.read()
        rel = lambda ps: [os.path.relpath(p, str(tmp_path / name))  # noqa
                          if p.startswith(str(tmp_path / name)) else
                          os.path.relpath(p, str(unzip_src))
                          for p in ps]
        outputs[name] = (rel(each), rel(token), rel(unzipped), tree)
    assert outputs['ours'] == outputs['ref']


@pytest.mark.parametrize('system,found', [
    ('Linux', 'google-chrome'), ('Linux', None),
    ('Darwin', '/Applications/Google Chrome.app/Contents/MacOS/'
               'Google Chrome'),
    ('Windows', 'chrome.exe')])
def test_open_file_in_chrome_issues_jax_commands(tmp_path, monkeypatch,
                                                 system, found):
    """The browser lookup and the launch are replaced: nothing starts."""

    import platform
    import shutil
    import subprocess
    launched = []

    class FakePopen:
        def __init__(self, args, **kwargs):
            launched.append(list(args))

    monkeypatch.setattr(platform, 'system', lambda: system)
    monkeypatch.setattr(shutil, 'which',
                        lambda c: c if c == found else None)
    monkeypatch.setattr(subprocess, 'Popen', FakePopen)
    target = str(tmp_path / 'page.html')
    assert path_utils.open_file_in_chrome(target) is True
    assert jax_path.open_file_in_chrome(target) is True
    assert len(launched) == 2 and launched[0] == launched[1]


@pytest.mark.parametrize('platform_name,wsl', [
    ('linux', False), ('linux', True), ('darwin', False)])
def test_open_file_issues_jax_commands(tmp_path, monkeypatch, platform_name,
                                       wsl):
    import subprocess
    import sys
    launched = []

    class FakePopen:
        def __init__(self, args, **kwargs):
            launched.append(list(args))

    monkeypatch.setattr(subprocess, 'Popen', FakePopen)
    monkeypatch.setattr(sys, 'platform', platform_name)
    monkeypatch.setattr(ct_utils, 'environment_is_wsl', lambda: wsl)
    monkeypatch.setattr(jax_ct, 'environment_is_wsl', lambda: wsl)
    for target in ('/mnt/c/x/page.html', str(tmp_path / 'page.html')):
        for attempt in (False, True):
            launched.clear()
            assert path_utils.open_file(target, attempt) is None
            assert jax_path.open_file(target, attempt) is None
            assert len(launched) == 2 and launched[0] == launched[1]


def test_open_file_failure_is_printed_as_in_jax(monkeypatch, capsys):
    import subprocess

    def refuse(*args, **kwargs):
        raise OSError('no viewer')

    monkeypatch.setattr(subprocess, 'Popen', refuse)
    path_utils.open_file('x.html')
    ours = capsys.readouterr().out
    jax_path.open_file('x.html')
    assert ours == capsys.readouterr().out and 'no viewer' in ours


def _vis_images(root):
    rng = np.random.RandomState(7)
    root.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (90, 120, 3), dtype=np.uint8)).save(
        str(root / 'rgb.jpg'), quality=90)
    Image.fromarray(rng.randint(0, 256, (40, 64), dtype=np.uint8),
                    'L').save(str(root / 'gray.png'))
    gray_rgb = np.repeat(rng.randint(0, 256, (50, 50, 1), dtype=np.uint8),
                         3, axis=2)
    gray_rgb[:5, :5, 0] = 0
    Image.fromarray(gray_rgb).save(str(root / 'ir.png'))
    (root / 'sub').mkdir(exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (30, 45, 3), dtype=np.uint8)).save(
        str(root / 'sub' / 'small.png'))
    (root / 'broken.jpg').write_bytes(b'\xff\xd8\xff\xe0not a jpeg')
    (root / 'notes.txt').write_text('x')
    return root


DETECTIONS = [
    {'category': '1', 'conf': 0.9, 'bbox': [0.1, 0.2, 0.3, 0.4]},
    {'category': '2', 'conf': 0.5, 'bbox': [0.5, 0.5, 0.4, 0.45]},
    {'category': '3', 'conf': 0.1, 'bbox': [0.0, 0.0, 0.2, 0.2]},
    {'category': '1', 'conf': 0.95, 'bbox': [0.9, 0.9, 0.0, 0.05]}]


def test_visualization_arrays_blur_and_boxes_match(tmp_path):
    root = _vis_images(tmp_path / 'im')
    for name in ('rgb.jpg', 'gray.png', 'ir.png'):
        for ignore in (False, True):
            assert np.array_equal(
                visualization_utils.load_image_as_array(
                    str(root / name), ignore),
                jax_vis.load_image_as_array(str(root / name), ignore))
    for kwargs in ({}, {'confidence_threshold': 0.4, 'blur_radius': 3}):
        ours = visualization_utils.blur_detections(
            visualization_utils.load_image(str(root / 'rgb.jpg')),
            DETECTIONS, **kwargs)
        ref = jax_vis.blur_detections(
            jax_vis.load_image(str(root / 'rgb.jpg')), DETECTIONS, **kwargs)
        assert np.array_equal(np.asarray(ours), np.asarray(ref))

    boxes = np.array([[0.1, 0.2, 0.5, 0.6], [0.3, 0.0, 0.9, 0.4]])
    for kwargs in ({}, {'display_strs': [['a', 'b'], ['c']],
                        'thickness': 2, 'expansion': 3,
                        'label_font_size': 12},
                   {'colormap': ['Red', 'Lime', 'Blue']}):
        images = [visualization_utils.load_image(str(root / 'rgb.jpg'))
                  for _ in range(2)]
        visualization_utils.draw_bounding_boxes_on_image(
            images[0], boxes, [1, '2'], **kwargs)
        jax_vis.draw_bounding_boxes_on_image(images[1], boxes, [1, '2'],
                                             **kwargs)
        assert np.array_equal(np.asarray(images[0]), np.asarray(images[1]))
    # A malformed box array draws nothing in either
    images = [visualization_utils.load_image(str(root / 'rgb.jpg'))
              for _ in range(2)]
    assert visualization_utils.draw_bounding_boxes_on_image(
        images[0], np.zeros((3,)), [1]) is None
    jax_vis.draw_bounding_boxes_on_image(images[1], np.zeros((3,)), [1])
    assert np.array_equal(np.asarray(images[0]), np.asarray(images[1]))

    megadb = [{'category': 'animal', 'bbox': [0.1, 0.1, 0.5, 0.3]},
              {'category': 'person', 'bbox': [0.6, 0.2, 0.3, 0.7]},
              {'category': 'other', 'bbox': [0.0, 0.5, 0.2, 0.2]}]
    images = [visualization_utils.load_image(str(root / 'rgb.jpg'))
              for _ in range(2)]
    visualization_utils.render_megadb_bounding_boxes(megadb, images[0])
    jax_vis.render_megadb_bounding_boxes(megadb, images[1])
    assert np.array_equal(np.asarray(images[0]), np.asarray(images[1]))


@pytest.mark.parametrize('kwargs', [
    {}, {'confidence_threshold': 0.4, 'thickness': 2, 'expansion': 2},
    {'detector_label_map': {'1': 'deer', '2': 'hiker', '3': 'car'},
     'target_size': (60, -1), 'quality': 70},
    {'target_size': (-1, 45)}])
def test_draw_bounding_boxes_on_file_writes_jax_bytes(tmp_path, kwargs):
    root = _vis_images(tmp_path / 'im')
    for name in ('rgb.jpg', 'gray.png'):
        ext = os.path.splitext(name)[1]
        ours = visualization_utils.draw_bounding_boxes_on_file(
            str(root / name), str(tmp_path / 'o' / ('x' + ext)),
            DETECTIONS, **kwargs)
        ref = jax_vis.draw_bounding_boxes_on_file(
            str(root / name), str(tmp_path / 'r' / ('x' + ext)),
            DETECTIONS, **kwargs)
        assert os.path.basename(ours) == os.path.basename(ref)
        with open(ours, 'rb') as a, open(ref, 'rb') as b:
            assert a.read() == b.read()


def test_draw_db_boxes_on_file_writes_jax_bytes(tmp_path):
    root = _vis_images(tmp_path / 'im')
    cases = [([[10, 5, 40, 30], [60, 40, 20, 30]], [1, 2], {}),
             ([[0.1, 0.1, 0.3, 0.5]], None,
              {'boxes_are_normalized': True, 'thickness': 1}),
             ([[5, 5, 20, 20], [30, 30, 20, 20]], [0, 3],
              {'label_map': {0: 'zero', 3: 'three'}, 'expansion': 2})]
    for i, (boxes_, classes, kwargs) in enumerate(cases):
        ours = visualization_utils.draw_db_boxes_on_file(
            str(root / 'rgb.jpg'), str(tmp_path / 'o' / '{}.png'.format(i)),
            boxes_, classes, **kwargs)
        ref = jax_vis.draw_db_boxes_on_file(
            str(root / 'rgb.jpg'), str(tmp_path / 'r' / '{}.png'.format(i)),
            boxes_, classes, **kwargs)
        with open(ours, 'rb') as a, open(ref, 'rb') as b:
            assert a.read() == b.read()


def test_image_integrity_and_sizes_match(tmp_path):
    root = _vis_images(tmp_path / 'im')
    names = [str(root / n) for n in ('rgb.jpg', 'gray.png', 'broken.jpg',
                                     'missing.png', 'notes.txt')]
    for fn in names:
        for modes in (None, ['exists'], ['exists', 'load', 'pixel_load']):
            assert visualization_utils.check_image_integrity(fn, modes) == \
                jax_vis.check_image_integrity(fn, modes)
        assert visualization_utils.get_image_size(fn) == \
            jax_vis.get_image_size(fn)
    image = visualization_utils.load_image(names[0])
    assert visualization_utils.get_image_size(image) == \
        jax_vis.get_image_size(image)
    for source in (str(root), names):
        for kwargs in ({}, {'max_workers': 1}, {'recursive': False}):
            assert visualization_utils.parallel_get_image_sizes(
                source, **kwargs) == jax_vis.parallel_get_image_sizes(
                    source, **kwargs)
        for kwargs in ({}, {'check_decode': False}, {'max_workers': 1}):
            assert visualization_utils.parallel_check_image_integrity(
                source, **kwargs) == jax_vis.parallel_check_image_integrity(
                    source, **kwargs)
    for name in ('rgb.jpg', 'gray.png', 'ir.png'):
        for crop in ((0.1, 0.1), (0.0, 0.0), (0.6, 0.6)):
            assert visualization_utils.gray_scale_fraction(
                str(root / name), crop) == jax_vis.gray_scale_fraction(
                    str(root / name), crop)
    im = visualization_utils.load_image(str(root / 'ir.png'))
    assert visualization_utils.gray_scale_fraction(im) == \
        jax_vis.gray_scale_fraction(im)


@pytest.mark.parametrize('kwargs', [
    {'target_width': 40}, {'target_height': 20, 'quality': 80},
    {'target_width': 500, 'no_enlarge_width': True, 'n_workers': 1}])
def test_resize_helpers_write_jax_bytes(tmp_path, kwargs):
    outputs = {}
    for package, name in ((visualization_utils, 'ours'), (jax_vis, 'ref')):
        root = _vis_images(tmp_path / name)
        out = tmp_path / ('resized_' + name)
        images = ['rgb.jpg', 'gray.png', 'sub/small.png', 'broken.jpg']
        mapping = {str(root / n): str(out / 'files' / n.replace('/', '_'))
                   for n in images}
        got = package.resize_images(mapping, **kwargs)
        folder = package.resize_image_folder(
            str(root), str(out / 'folder'), **kwargs)
        subset = package.resize_image_folder(
            str(root), str(out / 'subset'),
            image_files_relative=['sub/small.png'], **kwargs)
        # in place: no output folder
        in_place = package.resize_image_folder(
            str(root / 'sub'), overwrite=False, **kwargs)
        files = {}
        for r, _, fs in os.walk(str(out)):
            for f in fs:
                p = os.path.join(r, f)
                with open(p, 'rb') as fh:
                    files[os.path.relpath(p, str(out))] = fh.read()
        rel = lambda d: {  # noqa
            os.path.relpath(k, str(tmp_path / name)): (
                v if v.startswith('error') else os.path.relpath(
                    v, str(tmp_path))) for k, v in d.items()}
        outputs[name] = (sorted(x.split(os.sep, 1)[-1] for x in rel(
            got).values() if not x.startswith('error')),
            [v.startswith('error') for v in got.values()],
            sorted(rel(folder)), sorted(rel(subset)), sorted(rel(in_place)),
            files)
    assert outputs['ours'] == outputs['ref']
