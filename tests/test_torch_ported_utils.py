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
