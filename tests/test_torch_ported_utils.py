"""
The port's own copies of the JAX package's jax-free helpers, each held
against the original on the same inputs: ops/boxes (letterbox,
auto_target_shape, resize_long_side, scale_coords, xyxy2xywh),
utils/ct_utils (with the drivers' convert_xywh_to_xyxy, args_to_object,
dict_to_kvp_list, is_iterable), utils/path_utils (with the video helpers
and flatten_path), models/registry and
visualization/visualization_utils.load_image (its rendering is held in
tests/test_torch_run_detector.py).
"""

import argparse
import json

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
