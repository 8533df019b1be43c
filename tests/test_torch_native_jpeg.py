"""
The port's native JPEG loader (megadetector_tpu_torch/native/) against the
JAX package's library (megadetector_tpu/native/jpeg_loader.cpp, built by
its own module), on the same JPEG bytes:

- decode + letterbox, the DCT-scaled decode and the batch decode are
  bit-identical, at square and rectangular canvases, with EXIF rotations
  3, 6 and 8, a scale target and DCT scaling;
- mirrored orientations and bytes that are no JPEG are rejected by both;
- the build: a content-hashed name, written under a temporary name and
  os.replace()d, so processes that build at once all load a whole file;
  a missing g++ or jpeglib.h raises NativeLoaderError naming it.

Whether a test can run (g++ and libjpeg present) is decided inside it,
never at collection.
"""

import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from PIL import Image

from megadetector_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_library():
    """The port's library, or a skip naming what this machine lacks."""

    problem = native.toolchain_problem()
    if problem is not None:
        pytest.skip('native JPEG loader cannot build here: ' + problem)
    return native.load_library()


def jax_native_library():
    """The JAX package's native JPEG module with its library loaded. Its
    build writes the .so in place, so a process that read a half-written
    file remembers a failure; reset that and retry until the file is
    whole."""

    port_library()
    from megadetector_tpu import native as jax_native

    for _ in range(50):
        if jax_native.jpeg_loader_available():
            return jax_native
        jax_native._JPEG_BUILD_FAILED = False
        time.sleep(0.2)
    raise AssertionError('the JAX package\'s native JPEG library did not '
                         'load')


def _smooth_image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    yy = np.linspace(0, np.pi * 2, h)[:, None, None]
    xx = np.linspace(0, np.pi * 3, w)[None, :, None]
    phases = rng.uniform(0, np.pi, (1, 1, 3))
    img = (np.sin(yy + phases) * np.cos(xx - phases) + 1) * 127.0
    img += rng.randint(-12, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg_bytes(arr, quality=90, orientation=None):
    buf = io.BytesIO()
    kwargs = {'quality': quality}
    if orientation is not None:
        exif = Image.Exif()
        exif[274] = orientation
        kwargs['exif'] = exif.tobytes()
    Image.fromarray(arr).save(buf, format='JPEG', **kwargs)
    return buf.getvalue()


@pytest.mark.parametrize('orientation', [None, 1, 3, 6, 8])
@pytest.mark.parametrize('canvas,scale_target,dct', [
    (256, 0, 0), ((192, 256), 256, 0), ((256, 192), 256, 0),
    (320, 0, 160), ((128, 192), 192, 200)])
def test_letterbox_decode_is_the_jax_librarys(canvas, scale_target, dct,
                                              orientation):
    port_library()
    jax_native = jax_native_library()
    data = _jpeg_bytes(_smooth_image(150, 210, seed=7),
                       orientation=orientation)
    ours, dims = native.decode_jpeg_letterbox(
        data, canvas, scale_target=scale_target, dct_scale_target=dct)
    ref, ref_dims = jax_native.decode_jpeg_letterbox(
        data, canvas, scale_target=scale_target, dct_scale_target=dct)
    assert dims == ref_dims
    assert ours.shape == ref.shape and np.array_equal(ours, ref)
    if orientation in (6, 8) and dct == 0:
        assert dims == (210, 150)


@pytest.mark.parametrize('orientation', [None, 3, 6, 8])
@pytest.mark.parametrize('target', [0, 100, 320])
def test_scaled_decode_is_the_jax_librarys(target, orientation):
    port_library()
    jax_native = jax_native_library()
    data = _jpeg_bytes(_smooth_image(240, 330, seed=3),
                       orientation=orientation)
    ours = native.decode_jpeg_scaled(data, dct_scale_target=target)
    ref = jax_native.decode_jpeg_scaled(data, dct_scale_target=target)
    assert ours.shape == ref.shape and np.array_equal(ours, ref)
    h, w = native.scaled_decode_dims(330, 240, target)
    assert ours.shape[:2] == ((w, h) if orientation in (6, 8) else (h, w))


def test_batch_decode_is_the_jax_librarys():
    port_library()
    jax_native = jax_native_library()
    buffers = [_jpeg_bytes(_smooth_image(120 + 20 * i, 200 - 10 * i, seed=i),
                           orientation=(None, 3, 6, 8, 2)[i % 5])
               for i in range(6)]
    buffers.append(b'\xff\xd8 not a jpeg')
    ours = native.decode_jpeg_letterbox_batch(buffers, (192, 256),
                                              scale_target=256)
    ref = jax_native.decode_jpeg_letterbox_batch(buffers, (192, 256),
                                                 scale_target=256)
    assert np.array_equal(ours[2], ref[2])
    assert list(ours[2]) == [0, 0, 0, 0, native.JL_UNSUPPORTED_ORIENTATION,
                             0, native.JL_DECODE_ERROR]
    assert np.array_equal(ours[1], ref[1])
    ok = ours[2] == 0
    assert np.array_equal(ours[0][ok], ref[0][ok])
    # A caller's buffer is filled in place
    out = np.zeros((7, 192, 256, 3), np.uint8)
    again = native.decode_jpeg_letterbox_batch(buffers, (192, 256),
                                               scale_target=256, out=out)
    assert again[0] is out and np.array_equal(out[ok], ours[0][ok])


@pytest.mark.parametrize('orientation', [2, 4, 5, 7])
def test_mirrored_orientations_are_rejected(orientation):
    port_library()
    jax_native = jax_native_library()
    data = _jpeg_bytes(_smooth_image(64, 96), orientation=orientation)
    for decode in (native.decode_jpeg_letterbox,
                   jax_native.decode_jpeg_letterbox):
        with pytest.raises(ValueError, match='code 2'):
            decode(data, 128)
    for decode in (native.decode_jpeg_scaled, jax_native.decode_jpeg_scaled):
        with pytest.raises(ValueError, match='code 2'):
            decode(data)


@pytest.mark.parametrize('data', [b'', b'garbage bytes', b'\xff\xd8\xff'])
def test_garbage_is_rejected(data):
    port_library()
    jax_native = jax_native_library()
    for decode in (native.decode_jpeg_letterbox,
                   jax_native.decode_jpeg_letterbox):
        with pytest.raises(ValueError, match='code 1'):
            decode(data, 128)


def test_scaled_decode_dims_are_the_jax_modules():
    from megadetector_tpu import native as jax_native

    for w, h in [(2048, 1536), (1920, 1080), (1536, 2048), (640, 480),
                 (1, 1), (1281, 7)]:
        for target in (0, 1, 160, 640, 1280, 1281, 5000):
            assert native.scaled_decode_dims(w, h, target) == \
                jax_native.scaled_decode_dims(w, h, target)


def test_pil_reads_the_decoded_pixels_within_a_few_levels():
    """The native decode against PIL's on the same bytes, letterboxed by
    the port's host letterbox (cv2): the bars of the JAX package's own
    test."""

    port_library()
    from megadetector_tpu_torch.ops.boxes import letterbox

    data = _jpeg_bytes(_smooth_image(240, 320), quality=95)
    canvas, dims = native.decode_jpeg_letterbox(data, 320)
    assert dims == (240, 320)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))
    ref = letterbox(pil, (320, 320), auto=False)[0]
    diff = np.abs(canvas.astype(int) - ref.astype(int))
    assert diff.max() <= 3 and diff.mean() < 0.5


_BUILD = """
import sys
from megadetector_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
lib = native.load_library()
print(native.library_path())
"""


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Four processes build into one empty directory at once: each loads
    the library, and only the content-hashed file is left."""

    if native.toolchain_problem() is not None:
        pytest.skip(native.toolchain_problem())
    build_dir = str(tmp_path / 'build')
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    procs = [subprocess.Popen([sys.executable, '-c', _BUILD, build_dir],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    paths = {out.strip().splitlines()[-1] for out, _ in outs}
    assert len(paths) == 1
    name = os.path.basename(paths.pop())
    assert name.startswith('libmdjpeg-') and name.endswith('.so')
    assert os.listdir(build_dir) == [name]


def test_missing_pieces_are_named(monkeypatch, tmp_path):
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setenv('PATH', str(tmp_path))
    assert native.toolchain_problem() == 'g++ not found on PATH'
    with pytest.raises(native.NativeLoaderError, match='g\\+\\+ not found'):
        native.load_library()
    assert not native.jpeg_loader_available()
