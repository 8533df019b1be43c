"""
The port's native host code, in two libraries with ctypes bindings. Both
are host code, not device kernels, and ctypes releases the GIL for each
call.

- The JPEG loader: decode + EXIF rotation + letterbox of a JPEG in C++ on
  libjpeg (jpeg_loader.cpp, the port's copy of
  megadetector_tpu/native/jpeg_loader.cpp). The batch driver's
  --use_native_loader runs it on the loader workers.
- The host kernels letterbox_u8, nms_xyxy and cluster_boxes
  (letterbox_nms.cpp, the port's copy of
  megadetector_tpu/native/letterbox_nms.cpp), with the JAX module's
  is_available() and signatures. They need no libjpeg, so they build
  where the JPEG loader cannot. No code of the port calls them, as no
  code of the JAX package calls its own: they are kept for parity with
  the JAX package, and its tests are their only callers.

Each library is built at first use with g++ -O3 -shared -fPIC -fopenmp
(and -ljpeg for the loader) into megadetector_tpu_torch/_build/ (ignored
by git), under a name keyed by a hash of its source and flags. The build
writes to a temporary name and then os.replace()s it, so processes that
build at once never load a half-written file. A missing g++ or libjpeg
raises NativeLoaderError naming the missing piece; nothing falls back
quietly.

Numpy only at import (no torch, no PIL): loader worker processes import
this module; PIL reads a JPEG's header inside decode_jpeg_scaled.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'jpeg_loader.cpp')
_HOST_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'letterbox_nms.cpp')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '_build')
CXX_FLAGS = ['-O3', '-shared', '-fPIC', '-fopenmp']
LINK_FLAGS = ['-ljpeg']

JL_OK = 0
JL_DECODE_ERROR = 1
JL_UNSUPPORTED_ORIENTATION = 2
JL_NOT_RGB = 3

_lock = threading.Lock()
_lib = None
_host_lib = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


class NativeLoaderError(RuntimeError):
    """A native library (the JPEG loader or the host kernels) cannot be
    built or loaded."""


def _hashed_path(src, stem, link_flags):
    digest = hashlib.sha256(' '.join(CXX_FLAGS + link_flags).encode())
    with open(src, 'rb') as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        '{}-{}.so'.format(stem, digest.hexdigest()[:16]))


def library_path():
    """Where the JPEG loader for the current source and flags lives."""

    return _hashed_path(_SRC, 'libmdjpeg', LINK_FLAGS)


def host_library_path():
    """Where the host kernels' library for the current source and flags
    lives."""

    return _hashed_path(_HOST_SRC, 'libmdnative', [])


def _gxx_problem():
    return None if shutil.which('g++') else 'g++ not found on PATH'


def toolchain_problem():
    """None when g++ and libjpeg's header are present, else a sentence
    naming what is missing."""

    problem = _gxx_problem()
    if problem is not None:
        return problem
    proc = subprocess.run(['g++', '-E', '-x', 'c++', '-', '-o', os.devnull],
                          input='#include <cstdio>\n#include <jpeglib.h>\n',
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return ('jpeglib.h not found (libjpeg development headers): '
                '{}'.format(proc.stderr.strip()))
    return None


def _build(out_path, src, link_flags, what, problem):
    if problem is not None:
        raise NativeLoaderError('cannot build {}: {}'.format(what, problem))
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = '{}.tmp{}'.format(out_path, os.getpid())
    cmd = ['g++'] + CXX_FLAGS + [src, '-o', tmp] + link_flags
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        missing = 'libjpeg (-ljpeg)' if 'ljpeg' in proc.stderr else 'g++'
        raise NativeLoaderError(
            'cannot build {}: {} failed ({}):\n{}\n{}'.format(
                what, missing, proc.returncode, ' '.join(cmd), proc.stderr))
    os.replace(tmp, out_path)


def load_library():
    """The loaded native JPEG library, building it first if needed;
    raises NativeLoaderError when it cannot be built."""

    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.isfile(path):
            _build(path, _SRC, LINK_FLAGS, 'the native JPEG loader',
                   toolchain_problem())
        lib = ctypes.CDLL(path)
        lib.decode_jpeg_letterbox_rect.argtypes = [
            _U8P, ctypes.c_long, _U8P, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint8, ctypes.c_int, ctypes.c_int, _I32P]
        lib.decode_jpeg_letterbox_rect.restype = ctypes.c_int
        lib.decode_jpeg_letterbox_batch_rect.argtypes = [
            ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_uint8,
            ctypes.c_int, ctypes.c_int, _I32P, _I32P]
        lib.decode_jpeg_letterbox_batch_rect.restype = None
        lib.decode_jpeg_scaled.argtypes = [
            _U8P, ctypes.c_long, _U8P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _I32P]
        lib.decode_jpeg_scaled.restype = ctypes.c_int
        _lib = lib
        return _lib


def jpeg_loader_available():
    """True when the library is built (building it if needed), False when
    it cannot be (see toolchain_problem)."""

    try:
        load_library()
    except NativeLoaderError:
        return False
    return True


def _canvas_hw(canvas):
    if isinstance(canvas, (tuple, list)):
        return int(canvas[0]), int(canvas[1])
    return int(canvas), int(canvas)


def _u8(array):
    return array.ctypes.data_as(_U8P)


def _i32(array):
    return array.ctypes.data_as(_I32P)


def decode_jpeg_letterbox(jpeg_bytes, canvas, pad_value=114,
                          dct_scale_target=0, scale_target=0):
    """
    Decode one JPEG (bytes), apply its EXIF orientation (3/6/8) and
    letterbox it into a [canvas_h, canvas_w, 3] uint8 canvas (canvas: an
    int for a square, or an (h, w) tuple).

    Returns (canvas_array, (src_h, src_w)), the source dims after
    rotation. Raises ValueError on a decode failure, a mirrored EXIF
    orientation or a non-RGB JPEG (the caller falls back to PIL).

    dct_scale_target > 0 decodes at the smallest libjpeg scale_num/8 that
    still covers that long side. scale_target > 0 derives the letterbox
    ratio from that square size instead of the canvas, which reproduces
    letterbox(auto=True) geometry on a minimal stride rectangle.
    """

    lib = load_library()
    canvas_h, canvas_w = _canvas_hw(canvas)
    buf = np.frombuffer(jpeg_bytes, dtype=np.uint8)
    out = np.empty((canvas_h, canvas_w, 3), dtype=np.uint8)
    dims = np.zeros(2, dtype=np.int32)
    rc = lib.decode_jpeg_letterbox_rect(
        _u8(buf), ctypes.c_long(buf.size), _u8(out), canvas_h, canvas_w,
        int(pad_value), int(scale_target), int(dct_scale_target),
        _i32(dims))
    if rc != JL_OK:
        raise ValueError('native JPEG decode failed (code {})'.format(rc))
    return out, (int(dims[0]), int(dims[1]))


def scaled_decode_dims(width, height, dct_scale_target):
    """
    The dims libjpeg decodes a JPEG of (width, height) to at the smallest
    scale_num/8 whose long side covers [dct_scale_target] (0 = full
    resolution): ceil(dim * num / 8), as (height, width).
    """

    if dct_scale_target <= 0:
        return height, width
    long_side = max(width, height)
    num = 8
    for n in range(1, 9):
        if long_side * n // 8 >= dct_scale_target:
            num = n
            break
    return (height * num + 7) // 8, (width * num + 7) // 8


def decode_jpeg_scaled(jpeg_bytes, dct_scale_target=0):
    """
    Decode one JPEG (bytes) at the DCT scale covering [dct_scale_target]
    on the long side (0 = full resolution), with its EXIF orientation
    (3/6/8) applied and no letterbox: an HWC uint8 array. Raises
    ValueError on failure. Feeds device preprocessing, where the letterbox
    runs on the device.
    """

    import io

    from PIL import Image

    lib = load_library()
    # The header's dims (no decode) size the buffer; the C side checks
    with Image.open(io.BytesIO(jpeg_bytes)) as pim:
        w0, h0 = pim.size
    h, w = scaled_decode_dims(w0, h0, dct_scale_target)
    side = max(h, w)  # a rotation may swap the dims
    buf = np.frombuffer(jpeg_bytes, dtype=np.uint8)
    out = np.zeros((side, side, 3), dtype=np.uint8)
    dims = np.zeros(2, dtype=np.int32)
    rc = lib.decode_jpeg_scaled(
        _u8(buf), ctypes.c_long(buf.size), _u8(out), side, side,
        int(dct_scale_target), _i32(dims))
    if rc != JL_OK:
        raise ValueError('native JPEG decode failed (code {})'.format(rc))
    return np.ascontiguousarray(out[:int(dims[0]), :int(dims[1])])


def decode_jpeg_letterbox_batch(jpeg_buffers, canvas, pad_value=114,
                                dct_scale_target=0, scale_target=0,
                                out=None):
    """
    Decode a batch of JPEGs in parallel (OpenMP) into [n, canvas_h,
    canvas_w, 3] uint8 ([out] reuses a buffer). Returns (staging, dims [n,
    2], errs [n]); errs[i] != 0 marks a failed image (its slot is
    undefined).
    """

    lib = load_library()
    canvas_h, canvas_w = _canvas_hw(canvas)
    n = len(jpeg_buffers)
    arrays = [np.frombuffer(b, dtype=np.uint8) for b in jpeg_buffers]
    ptrs = (_U8P * n)(*[_u8(a) for a in arrays])
    lens = (ctypes.c_long * n)(*[a.size for a in arrays])
    if out is None:
        out = np.empty((n, canvas_h, canvas_w, 3), dtype=np.uint8)
    elif out.shape != (n, canvas_h, canvas_w, 3) or out.dtype != np.uint8:
        raise ValueError('out must be uint8 {}, got {} {}'.format(
            (n, canvas_h, canvas_w, 3), out.dtype, out.shape))
    dims = np.zeros((n, 2), dtype=np.int32)
    errs = np.zeros(n, dtype=np.int32)
    lib.decode_jpeg_letterbox_batch_rect(
        ptrs, lens, n, _u8(out), canvas_h, canvas_w, int(pad_value),
        int(scale_target), int(dct_scale_target), _i32(dims), _i32(errs))
    return out, dims, errs


#%% Host kernels (letterbox_nms.cpp: a library of its own, no libjpeg)


def load_host_library():
    """The loaded host-kernel library, building it first if needed;
    raises NativeLoaderError when it cannot be built."""

    global _host_lib
    with _lock:
        if _host_lib is not None:
            return _host_lib
        path = host_library_path()
        if not os.path.isfile(path):
            _build(path, _HOST_SRC, [], 'the native host kernels',
                   _gxx_problem())
        lib = ctypes.CDLL(path)
        lib.letterbox_u8.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int,
            ctypes.c_uint8]
        lib.letterbox_u8.restype = None
        lib.letterbox_u8_rect.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint8]
        lib.letterbox_u8_rect.restype = None
        lib.nms_xyxy.argtypes = [
            _F32P, _F32P, ctypes.c_int, ctypes.c_float, _I32P]
        lib.nms_xyxy.restype = ctypes.c_int
        lib.cluster_boxes.argtypes = [
            _F32P, _I32P, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            _I32P]
        lib.cluster_boxes.restype = ctypes.c_int
        _host_lib = lib
        return _host_lib


def is_available():
    """True when the host kernels' library is built (building it if
    needed), False when it cannot be (no g++)."""

    try:
        load_host_library()
    except NativeLoaderError:
        return False
    return True


def letterbox_u8(image, out_size, pad_value=114):
    """
    Fused native letterbox: HWC uint8 -> [out_h, out_w, 3] uint8
    (geometry identical to ops/boxes.letterbox(auto=False, scaleup=True)).
    out_size may be an int (square canvas) or an (out_h, out_w) tuple.
    """

    lib = load_host_library()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    out_h, out_w = _canvas_hw(out_size)
    if image.ndim != 3 or image.shape[2] != 3 or min(image.shape[:2]) < 1 \
            or min(out_h, out_w) < 1:
        raise ValueError('letterbox_u8: an HxWx3 image onto a positive '
                         'canvas, got {} onto {}'.format(image.shape,
                                                         (out_h, out_w)))
    h, w = image.shape[:2]
    out = np.empty((out_h, out_w, 3), dtype=np.uint8)
    lib.letterbox_u8_rect(_u8(image), h, w, _u8(out), out_h, out_w,
                          pad_value)
    return out


def nms_xyxy(boxes, scores, iou_thres):
    """
    Native greedy NMS. boxes [N,4] xyxy, scores [N]; returns kept indices
    (score-descending numpy int32 array). Boxes are ordered with
    std::sort, which is not stable: among tied scores the order, and so
    the kept set, may differ from a stable sort's.
    """

    lib = load_host_library()
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or scores.shape != (n,):
        raise ValueError('nms_xyxy: boxes [N, 4] and scores [N], got {} and '
                         '{}'.format(boxes.shape, scores.shape))
    keep = np.empty(n, dtype=np.int32)
    n_keep = lib.nms_xyxy(boxes.ctypes.data_as(_F32P),
                          scores.ctypes.data_as(_F32P), n,
                          float(iou_thres), _i32(keep))
    return keep[:n_keep].copy()


def cluster_boxes(boxes_xywh, categories, iou_thres,
                  category_agnostic=False):
    """
    Native greedy IoU clustering (grid-hashed; the port's repeat-detection
    elimination does not call it). boxes [N,4] normalized
    xywh, categories [N] ints; returns (cluster_ids [N], n_clusters).
    """

    lib = load_host_library()
    boxes = np.ascontiguousarray(boxes_xywh, dtype=np.float32)
    categories = np.ascontiguousarray(categories, dtype=np.int32)
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or categories.shape != (n,):
        raise ValueError('cluster_boxes: boxes [N, 4] and categories [N], '
                         'got {} and {}'.format(boxes.shape,
                                                categories.shape))
    out = np.empty(n, dtype=np.int32)
    n_clusters = lib.cluster_boxes(
        boxes.ctypes.data_as(_F32P), _i32(categories), n, float(iou_thres),
        int(category_agnostic), _i32(out))
    return out, n_clusters
