"""
Build of the port's CUDA kernels at first use.

Every csrc/*.cu is compiled by its own nvcc process (all started
together) into an object file, and the objects are linked into one shared
library with a plain C interface, loaded with ctypes. The library lands in
megadetector_tpu_torch/_build/ (ignored by git) under a name keyed by a
hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused. A missing nvcc or a failed compile raises
KernelError carrying nvcc's output; nothing falls back to the plain
PyTorch versions.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')

# Hopper only: keep the 'a' (wgmma/setmaxnreg exist only for sm_90a).
# -fmad=false keeps nvcc from contracting a*b+c into FMAs, which would
# change float rounding against the reference formulas.
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xptxas', '-v', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points of the library: name -> argtypes (each returns an int,
# cudaGetLastError() after its launches)
_FUNCTIONS = {
    # boxes, valid, mask, keep, batch, k, m, m_hi, m_lo, tie_up, stream
    'md_greedy_nms': [_P, _P, _P, _P, _I, _I, ctypes.c_double, _F, _F, _I,
                      _P],
    # boxes, valid, mask, keep, batch, k, split (float64 [4] on the card),
    # stream
    'md_greedy_nms_dev': [_P, _P, _P, _P, _I, _I, _P, _P],
    # x, w, scale, bias, out, batch, h, w, cin, cout, kh, kw, sh, sw,
    # pad_top, pad_left, ho, wo, y_scale, requant (0 int32, 1 SiLU, 2
    # linear), instance, stream
    'md_conv_int8': [_P, _P, _P, _P, _P] + [_I] * 13 + [_F, _I, _I, _P],
    # x, w1, scale1, bias1, mid_scale, w2, scale2, bias2, cv2_scale,
    # s_in, out_scale, shortcut, out, batch, h, w, c, instance, stream
    'md_bottleneck_int8': [_P, _P, _P, _P, _F, _P, _P, _P, _F, _F, _F, _I,
                           _P, _I, _I, _I, _I, _I, _P],
    # x, w, bias, out, batch, h, w, c, stream
    'md_l0_fused': [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, bias (or null), out, n, c, inner, stream
    'md_silu_bf16': [_P, _P, _P, ctypes.c_longlong, _I, _I, _P],
    # g, x, bias (or null), dx, partials, db, n, c, inner, width, blocks,
    # cols, lanes, segs, stream
    'md_silu_bf16_backward': [_P, _P, _P, _P, _P, _P, ctypes.c_longlong]
                             + [_I] * 7 + [_P],
    # x, w, scale, bias, out, batch, h, w, cin, cout, requant_in, in_ratio,
    # inv_y, epilogue, instance, stream
    'md_conv3x3_int8_exp': [_P, _P, _P, _P, _P] + [_I] * 6 + [_F, _F, _I,
                                                             _I, _P],
    # a, b, out, bt, ap (or null), m, n, k, requant, scale, grid, stream
    'md_gemm_int8': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ''
build_seconds = None


class KernelError(RuntimeError):
    """A kernel failed to build or to launch. Never contained as a
    per-image data failure."""


def find_nvcc():
    """Path of nvcc (PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin),
    or None."""

    found = shutil.which('nvcc')
    if found:
        return found
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and os.path.isfile(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    return None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu')))


def library_path():
    """Where the library for the current sources and flags lives."""

    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh')))
    for src in _sources() + headers:
        with open(src, 'rb') as f:
            digest.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR,
                        'libmdtorch-{}.so'.format(digest.hexdigest()[:16]))


def _compile(out_path):
    global build_log, build_seconds
    import time

    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelError('nvcc not found (PATH, $CUDA_HOME/bin, '
                          '/usr/local/cuda/bin); the CUDA kernels in {} '
                          'cannot be built'.format(CSRC_DIR))
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = '{}.tmp{}'.format(out_path, os.getpid())
    start = time.time()
    # One nvcc per source, all running at once
    jobs = []
    for i, src in enumerate(_sources()):
        obj = '{}.{}.o'.format(tag, i)
        cmd = [nvcc] + NVCC_FLAGS + ['-c', '-o', obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append('nvcc failed ({}):\n{}\n{}'.format(
                proc.returncode, ' '.join(cmd), out))
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            build_log = ''.join(logs)
            raise KernelError('\n'.join(failed))
        cmd = [nvcc, '-shared', '-o', tag] + objs
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        build_log = ''.join(logs)
        if proc.returncode != 0:
            raise KernelError('nvcc link failed ({}):\n{}\n{}'.format(
                proc.returncode, ' '.join(cmd), build_log))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_seconds = time.time() - start
    os.replace(tag, out_path)


def load_library():
    """The loaded kernel library, compiling it first if needed."""

    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.isfile(path):
            _compile(path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _FUNCTIONS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.md_cuda_error_string.argtypes = [ctypes.c_int]
        lib.md_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def check_launch(lib, err, name):
    """Raise KernelError when a C entry point returned a CUDA error."""

    if err != 0:
        raise KernelError('{} launch failed: {} ({})'.format(
            name, lib.md_cuda_error_string(err).decode(), err))
