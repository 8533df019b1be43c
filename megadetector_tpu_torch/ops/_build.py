"""
Build of the port's CUDA kernels at first use.

Every csrc/*.cu is compiled by nvcc into one shared library with a plain C
interface, loaded with ctypes. The library lands in
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
              '-O3', '-fmad=false', '-Xptxas', '-v', '-shared',
              '-Xcompiler', '-fPIC']

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
    for src in _sources():
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
    tmp_path = '{}.tmp{}'.format(out_path, os.getpid())
    cmd = [nvcc] + NVCC_FLAGS + ['-o', tmp_path] + _sources()
    start = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.time() - start
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelError('nvcc failed ({}):\n{}\n{}'.format(
            proc.returncode, ' '.join(cmd), build_log))
    os.replace(tmp_path, out_path)


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
        lib.md_greedy_nms.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        lib.md_greedy_nms.restype = ctypes.c_int
        lib.md_cuda_error_string.argtypes = [ctypes.c_int]
        lib.md_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib
