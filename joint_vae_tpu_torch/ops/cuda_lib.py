"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/torch_kernels/`` at the repository root, named by a hash of
its source so an edited kernel rebuilds.  The library is loaded with
``ctypes``; callers pass device pointers and the CUDA stream as
``c_void_p``.  Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'torch_kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: each launch returns its cudaError_t as an int
SIGNATURES = {
    'same_grid_conv': {
        'same_grid_conv_f32': [_P, _P, _P] + [_I] * 9 + [_P],
        'same_grid_conv_bf16': [_P, _P, _P] + [_I] * 9 + [_P],
    },
    'iws_combine': {
        'iws_combine_f32': [_P] * 6 + [_I] * 5 + [_P],
        'iws_combine_splits': [_I] * 4,
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}      # name -> nvcc output (ptxas -v report)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc'), shutil.which('nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built with the '
                       'CUDA toolkit (CUDA_HOME or nvcc on PATH)')


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + '.cu'), 'rb') as f:
        digest = hashlib.sha1(f.read() + ' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, 'lib{}-{}.so'.format(
        name, digest.hexdigest()[:12]))


def _start_build(name: str):
    """-> (final path, tmp path, Popen) or None if already built."""
    path = library_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix='.so.tmp')
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
           os.path.join(CSRC_DIR, name + '.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return path, tmp, proc


def _finish_build(name: str, path: str, tmp: str, proc) -> None:
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError('nvcc failed for {}.cu:\n{}'.format(name, out))
    os.replace(tmp, path)


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named kernels (default: all), one nvcc per source, all
    started together.  Returns the wall seconds spent."""
    names = list(names or SIGNATURES)
    t0 = time.perf_counter()
    started = {n: _start_build(n) for n in names}
    errors = []
    for n, job in started.items():
        if job is not None:
            try:
                _finish_build(n, *job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError('\n'.join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, with its C signatures
    declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(library_path(name))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a nonzero cudaError_t."""
    if rc != 0:
        raise RuntimeError('{} kernel launch failed: cudaError {} ({})'.format(
            what, rc, lib.kernel_error_string(rc).decode()))
