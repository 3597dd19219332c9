"""Build and load the hand-written CUDA kernels of the port.

The sources in `pdm_ssd_torch/csrc/` have a plain C interface. At first use
they are compiled with `nvcc` for `sm_90a` into one shared library under
`build/torch_kernels/` (listed in `.gitignore`), named by a hash of the
sources and flags, and loaded with `ctypes`. A missing compiler or a failed
build raises: there is no fallback for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / 'csrc'
_BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
SOURCES = ('fps.cu',)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ''


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    cand = Path(cuda_home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                           'of pdm_ssd_torch cannot be built')
    return found


def library_path() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / f'pdm_ssd_torch_kernels_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the sources if the library for their hash is missing."""
    global build_log
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *(str(_CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n{build_log}')
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.fps_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.fps_launch.restype = ctypes.c_int
            lib.fps_max_points.argtypes = []
            lib.fps_max_points.restype = ctypes.c_int
            _lib = lib
        return _lib
