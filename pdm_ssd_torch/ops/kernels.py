"""Build and load the hand-written CUDA kernels of the port.

The sources in `pdm_ssd_torch/csrc/` have a plain C interface. At first use
each is compiled with `nvcc` for `sm_90a` into its own shared library under
`build/torch_kernels/` (listed in `.gitignore`), named by a hash of the
source and the flags; the compilers of all sources run side by side. The
libraries are loaded with `ctypes`. A missing compiler or a failed build
raises: there is no fallback for CUDA tensors.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / 'csrc'
_BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
SOURCES = ('fps.cu', 'group.cu', 'ball_query.cu', 'sparse_conv.cu')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# entry points of each source: name -> argument types (every one returns int)
_ENTRY_POINTS = {
    'fps.cu': {
        'fps_launch': [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        'fps_max_active_clusters': [_I, _I, _I],
    },
    'group.cu': {
        'window_select_max_branches': [],
        'window_select_launch': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _P, _P, _P, _P, _P, _P],
        'gather_rows_launch': [_P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _P],
        'gather_rows_bf16_launch': [_P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _P],
        'scatter_add_rows_launch': [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    'ball_query.cu': {
        'ball_query_max_branches': [],
        'ball_query_cell_bits': [],
        'ball_query_launch': [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
        'ball_query_grid_launch': [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_double, _I, _P, _P,
                                   _P, _P],
    },
    'sparse_conv.cu': {
        'sparse_conv_max_taps': [],
        'sparse_conv_max_cout': [],
        'sparse_conv_tile_rows': [],
        'sparse_conv_launch': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
}

_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None
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


def library_path(source: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    h.update((_CSRC / source).read_bytes())
    return _BUILD_DIR / f'{Path(source).stem}_{h.hexdigest()[:16]}.so'


def build() -> dict:
    """Compile every source whose library is missing, all at once.
    Returns {source: library path}."""
    global build_log
    paths = {s: library_path(s) for s in SOURCES}
    missing = [s for s, so in paths.items() if not so.exists()]
    if not missing:
        return paths
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for s in missing:
        tmp = paths[s].with_suffix(f'.{os.getpid()}.tmp')
        procs[s] = (tmp, subprocess.Popen([nvcc, *NVCC_FLAGS, '-o', str(tmp), str(_CSRC / s)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for s, (tmp, proc) in procs.items():
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += '\nnvcc timed out'
        build_log += f'--- {s}\n{out}'
        if proc.returncode != 0:
            failed.append(s)
        else:
            os.replace(tmp, paths[s])
    if failed:
        raise RuntimeError(f'nvcc failed for {failed}:\n{build_log}')
    return paths


def load() -> types.SimpleNamespace:
    """The kernels' C entry points, built on first call. Once they are
    loaded a call returns them without taking the lock."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            fns = types.SimpleNamespace()
            for source, so in build().items():
                cdll = ctypes.CDLL(str(so))
                for name, argtypes in _ENTRY_POINTS[source].items():
                    fn = getattr(cdll, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    setattr(fns, name, fn)
            _lib = fns
        return _lib


def on_device(index: int):
    """A context that makes card `index` current for a launch: none where it
    already is (the common case, and `torch.cuda.device` costs host time)."""
    if torch.cuda.current_device() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def stream(index: int) -> int:
    """The raw `cudaStream_t` of card `index`'s current stream, as an int."""
    return torch._C._cuda_getCurrentRawStream(index)
