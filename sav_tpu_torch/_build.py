"""Builds the hand-written CUDA kernels at first use and loads them.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The libraries go
to ``sav_tpu_torch/build/`` under a name that carries a hash of the sources
and flags, so an edited kernel is never served from a stale build. All
sources compile in parallel, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build')

# library name -> its one translation unit
SOURCES = {
    'botnet_attention': 'botnet_attention.cu',
    'ff_bwd': 'ff_bwd.cu',
    'flash_bwd': 'flash_bwd.cu',
    'flash_bwd_split': 'flash_bwd_split.cu',
    'flash_fwd': 'flash_fwd.cu',
    'fused_attention': 'fused_attention.cu',
    'fused_attention_q8': 'fused_attention_q8.cu',
    'int8_ff': 'int8_ff.cu',
    'int8_matmul': 'int8_matmul.cu',
    'mixer_token': 'mixer_token.cu',
    'th_attention': 'th_attention.cu',
    'th_attention_q8': 'th_attention_q8.cu',
    'th_bwd': 'th_bwd.cu',
    'tnt_inner': 'tnt_inner.cu',
}
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-lineinfo',
              '-Xptxas', '-v']

_loaded: dict = {}
build_log: dict = {}        # name -> nvcc's output (ptxas register counts)
# kernel name -> launches since the last reset; each wrapper adds one where
# it launches its kernel, and nowhere else
launches: dict = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError(
            'nvcc not found (PATH, $CUDA_HOME/bin): the port\'s CUDA kernels '
            'are compiled at first use on the machine with the card')
    return path


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC, '*.cuh')))
    for path in headers + [os.path.join(CSRC, SOURCES[name])]:
        with open(path, 'rb') as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f'lib{name}-{digest.hexdigest()[:16]}.so')


def build_all() -> float:
    """Compiles every library that is not built yet; returns seconds."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    start = time.perf_counter()
    procs = {}
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f'{name}:\n{log}')
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return time.perf_counter() - start


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all()
        lib = _loaded[name] = ctypes.CDLL(path)
    return lib


def count(kernel: str) -> None:
    launches[kernel] = launches.get(kernel, 0) + 1


def reset_launches() -> None:
    launches.clear()


def check(err: int, what: str) -> None:
    """Raises on a non-zero ``cudaGetLastError()`` from a C entry."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')
