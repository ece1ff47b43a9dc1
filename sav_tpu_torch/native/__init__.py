"""Native (C++) JPEG decode tier of the host loader (counterpart of
``sav_tpu/native``).

``decode_jpeg.cc`` (a copy of the JAX package's source) is libjpeg decode
with DCT-domain scaling and a fused keep-aspect bilinear resize + center
crop into a fixed ``[S, S, 3]`` uint8 frame. It is compiled at first use by
``g++ ... -ljpeg`` into ``sav_tpu_torch/build/`` (under a name carrying a
hash of the source, never beside it) and loaded with ctypes.

Where ``g++`` or libjpeg is missing, or a stream is CMYK or corrupt, the
decode returns None and the caller decodes with PIL, as the JAX package
does; ``SAV_TPU_NO_NATIVE=1`` turns the tier off. Which tier served is not
silent: ``data.jpeg_source.decode_jpeg_tier`` returns it with every frame,
the JPEG sources put it in every record, and the host loader counts it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, 'decode_jpeg.cc')
BUILD_DIR = os.path.join(os.path.dirname(_DIR), 'build')
_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']

_lock = threading.Lock()
_lib = None          # ctypes.CDLL once loaded
failure = None       # why the tier is off (a string), once a load failed


def lib_path() -> str:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(' '.join(_FLAGS).encode())
    with open(_SRC, 'rb') as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f'libsavjpeg-{digest.hexdigest()[:16]}.so')


def _jpeg_dir_flags() -> list:
    """``-L`` and ``-rpath`` of the directory where ``g++`` finds
    libjpeg: a library found outside the loader's default path (a
    ``LIBRARY_PATH`` entry) must be found again when the tier is loaded."""
    try:
        found = subprocess.run(['g++', '-print-file-name=libjpeg.so'],
                               capture_output=True, text=True,
                               timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return []
    if not os.path.isabs(found) or not os.path.exists(found):
        return []
    directory = os.path.dirname(os.path.realpath(found))
    return [f'-L{directory}', f'-Wl,-rpath,{directory}']


def _build(path: str) -> Optional[str]:
    """Compiles decode_jpeg.cc to ``path`` (tmp + rename); returns None on
    success, else what went wrong."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = ['g++', *_FLAGS, '-o', tmp, _SRC, *_jpeg_dir_flags(), '-ljpeg',
           '-pthread']
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            return f'g++ exited {proc.returncode}: {proc.stderr.strip()[-300:]}'
        os.replace(tmp, path)
        return None
    except (OSError, subprocess.SubprocessError) as exc:
        return f'g++ could not run: {exc}'
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    """The native library (built if needed), or None when unavailable."""
    global _lib, failure
    if _lib is not None:
        return _lib
    if os.environ.get('SAV_TPU_NO_NATIVE'):
        return None
    with _lock:
        if _lib is not None or failure is not None:
            return _lib
        path = lib_path()
        lib = None
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:     # built on another machine: build it here
                pass
        if lib is None:
            failure = _build(path)
            if failure is not None:
                return None
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                failure = f'loading {path}: {exc}'
                return None
        lib.sav_decode_jpeg.restype = ctypes.c_int
        lib.sav_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.sav_decode_jpeg_batch.restype = ctypes.c_int
        lib.sav_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _lib = lib
    return _lib


def available() -> bool:
    """True when the native decoder can be (or has been) loaded."""
    return _load() is not None


def status() -> str:
    """'native', or 'pil' with the reason the native tier is off."""
    if available():
        return 'native'
    if os.environ.get('SAV_TPU_NO_NATIVE'):
        return 'pil (SAV_TPU_NO_NATIVE is set)'
    return f'pil ({failure})'


def decode_jpeg_fixed_native(data: bytes, decode_size: int
                             ) -> Optional[np.ndarray]:
    """Native decode of JPEG ``data`` to ``[S, S, 3]`` uint8, or None
    ("use PIL": the library is unavailable or the stream needs PIL)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((decode_size, decode_size, 3), dtype=np.uint8)
    rc = lib.sav_decode_jpeg(
        data, len(data), decode_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def decode_jpeg_batch_native(datas: Sequence[bytes], decode_size: int,
                             nthreads: int = 0) -> Optional[np.ndarray]:
    """Threaded batch decode -> ``[N, S, S, 3]`` uint8, or None when the
    library is unavailable. The GIL is released for the whole batch
    (``nthreads=0``: one thread a core); frames the native path declines
    are decoded by PIL, so a returned batch is complete."""
    lib = _load()
    if lib is None or not datas:
        return None
    n = len(datas)
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    out = np.empty((n, decode_size, decode_size, 3), dtype=np.uint8)
    status_codes = (ctypes.c_int * n)()
    bufs = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    failures = lib.sav_decode_jpeg_batch(
        bufs, lens, n, decode_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status_codes, nthreads)
    if failures:
        import io

        from sav_tpu_torch.data import jpeg_source

        for i in range(n):
            if status_codes[i] != 0:
                out[i] = jpeg_source.decode_jpeg_fixed(
                    io.BytesIO(datas[i]), decode_size, allow_native=False)
    return out
