"""ctypes bindings for the native HTK I/O library (native/htkio.cc).

Compiles the shared library on first use (g++ is part of the toolchain)
into a per-user cache; every entry point has a pure-Python fallback so the
framework works without a compiler. ctypes calls release the GIL, so a
``ThreadPoolExecutor`` over ``read_frames`` gives genuinely parallel file
reading — the replacement for Platform's reader thread
(Platform.h:201-245).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False


def _source_path() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "native", "htkio.cc")


def _build_lib() -> Optional[str]:
    cache = os.path.join(tempfile.gettempdir(),
                         f"nnet_asr_tpu_native_{os.getuid()}")
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, "libhtkio.so")
    src = _source_path()
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(src)):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"     # per-pid: concurrent cold-cache
    try:                                # builds must not corrupt the .so
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src],
            check=True, capture_output=True)
        os.replace(tmp, so)
        return so
    except Exception:
        return None


def get_lib():
    """Returns the loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build_lib()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.htk_read_header.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.htk_read_header.restype = ctypes.c_int
        lib.htk_read_frames.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.htk_read_frames.restype = ctypes.c_int
        lib.htk_write_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.htk_write_file.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def read_header(path: str, big_endian: bool = True):
    """(n_samples, sample_period, sample_size, sample_kind) of the
    decompressed view."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native htkio unavailable")
    n = ctypes.c_int32()
    per = ctypes.c_int32()
    sz = ctypes.c_int32()
    kind = ctypes.c_int32()
    rc = lib.htk_read_header(path.encode(), int(big_endian),
                             ctypes.byref(n), ctypes.byref(per),
                             ctypes.byref(sz), ctypes.byref(kind))
    if rc:
        raise IOError(f"Invalid HTK header in feature file: '{path}'")
    return n.value, per.value, sz.value, kind.value


def read_frames(path: str, big_endian: bool = True,
                from_frame: int = 0, to_frame: int = -1,
                start_ext: int = 0, end_ext: int = 0) -> np.ndarray:
    """Read (+range +edge-extension) one file. Returns float32 (T, dim)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native htkio unavailable")
    n, per, sz, kind = read_header(path, big_endian)
    dim = sz // 4
    if to_frame < 0:
        to_frame = n - 1
    cap = (to_frame - from_frame + 1 + start_ext + end_ext) * dim
    out = np.empty(cap, dtype=np.float32)
    rc = lib.htk_read_frames(
        path.encode(), int(big_endian), from_frame, to_frame,
        start_ext, end_ext,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
    if rc < 0:
        raise IOError(f"Cannot read feature file: '{path}'")
    return out[:rc * dim].reshape(rc, dim)


def write_file(path: str, data: np.ndarray, sample_kind: int,
               sample_period: int = 100000, big_endian: bool = True) -> None:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native htkio unavailable")
    data = np.ascontiguousarray(data, dtype=np.float32)
    rc = lib.htk_write_file(
        path.encode(), int(big_endian),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[0], data.shape[1], sample_period, sample_kind)
    if rc:
        raise IOError(f"Cannot create file: '{path}'")
