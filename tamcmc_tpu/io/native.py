"""ctypes bindings for the native C++ IO runtime (native/recordio.cpp).

Built on first use by `make -C native`, every time, so the loaded library is
always the committed recordio.cpp's (make rebuilds only when the source is
newer than the .so).  Degrades gracefully to the pure-python paths in
outputs.py / data.py when the build fails or no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "librecordio.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.rw_open.restype = ctypes.c_void_p
    lib.rw_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rw_append.restype = ctypes.c_int
    lib.rw_append.argtypes = [ctypes.c_void_p,
                              np.ctypeslib.ndpointer(dtype=np.float64,
                                                     flags="C_CONTIGUOUS"),
                              ctypes.c_long]
    lib.rw_count.restype = ctypes.c_long
    lib.rw_count.argtypes = [ctypes.c_void_p]
    lib.rw_flush.restype = ctypes.c_int
    lib.rw_flush.argtypes = [ctypes.c_void_p]
    lib.rw_close.restype = ctypes.c_int
    lib.rw_close.argtypes = [ctypes.c_void_p]
    lib.ascii_read_table.restype = ctypes.c_long
    lib.ascii_read_table.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_long, ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class NativeRecordWriter:
    """Async double-buffered binary record writer (reference outputs.cpp
    equivalent).  Raises RuntimeError if the native library is unavailable —
    callers select the fallback explicitly."""

    def __init__(self, path: str, nvars: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native recordio unavailable")
        self._lib = lib
        self._h = lib.rw_open(str(path).encode(), nvars)
        if not self._h:
            raise OSError(f"rw_open failed for {path}")
        self.nvars = nvars

    def append(self, records: np.ndarray):
        arr = np.ascontiguousarray(records, dtype=np.float64)
        assert arr.ndim == 2 and arr.shape[1] == self.nvars
        if self._lib.rw_append(self._h, arr, arr.shape[0]):
            raise OSError("rw_append failed")

    @property
    def count(self) -> int:
        return int(self._lib.rw_count(self._h))

    def flush(self) -> None:
        """Block until every appended record is in the file — the
        intra-phase checkpoint barrier (see outputs.OutputWriter.save_partial)."""
        if self._h and self._lib.rw_flush(self._h):
            raise OSError("rw_flush reported write errors")

    def close(self) -> None:
        if self._h:
            err = self._lib.rw_close(self._h)
            self._h = None
            if err:
                raise OSError("rw_close reported write errors")


def native_read_table(path: str, max_elems: int = 1 << 26):
    """Fast ASCII numeric table read -> (n_rows, n_cols) float64 array,
    or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(max_elems, dtype=np.float64)
    ncols = ctypes.c_int(0)
    n = lib.ascii_read_table(str(path).encode(), buf, max_elems,
                             ctypes.byref(ncols))
    if n < 0:
        raise OSError(f"ascii_read_table error {n} for {path}")
    c = ncols.value
    return buf[:n * c].reshape(n, c).copy() if c else np.empty((0, 0))
