# Copied from gnss_sdr_tpu/native/__init__.py; only the package imports are rewritten.
"""ctypes loader for the native host kernels (native/sdr_kernels.cpp).

Compiles the shared library on first use (g++ -O3, cached by source
mtime under native/build/) and exposes numpy-friendly wrappers. Every
caller keeps a pure-NumPy fallback — absence of a toolchain degrades
performance, never capability (`available()` reports which path runs)."""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "sdr_kernels.cpp"
_BUILD = _SRC.parent / "build"
_LIB = _BUILD / "libsdrkernels.so"

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if not _SRC.exists():
            return None
        if (not _LIB.exists()
                or _LIB.stat().st_mtime < _SRC.stat().st_mtime):
            _BUILD.mkdir(exist_ok=True)
            tmp = _LIB.with_suffix(f".tmp{os.getpid()}.so")
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", str(tmp), str(_SRC)],
                check=True, capture_output=True,
            )
            tmp.replace(_LIB)
        lib = ctypes.CDLL(str(_LIB))
        lib.unpack_2bit.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.unpack_4bit.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.viterbi27.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def unpack_2bit(data: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.empty(4 * data.size, dtype=np.int8)
    lib.unpack_2bit(data.ctypes.data, out.ctypes.data, data.size)
    return out


def unpack_4bit(data: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.empty(2 * data.size, dtype=np.int8)
    lib.unpack_4bit(data.ctypes.data, out.ctypes.data, data.size)
    return out


def viterbi27(symbols: np.ndarray, invert_g2: bool,
              start_state: int | None, end_state: int | None
              ) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    sym = np.ascontiguousarray(symbols, dtype=np.float64)
    n = len(sym) // 2
    out = np.empty(n, dtype=np.uint8)
    lib.viterbi27(
        sym.ctypes.data, n, 1 if invert_g2 else 0,
        -1 if start_state is None else int(start_state),
        -1 if end_state is None else int(end_state),
        out.ctypes.data,
    )
    return out
