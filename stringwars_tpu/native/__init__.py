"""Native host runtime (C++ via ctypes) — build-on-first-use.

Compiles ``swtpu_native.cpp`` with g++ -O3 into ``build/`` beside it (a
directory git ignores) and exposes the C ABI through ctypes + numpy
buffers. Falls back to ``None`` (callers keep a pure-Python path) when no
compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "swtpu_native.cpp")
_BUILD = os.path.join(_DIR, "build")


def _build() -> str | None:
    os.makedirs(_BUILD, exist_ok=True)
    src_mtime = os.path.getmtime(_SRC)
    so_path = os.path.join(_BUILD, "libswtpu_native.so")
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= src_mtime:
        return so_path
    # Build under a per-process name and rename into place, so concurrent
    # first uses (test workers) never load a half-written library.
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        print(f"swtpu native build failed ({e}); using pure-Python fallbacks", file=sys.stderr)
        return None
    os.replace(tmp_path, so_path)
    return so_path


_lib = None
_tried = False


def library() -> ctypes.CDLL | None:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.swtpu_word_spans.restype = i64
    lib.swtpu_word_spans.argtypes = [u8p, i64, ctypes.c_void_p]
    lib.swtpu_line_spans.restype = i64
    lib.swtpu_line_spans.argtypes = [u8p, i64, ctypes.c_void_p]
    lib.swtpu_ac_build.restype = i64
    lib.swtpu_ac_build.argtypes = [u8p, i64p, i64]
    lib.swtpu_ac_export.restype = None
    lib.swtpu_ac_export.argtypes = [i32p, i32p]
    lib.swtpu_ac_count.restype = i64
    lib.swtpu_ac_count.argtypes = [u8p, i64]
    _lib = lib
    return _lib


def word_spans(data: np.ndarray) -> np.ndarray | None:
    """[count, 2] int64 word spans, or None when the library is absent."""
    lib = library()
    if lib is None:
        return None
    n = np.int64(data.shape[0])
    count = lib.swtpu_word_spans(data, n, None)
    spans = np.empty(count * 2, np.int64)
    lib.swtpu_word_spans(data, n, spans.ctypes.data_as(ctypes.c_void_p))
    return spans.reshape(-1, 2)


def line_spans(data: np.ndarray) -> np.ndarray | None:
    lib = library()
    if lib is None:
        return None
    n = np.int64(data.shape[0])
    count = lib.swtpu_line_spans(data, n, None)
    spans = np.empty(count * 2, np.int64)
    lib.swtpu_line_spans(data, n, spans.ctypes.data_as(ctypes.c_void_p))
    return spans.reshape(-1, 2)


def ac_build(patterns: list[bytes]) -> tuple[np.ndarray, np.ndarray] | None:
    """Build the dense AC DFA: (delta int32[S, 256], out_count int32[S])."""
    lib = library()
    if lib is None:
        return None
    flat = np.frombuffer(b"".join(patterns), np.uint8) if patterns else np.zeros(0, np.uint8)
    offsets = np.zeros(len(patterns) + 1, np.int64)
    np.cumsum([len(p) for p in patterns], out=offsets[1:])
    flat = np.ascontiguousarray(flat)
    states = lib.swtpu_ac_build(flat, offsets, np.int64(len(patterns)))
    delta = np.empty((states, 256), np.int32)
    out_count = np.empty(states, np.int32)
    lib.swtpu_ac_export(delta, out_count)
    return delta, out_count


def ac_count_host(data: np.ndarray) -> int:
    """Host sequential AC scan over the most recently built automaton."""
    lib = library()
    assert lib is not None
    return int(lib.swtpu_ac_count(np.ascontiguousarray(data), np.int64(data.shape[0])))
