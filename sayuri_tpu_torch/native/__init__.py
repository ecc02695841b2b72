"""Native chunk codec (C++ through ctypes; the port's own copy of
sayuri_tpu.native).

``codec.cpp`` is built with g++ at first use into
``sayuri_tpu_torch/_build/`` (git-ignored), rebuilt when the source is
newer than the library. Without a compiler ``get_lib()`` returns None, logs
that once, and the callers take the Python path: ``train/dataset.py``
parses each kept sample natively when the library is there, and
``selfplay/data.py`` writes in Python either way. See codec.cpp for the
format contract.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "codec.cpp"
_OUT = Path(__file__).resolve().parent.parent / "_build" / "libsayuri_codec.so"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False

NUM_BINARY_PLANES = 37
NUM_SCALARS = 18

SCALAR_FIELDS = [
    "bsize", "komi", "rule", "wave", "to_move", "result",
    "avg_q", "short_q", "mid_q", "long_q", "final_score",
    "avg_s", "short_s", "mid_s", "long_s", "q_stddev", "score_stddev",
    "kld",
]


def _build() -> Path | None:
    if _OUT.exists() and _OUT.stat().st_mtime >= _SRC.stat().st_mtime:
        return _OUT
    _OUT.parent.mkdir(parents=True, exist_ok=True)
    tmp = _OUT.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logging.getLogger(__name__).warning(
            "native chunk codec unavailable (%s); the loader parses in Python", e)
        return None
    os.replace(tmp, _OUT)
    return _OUT


def get_lib():
    """The loaded codec library, or None when it cannot be built."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        f = ctypes.POINTER(ctypes.c_float)
        lib.sayuri_parse_positions.restype = ctypes.c_int
        lib.sayuri_parse_positions.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, f, f, f, f, f, ctypes.c_int]
        lib.sayuri_serialize_positions.restype = ctypes.c_long
        lib.sayuri_serialize_positions.argtypes = [
            ctypes.c_int, ctypes.c_int, f, f, f, f, f, ctypes.c_char_p, ctypes.c_long]
        _LIB = lib
        return _LIB


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def parse_positions(text: str | bytes, bsize: int, cap: int | None = None):
    """Parse a chunk's text (every position of board size `bsize`) into
    dense arrays: dict(planes [N,37,hw], prob [N,hw+1], aux [N,hw+1],
    own [N,hw], scalars [N,18] in SCALAR_FIELDS order), or None when the
    library is missing. Raises ValueError on a malformed text."""
    lib = get_lib()
    if lib is None:
        return None
    if isinstance(text, str):
        text = text.encode()
    hw = bsize * bsize
    if cap is None:
        cap = max(1, text.count(b"\n") // 53 + 1)
    planes = np.zeros((cap, NUM_BINARY_PLANES, hw), np.float32)
    prob = np.zeros((cap, hw + 1), np.float32)
    aux = np.zeros((cap, hw + 1), np.float32)
    own = np.zeros((cap, hw), np.float32)
    scalars = np.zeros((cap, NUM_SCALARS), np.float32)
    n = lib.sayuri_parse_positions(text, len(text), bsize, _fptr(planes), _fptr(prob),
                                   _fptr(aux), _fptr(own), _fptr(scalars), cap)
    if n < 0:
        raise ValueError(f"codec parse error {n}")
    return {"planes": planes[:n], "prob": prob[:n], "aux": aux[:n], "own": own[:n],
            "scalars": scalars[:n]}


def serialize_positions(bsize, planes, prob, aux, own, scalars) -> str | None:
    """Inverse of parse_positions: the chunk text, or None when the library
    is missing."""
    lib = get_lib()
    if lib is None:
        return None
    n = planes.shape[0]
    hw = bsize * bsize
    arrs = [np.ascontiguousarray(a, np.float32) for a in (planes, prob, aux, own, scalars)]
    cap = n * (200 + NUM_BINARY_PLANES * (hw // 4 + 4) + 2 * (hw + 1) * 14 + hw)
    buf = ctypes.create_string_buffer(cap)
    written = lib.sayuri_serialize_positions(n, bsize, *map(_fptr, arrs), buf, cap)
    if written < 0:
        raise ValueError("codec serialize buffer too small")
    return buf.raw[:written].decode()
