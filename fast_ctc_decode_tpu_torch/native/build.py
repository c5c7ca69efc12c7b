"""Build + load the C++ detokenizer (ctypes; no pybind11 dependency).

Compiled on first use with g++ into a per-user cache; every entry point has
a pure-Python fallback so the package works without a toolchain.  The fast
path only applies to single-ASCII-char alphabets (the overwhelmingly common
case); multi-char labels fall back to Python joins.  Detokenization is host
string assembly, not device work: the cache directory is this package's own
(``fast_ctc_decode_tpu_torch``), so it never collides with the JAX package's
build of the same source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build_lib() -> Optional[str]:
    src = os.path.join(os.path.dirname(__file__), "detok.cpp")
    cache = os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "fast_ctc_decode_tpu_torch",
    )
    os.makedirs(cache, exist_ok=True)
    out = os.path.join(cache, "libdetok.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", out + ".tmp", src],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(out + ".tmp", out)
        return out
    except (subprocess.SubprocessError, OSError, FileNotFoundError):
        return None


def get_lib():
    """The loaded ctypes library, or None when unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build_lib()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        for name in ("detok_reverse_ascii", "detok_forward_ascii"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
            ]
        lib.qstring_ascii.restype = None
        lib.qstring_ascii.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
        return _LIB


def _single_char_lut(labels: List[str]) -> Optional[bytes]:
    if all(len(s) == 1 and ord(s) < 128 for s in labels):
        return "".join(labels).encode("ascii")
    return None


def detokenize_batch(
    tokens: np.ndarray,
    counts: np.ndarray,
    labels: List[str],
    reverse: bool,
) -> List[str]:
    """Batch token arrays -> list of strings.

    tokens: [B, Tmax] int32 — label ids; when ``reverse`` they are 0-based
    deepest-first traceback ids (beam), else 1-based alphabet rows (viterbi).
    ``labels`` excludes/includes the blank accordingly: pass the emittable
    label strings indexed directly by the token value space.
    """
    tokens = np.ascontiguousarray(tokens, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    B, Tmax = tokens.shape
    lib = get_lib()
    lut = _single_char_lut(labels)
    if lib is not None and lut is not None:
        out = ctypes.create_string_buffer(B * Tmax)
        offsets = np.zeros((B + 1,), np.int64)
        fn = lib.detok_reverse_ascii if reverse else lib.detok_forward_ascii
        fn(
            tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            B,
            Tmax,
            lut,
            len(lut),
            out,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        raw = out.raw
        return [
            raw[offsets[b] : offsets[b + 1]].decode("ascii") for b in range(B)
        ]
    # Python fallback
    res = []
    for b in range(B):
        n = int(counts[b])
        row = tokens[b, :n]
        if reverse:
            row = row[::-1]
        res.append("".join(labels[int(t)] for t in row))
    return res


def qstrings_batch(qints: np.ndarray, counts: np.ndarray) -> List[str]:
    """Batch phred ints -> quality strings (+33 ASCII)."""
    qints = np.ascontiguousarray(qints, np.uint32)
    counts = np.ascontiguousarray(counts, np.int32)
    B, Tmax = qints.shape
    lib = get_lib()
    if lib is not None and bool(np.all(qints < 94)):
        out = ctypes.create_string_buffer(B * Tmax)
        offsets = np.zeros((B + 1,), np.int64)
        lib.qstring_ascii(
            qints.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            B,
            Tmax,
            out,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        raw = out.raw
        return [
            raw[offsets[b] : offsets[b + 1]].decode("ascii") for b in range(B)
        ]
    return [
        "".join(chr(int(q) + 33) for q in qints[b, : int(counts[b])])
        for b in range(B)
    ]
