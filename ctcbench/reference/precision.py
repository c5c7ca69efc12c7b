"""Rounding functions of the reference: float32, and bfloat16 for the control."""

from __future__ import annotations

import numpy as np


def f32(x):
    """``x`` as a float32 scalar (the configuration's precision)."""
    return np.float32(x)


def bf16(x):
    """``x`` rounded to bfloat16 (round to nearest even), held in a float32
    scalar: the nearest precision below float32."""
    a = np.asarray(x, np.float32)
    if not np.isfinite(a):
        return np.float32(a)
    bits = int(a.view(np.uint32))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return np.array(bits, np.uint32).view(np.float32)[()]


def round_array(a, q):
    """Every element of float32 array ``a`` rounded by ``q`` (``f32`` or
    ``bf16``)."""
    a = np.asarray(a, np.float32)
    if q is f32:
        return a
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(a), out, a)
