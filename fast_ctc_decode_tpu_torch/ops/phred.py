"""Phred quality encoding.

Reference semantics (src/search.rs:31-36 of the reference)::

    let max = 1e-4;
    let p = if 1.0 - prob < max { max } else { 1.0 - prob };
    let q = -10.0 * p.log10() * qscale + qbias;
    char::from_u32(q.round() as u32 + 33)

Notes on exactness:
 - all arithmetic is f32;
 - ``f32::round`` rounds half away from zero;
 - ``as u32`` saturates negative values to 0 (so q < -0.5 maps to '!');
 - the 1e-4 floor caps the default-scale score at Q40 ('I').

A NumPy twin (host, used by the single-read parity API) and a torch twin
(device, used by the batch decoders), as in ``fast_ctc_decode_tpu.ops.phred``.
They agree wherever ``log10`` rounds the same on both sides, which it does
for these magnitudes but a last-ulp difference could move a value sitting
exactly on a .5 rounding boundary.
"""

from __future__ import annotations

import numpy as np
import torch


def phred_int_np(prob: np.ndarray, qscale: float, qbias: float) -> np.ndarray:
    """Rounded phred integer (without the +33 ASCII offset), NumPy f32."""
    prob = np.asarray(prob, dtype=np.float32)
    p = np.float32(1.0) - prob
    p = np.where(p < np.float32(1e-4), np.float32(1e-4), p)
    q = np.float32(-10.0) * np.log10(p) * np.float32(qscale) + np.float32(qbias)
    # round half away from zero, then saturate negatives at 0 (Rust `as u32`)
    r = np.sign(q) * np.floor(np.abs(q) + np.float32(0.5))
    r = np.maximum(r, np.float32(0.0))
    return r.astype(np.uint32)


def phred_int(prob: torch.Tensor, qscale, qbias) -> torch.Tensor:
    """Rounded phred integer (without the +33 offset), f32 math on ``prob``'s
    device; int64 result (torch has no uint32 arithmetic)."""
    # Python floats holding f32 values: torch applies them in f32
    floor, scale, bias = (float(np.float32(v)) for v in (1e-4, qscale, qbias))
    prob = prob.to(torch.float32)
    p = 1.0 - prob
    p = torch.where(p < floor, floor, p)
    q = -10.0 * torch.log10(p) * scale + bias
    r = torch.sign(q) * torch.floor(torch.abs(q) + 0.5)
    r = torch.clamp_min(r, 0.0)
    # XLA's float -> uint32 conversion maps NaN to 0 and saturates; a torch
    # cast of NaN is undefined, so both are spelled out
    r = torch.where(torch.isnan(r), 0.0, r)
    return r.to(torch.int64).clamp_max(2**32 - 1)


def phred_char(prob: float, qscale: float = 1.0, qbias: float = 0.0) -> str:
    """Single-probability convenience matching reference `phred` exactly."""
    return chr(int(phred_int_np(np.float32(prob), qscale, qbias)) + 33)
