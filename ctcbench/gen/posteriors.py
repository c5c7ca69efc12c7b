"""Seeded CTC posteriors in the shape a basecaller's softmax head gives.

A read is drawn as a hidden base sequence read out over frames.  A new base
starts at a frame with probability ``1 / frames_per_base`` (so a base's
dwell is geometric with that mean, at least one frame), and the read's
first frame always starts one.  A base's first frame carries most of the
mass on that base and its other frames carry it on blank (index 0).

Each frame's confidence is drawn on its own:
  - with probability ``ambiguous_share`` the frame is ambiguous: its top
    two symbols (the target and one other, uniform) hold ``U(*ambiguous_pair_mass)``
    of the mass split at a ratio ``U(1, max_ratio)``, so they lie within
    ``max_ratio`` of each other;
  - otherwise the target holds ``1 - e`` with ``e`` log-uniform in
    ``confident_rest``;
  - the rest of the mass is split over the remaining symbols by a flat
    Dirichlet draw.
Rows are float32 and sum to 1.

Everything is drawn with one ``torch.Generator`` on the device the tensors
are made on, in a few calls over all frames at once.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lengths_grid(n, median, sigma, lo=None, hi=None):
    """``n`` read lengths: the quantiles ``(i + 0.5) / n`` of a log-normal of
    ``median`` and ``sigma``, rounded and, where ``lo`` or ``hi`` is given,
    clipped to them.  They do not depend on the seed: every seed decodes the
    same set of sizes, and the seed only orders them."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    t = np.rint(median * np.exp(sigma * z))
    if lo is not None or hi is not None:
        t = np.clip(t, lo, hi)
    return t.astype(np.int64)


def uniform_grid(n, lo, hi):
    """``n`` evenly spaced quantiles of ``U(lo, hi)``, seed-free as above."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def frame_rows(targets, params, gen):
    """``[F, A+1]`` float32 rows for ``targets`` [F] (int64 symbol of each
    frame, 0 blank) by the confidence law above."""
    dev = targets.device
    F = targets.shape[0]
    A1 = int(params["alphabet_size"])
    u = torch.rand((F, 4), generator=gen, device=dev, dtype=torch.float64)
    ambiguous = u[:, 0] < params["ambiguous_share"]
    lo_e, hi_e = (math.log(x) for x in params["confident_rest"])
    rest = torch.exp(lo_e + (hi_e - lo_e) * u[:, 1])
    pm_lo, pm_hi = params["ambiguous_pair_mass"]
    pair = pm_lo + (pm_hi - pm_lo) * u[:, 1]
    ratio = 1.0 + (params["max_ratio"] - 1.0) * u[:, 2]
    top = torch.where(ambiguous, pair * ratio / (1.0 + ratio), 1.0 - rest)
    second = torch.where(ambiguous, pair / (1.0 + ratio), torch.zeros_like(pair))
    rival = (targets + 1 + (u[:, 3] * (A1 - 1)).long().clamp(max=A1 - 2)) % A1

    # the rest of the mass, spread by a flat Dirichlet over the symbols that
    # are neither the target nor (on an ambiguous frame) its rival
    w = -torch.log(torch.rand((F, A1), generator=gen, device=dev, dtype=torch.float64))
    idx = torch.arange(A1, device=dev)
    taken = (idx == targets[:, None]) | (ambiguous[:, None] & (idx == rival[:, None]))
    w = torch.where(taken, torch.zeros_like(w), w)
    left = (1.0 - top - second)[:, None]
    rows = w / w.sum(1, keepdim=True) * left
    rows.scatter_(1, targets[:, None], top[:, None])
    rows.scatter_add_(1, rival[:, None], second[:, None])
    rows = rows.float()
    return rows / rows.sum(1, keepdim=True)


def base_starts(lengths, params, gen, device):
    """``[F]`` bool: the frames of the concatenated reads of ``lengths`` at
    which a base starts; a read's first frame always does."""
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=device)
    F = int(lengths.sum())
    starts = torch.rand(F, generator=gen, device=device) < 1.0 / params["frames_per_base"]
    first = torch.cumsum(lengths, 0) - lengths
    starts[first[lengths > 0]] = True
    return starts


def targets_from_starts(starts, n_bases, gen):
    """``[F]`` target symbols: a base drawn uniformly from ``1..n_bases`` at
    each start frame, blank (0) elsewhere."""
    bases = torch.randint(1, n_bases + 1, starts.shape, generator=gen, device=starts.device)
    return torch.where(starts, bases, torch.zeros_like(bases))


def ctc_reads(lengths, params, gen, device):
    """Posteriors of reads of ``lengths``: ``(rows [F, A+1] float32, offsets
    [n+1])`` with read ``i`` at ``rows[offsets[i]:offsets[i+1]]``."""
    starts = base_starts(lengths, params, gen, device)
    targets = targets_from_starts(starts, int(params["alphabet_size"]) - 1, gen)
    rows = frame_rows(targets, params, gen)
    offsets = np.concatenate([[0], np.cumsum(np.asarray(lengths, np.int64))])
    return rows, offsets


def stats(rows, lengths):
    """What the pool holds: read count, lengths, frames a base (from the
    top symbol: a frame whose top is not blank starts a base) and the share
    of ambiguous frames (top two within 2x)."""
    lengths = np.asarray(lengths)
    top2 = torch.topk(rows, 2, dim=1)
    amb = (top2.values[:, 0] <= 2.0 * top2.values[:, 1]).double().mean().item()
    emits = (top2.indices[:, 0] != 0).sum().item()
    return {
        "reads": int(lengths.size),
        "frames": int(lengths.sum()),
        "length_min": int(lengths.min()),
        "length_median": float(np.median(lengths)),
        "length_mean": float(lengths.mean()),
        "length_max": int(lengths.max()),
        "frames_per_base": float(lengths.sum() / max(emits, 1)),
        "ambiguous_share": amb,
    }
