"""Seeded duplex pairs: two reads of one molecule and their alignment envelope.

Both reads read out one hidden base sequence, read 2 already in read 1's
orientation, each with its own dwells and its own frame noise (the law of
``posteriors.py``).  Read 1 has ``T1`` frames and its bases start as in
``posteriors.base_starts``; read 2 has ``T2`` frames over the same bases,
cut at ``n - 1`` distinct frames drawn uniformly, so each base holds at
least one frame of it.

The envelope follows the true frame alignment: frame ``i`` of read 1, at
offset ``o`` of a base of ``d1`` frames that read 2 holds at frames ``[s2,
s2 + d2)``, is centred on ``s2 + (o + 0.5) * d2 / d1``.  Its half-width is
``max(2, half_width + randint(-jitter, jitter))`` per frame, the width law of
the repository's ``jagged_env`` (6 +- 4 frames).  It is then fixed to the
upstream validity rules (src/lib.rs:376-389) as ``jagged_env`` fixes it:
both bounds made monotone, each lower bound at most the previous upper
bound, each window at least one frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .posteriors import base_starts, frame_rows


def envelope(base1, start2, dwell2, dwell1, start1, T2, widths):
    """``[T1, 2]`` int64 envelope of read 1's frames (``base1`` [T1]: the
    base of each frame; ``start1``/``dwell1``: each base's first frame and
    frames in read 1; ``start2``/``dwell2``: the same in read 2)."""
    T1 = base1.shape[0]
    off = np.arange(T1) - start1[base1]
    centre = start2[base1] + (off + 0.5) * dwell2[base1] / dwell1[base1]
    c = np.floor(centre).astype(np.int64)
    lo = np.maximum(c - widths, 0)
    hi = np.minimum(c + widths + 1, T2)
    lo = np.maximum.accumulate(lo)
    hi = np.maximum.accumulate(hi)
    # each lower bound at most the previous upper bound (0 before the first)
    prev_hi = np.concatenate([[0], hi[:-1]])
    lo = np.minimum(lo, prev_hi)
    hi = np.maximum(hi, lo + 1)
    return np.stack([lo, hi], axis=1)


def duplex_pairs(t1s, t2s, params, env_params, gen, device):
    """``[(net1 [T1, A+1], net2 [T2, A+1], envelope [T1, 2])]`` for the pairs
    of read lengths ``t1s``, ``t2s`` (host numpy float32 and int64)."""
    A1 = int(params["alphabet_size"])
    t1s = np.asarray(t1s, np.int64)
    t2s = np.asarray(t2s, np.int64)
    starts1 = base_starts(t1s, params, gen, device).cpu().numpy()
    off1 = np.concatenate([[0], np.cumsum(t1s)])
    n_bases = [int(starts1[off1[i]:off1[i + 1]].sum()) for i in range(len(t1s))]
    if any(n > t2 for n, t2 in zip(n_bases, t2s)):
        raise ValueError("read 2 is shorter than its bases")
    seqs = torch.randint(1, A1, (sum(n_bases),), generator=gen, device=device)
    seq_off = np.concatenate([[0], np.cumsum(n_bases)])

    starts2 = np.zeros(int(t2s.sum()), bool)
    off2 = np.concatenate([[0], np.cumsum(t2s)])
    for i, (n, t2) in enumerate(zip(n_bases, t2s)):
        cut = torch.randperm(int(t2) - 1, generator=gen, device=device)[: n - 1] + 1
        starts2[off2[i]] = True
        starts2[off2[i] + cut.cpu().numpy()] = True

    def targets(starts, off):
        base = np.cumsum(starts) - 1  # global frame -> index among all bases
        out = np.zeros(starts.shape, np.int64)
        # the base index restarts in each read, so offset by the read's first
        seq_host = seqs.cpu().numpy()
        for i in range(len(off) - 1):
            s = slice(off[i], off[i + 1])
            b = base[s] - base[off[i]]
            out[s] = np.where(starts[s], seq_host[seq_off[i] + b], 0)
        return torch.from_numpy(out).to(device)

    rows1 = frame_rows(targets(starts1, off1), params, gen).cpu().numpy()
    rows2 = frame_rows(targets(starts2, off2), params, gen).cpu().numpy()

    hw, jitter = int(env_params["half_width"]), int(env_params["jitter"])
    widths_all = torch.randint(-jitter, jitter + 1, (int(t1s.sum()),), generator=gen,
                               device=device).cpu().numpy()
    widths_all = np.maximum(2, hw + widths_all)

    pairs = []
    for i in range(len(t1s)):
        s1 = slice(off1[i], off1[i + 1])
        s2 = slice(off2[i], off2[i + 1])
        st1, st2 = starts1[s1], starts2[s2]
        base1 = np.cumsum(st1) - 1
        start1 = np.flatnonzero(st1)
        start2 = np.flatnonzero(st2)
        dwell1 = np.diff(np.append(start1, t1s[i]))
        dwell2 = np.diff(np.append(start2, t2s[i]))
        env = envelope(base1, start2, dwell2, dwell1, start1, int(t2s[i]), widths_all[s1])
        pairs.append((rows1[s1], rows2[s2], env))
    return pairs
