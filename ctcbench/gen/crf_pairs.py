"""Seeded CRF duplex pairs: two reads of one molecule as a CRF basecaller's
network scores them, and their alignment envelope.

The alignment is ``pairs.py``'s: both reads read out one hidden base
sequence, read 2 already in read 1's orientation.  Read 1 has ``T1`` frames
and its bases start as in ``posteriors.base_starts``; read 2 has ``T2``
frames over the same bases, cut at ``n - 1`` distinct frames drawn
uniformly.  The envelope is ``pairs.envelope`` on the true alignment, its
half-width ``max(2, half_width + randint(-jitter, jitter))`` a frame of
read 1, fixed to the upstream validity rules.

Each frame is ``crf.py``'s: ``[n_state, A+1]`` rows (stay first, then one
entry a base), each a distribution over the ``A + 1`` labels.  The row of
the true state carries ``posteriors.frame_rows``' confidence law on the
true label (the base at a base's first frame, stay at its others); every
other row is a flat Dirichlet draw.  The true state is the decoder's state
register before the frame's own emission: a pair's start state is drawn
uniformly and shared by both reads (one molecule, one k-mer history), and a
base ``b`` moves state ``s`` to ``(s * A) % n_state + (b - 1)``.  Each read's
``init_state`` is a flat Dirichlet draw over the states with the true start
raised to twice the largest entry, the whole divided by its sum.

Everything random is drawn with one ``torch.Generator`` on the device, in a
fixed order: the bases' first frames of read 1, the bases, read 2's cuts
pair by pair, the start states, the true rows of read 1 then of read 2, the
envelope widths, then pair by pair read 1's scores, its init state, read
2's scores and its init state.  Each read's scores are drawn into a tensor
of their own on the device, one read at a time, so the scratch of a draw is
a fifth of one read and no host copy of the scores is ever made.
"""

from __future__ import annotations

import numpy as np
import torch

from .pairs import envelope
from .posteriors import base_starts, frame_rows


def state_walks(seqs, start, n_state: int, A: int):
    """``[len(seqs)]`` int64 arrays: the state register after each prefix of
    each base sequence, ``walk[j]`` after ``j`` bases (``walk[0]`` the
    start), a base ``b`` (1..A) moving ``s`` to ``(s * A) % n_state + b - 1``."""
    n = max((len(s) for s in seqs), default=0)
    codes = np.zeros((len(seqs), n), np.int64)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = s - 1
    walks = np.empty((len(seqs), n + 1), np.int64)
    walks[:, 0] = start
    for j in range(n):
        walks[:, j + 1] = (walks[:, j] * A) % n_state + codes[:, j]
    return [walks[i, : len(s) + 1] for i, s in enumerate(seqs)]


def _init_state(start: int, n_state: int, gen, device):
    init = torch.empty((n_state,), dtype=torch.float32, device=device).exponential_(generator=gen)
    init[start] = 2.0 * init.max()
    return init / init.sum()


def _scores(rows, states, n_state: int, gen, device):
    """One read's ``[T, n_state, A+1]`` scores: flat Dirichlet rows, the row
    of each frame's true state replaced by ``rows`` [T, A+1]."""
    T, A1 = rows.shape
    w = torch.empty((T, n_state, A1), dtype=torch.float32, device=device)
    w.exponential_(generator=gen)
    w /= w.sum(-1, keepdim=True)
    w[torch.arange(T, device=device), torch.as_tensor(states, device=device)] = rows
    return w


def crf_duplex_pairs(t1s, t2s, n_state: int, params, env_params, gen, device):
    """``(pairs, hidden)`` for the pairs of read lengths ``t1s``, ``t2s``:
    ``pairs[i] = (net1 [T1, S, A+1], init1 [S], net2 [T2, S, A+1], init2
    [S], envelope [T1, 2])``, the scores and init states float32 tensors on
    ``device``, the envelope a host int64 array; ``hidden`` the host arrays
    behind them: each pair's ``bases`` (1..A), ``start`` state and the true
    states of each frame of both reads (``states1``, ``states2``)."""
    A1 = int(params["alphabet_size"])
    A = A1 - 1
    t1s = np.asarray(t1s, np.int64)
    t2s = np.asarray(t2s, np.int64)
    n = len(t1s)
    starts1 = base_starts(t1s, params, gen, device).cpu().numpy()
    off1 = np.concatenate([[0], np.cumsum(t1s)])
    n_bases = [int(starts1[off1[i]:off1[i + 1]].sum()) for i in range(n)]
    if any(k > t2 for k, t2 in zip(n_bases, t2s)):
        raise ValueError("read 2 is shorter than its bases")
    seqs = torch.randint(1, A1, (sum(n_bases),), generator=gen, device=device).cpu().numpy()
    seq_off = np.concatenate([[0], np.cumsum(n_bases)])
    bases = [seqs[seq_off[i]:seq_off[i + 1]] for i in range(n)]

    off2 = np.concatenate([[0], np.cumsum(t2s)])
    starts2 = np.zeros(int(off2[-1]), bool)
    for i, (k, t2) in enumerate(zip(n_bases, t2s)):
        cut = torch.randperm(int(t2) - 1, generator=gen, device=device)[: k - 1] + 1
        starts2[off2[i]] = True
        starts2[off2[i] + cut.cpu().numpy()] = True

    start = torch.randint(0, n_state, (n,), generator=gen, device=device).cpu().numpy()
    walks = state_walks(bases, start, n_state, A)

    def hidden(starts, off):
        """Each frame's target (its base at a base's first frame, else 0) and
        true state (the walk after the bases that started before it)."""
        targets = np.zeros(starts.shape, np.int64)
        states = np.zeros(starts.shape, np.int64)
        for i in range(n):
            s = starts[off[i]:off[i + 1]]
            before = np.cumsum(s) - s  # bases started before each frame
            targets[off[i]:off[i + 1]] = np.where(s, bases[i][np.minimum(before, len(bases[i]) - 1)],
                                                   0)
            states[off[i]:off[i + 1]] = walks[i][before]
        return targets, states

    targets1, states1 = hidden(starts1, off1)
    targets2, states2 = hidden(starts2, off2)
    rows1 = frame_rows(torch.from_numpy(targets1).to(device), params, gen)
    rows2 = frame_rows(torch.from_numpy(targets2).to(device), params, gen)

    hw, jitter = int(env_params["half_width"]), int(env_params["jitter"])
    widths = torch.randint(-jitter, jitter + 1, (int(off1[-1]),), generator=gen,
                           device=device).cpu().numpy()
    widths = np.maximum(2, hw + widths)

    pairs = []
    for i in range(n):
        s1, s2 = slice(off1[i], off1[i + 1]), slice(off2[i], off2[i + 1])
        st1, st2 = starts1[s1], starts2[s2]
        start1, start2 = np.flatnonzero(st1), np.flatnonzero(st2)
        env = envelope(np.cumsum(st1) - 1, start2, np.diff(np.append(start2, t2s[i])),
                       np.diff(np.append(start1, t1s[i])), start1, int(t2s[i]), widths[s1])
        net1 = _scores(rows1[s1], states1[s1], n_state, gen, device)
        init1 = _init_state(int(start[i]), n_state, gen, device)
        net2 = _scores(rows2[s2], states2[s2], n_state, gen, device)
        init2 = _init_state(int(start[i]), n_state, gen, device)
        pairs.append((net1, init1, net2, init2, env))
    return pairs, {"bases": bases, "start": start, "states1": [states1[off1[i]:off1[i + 1]]
                                                                for i in range(n)],
                   "states2": [states2[off2[i]:off2[i + 1]] for i in range(n)]}


def stats(pairs, hidden):
    """What the pool holds: pairs, frames and bytes of both reads, read 1's
    lengths, frames a base, the envelope's widths, and whether every init
    state's largest entry is its pair's true start state."""
    t1 = np.array([p[0].shape[0] for p in pairs])
    t2 = np.array([p[2].shape[0] for p in pairs])
    widths = np.concatenate([p[4][:, 1] - p[4][:, 0] for p in pairs])
    start = hidden["start"]
    return {
        "pairs": len(pairs),
        "frames1": int(t1.sum()),
        "frames2": int(t2.sum()),
        "bytes": int(sum(p[k].numel() * p[k].element_size() for p in pairs for k in range(4))),
        "length1_min": int(t1.min()),
        "length1_median": float(np.median(t1)),
        "length1_max": int(t1.max()),
        "frames_per_base": float(t1.sum() / max(sum(len(b) for b in hidden["bases"]), 1)),
        "envelope_width_mean": float(widths.mean()),
        "envelope_width_max": int(widths.max()),
        "init_argmax_is_start": bool(all(int(p[1].argmax()) == s and int(p[3].argmax()) == s
                                         for p, s in zip(pairs, start))),
    }
