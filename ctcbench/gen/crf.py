"""Seeded CRF posteriors in the shape a CRF basecaller's network leaves
them on the card for ``crf_beam_search``: a chunk of ``T`` frames is
``[T, n_state, A+1]`` (stay first, then one entry a base), with an
``init_state [n_state]``.

A chunk reads out a hidden base sequence.  A new base starts at a frame
with probability ``1 / frames_per_base`` (a geometric dwell, as in
``posteriors.base_starts``, which also starts one at the chunk's first
frame), drawn uniformly from the ``A`` bases.  The hidden state is the one
the decoder's state register holds: the chunk's true start state is drawn
uniformly, and a base ``b`` emitted at a frame moves state ``s`` to
``(s * A) % n_state + (b - 1)`` from the next frame on (src/search.rs:38-157).

At every frame each of the ``n_state`` rows is a distribution over the
``A + 1`` labels and sums to 1:

- the true state's row puts ``posteriors.frame_rows``' confidence law
  (``ctc_nacgt_b5``'s) on the true label: the base at a base's first frame,
  stay (0) at the others;
- every other row is a flat Dirichlet draw over the ``A + 1`` labels.

``init_state`` is a flat Dirichlet draw over the states whose true start
state is then raised to twice the largest entry, and the whole divided by
its sum: the true start state holds the maximum, so the decoder starts
there.

Everything is drawn with one ``torch.Generator`` on the device the
posteriors are made on: the hidden paths for all chunks at once, then the
posteriors a batch of chunks at a time into the caller's pool, so no host
copy of the pool is ever made.
"""

from __future__ import annotations

import torch

from .posteriors import base_starts, frame_rows, targets_from_starts

#: chunks whose posteriors are drawn at once (the scratch of one draw is a
#: fifth of the batch's posteriors)
BATCH = 16


def true_states(start, targets, n_state: int, A: int):
    """``[n, T]`` int64: the state register at each frame, before the frame's
    own emission.  ``start`` [n]: the states before each chunk; ``targets``
    [n, T]: the base emitted at a frame (1..A), 0 where none."""
    n, T = targets.shape
    states = torch.empty((n, T), dtype=torch.int64, device=targets.device)
    s = start.clone()
    for t in range(T):
        states[:, t] = s
        b = targets[:, t]
        s = torch.where(b > 0, (s * A) % n_state + b - 1, s)
    return states


def hidden_paths(n: int, T: int, n_state: int, params, gen, device):
    """``(targets [n, T] int64, start [n] int64, states [n, T] int64)`` of
    ``n`` chunks of ``T`` frames."""
    A = int(params["alphabet_size"]) - 1
    starts = base_starts([T] * n, params, gen, device)
    targets = targets_from_starts(starts, A, gen).reshape(n, T)
    start = torch.randint(0, n_state, (n,), generator=gen, device=device)
    return targets, start, true_states(start, targets, n_state, A)


def crf_chunks(n: int, T: int, n_state: int, params, gen, device, out=None):
    """``n`` chunks of ``T`` frames: ``(probs [n, T, n_state, A+1] float32
    (written into ``out`` when given), init [n, n_state] float32, targets
    [n, T] int64, start [n] int64, states [n, T] int64)``."""
    A1 = int(params["alphabet_size"])
    targets, start, states = hidden_paths(n, T, n_state, params, gen, device)
    rows = frame_rows(targets.reshape(-1), params, gen).reshape(n, T, A1)
    if out is None:
        out = torch.empty((n, T, n_state, A1), dtype=torch.float32, device=device)
    t = torch.arange(T, device=device)
    for i in range(0, n, BATCH):
        w = out[i:i + BATCH]
        w.exponential_(generator=gen)
        w /= w.sum(-1, keepdim=True)
        k = torch.arange(w.shape[0], device=device)[:, None]
        w[k, t[None, :], states[i:i + BATCH]] = rows[i:i + BATCH]

    init = torch.empty((n, n_state), dtype=torch.float32, device=device).exponential_(
        generator=gen)
    k = torch.arange(n, device=device)
    init[k, start] = 2.0 * init.max(1).values
    init /= init.sum(1, keepdim=True)
    return out, init, targets, start, states


def stats(targets, init, start):
    """What the pool holds: chunks, frames, frames a base, and whether every
    init state's largest entry is its chunk's true start state."""
    n, T = targets.shape
    bases = int((targets > 0).sum())
    return {
        "chunks": n,
        "frames": n * T,
        "frames_per_base": n * T / max(bases, 1),
        "init_argmax_is_start": bool((init.argmax(1) == start).all()),
    }
