"""Reference CRF prefix beam search (upstream src/search.rs:38-157).

A frozen copy of the repository's NumPy oracle (``tests/oracle.py``,
``crf_beam_search``), in the reference's exact operation order: one
chunk's ``[T, n_state, A+1]`` posteriors (stay first, then one entry a
base) and its ``init_state [n_state]``.  The beam starts at the root with
label probability ``max(init_state)``, gap probability ``init_state[0]`` and
state ``argmax(init_state)`` (the first maximum).  At each frame every tip
reads the row of its own state: staying keeps node and state, with gap
``(label + gap) * row[0]`` where ``row[0] > threshold``; label ``a``
(skipped where ``row[a + 1] < threshold``) moves to the tree's child
``(node, a)``, created at this frame if new, with state
``(state * A) % n_state + a`` and label ``(label + gap) * row[a + 1]``.
There is no collapse of repeats.  Entries of one node merge (sums in node
order), a NaN among two or more totals fails the read, the entries sort by
total (ties in node order), the beam keeps ``beam_size``, and every entry
is divided by the top total.

Departures from upstream, each for the benchmark's comparison:

- Beside upstream's path (the frame at which each prefix of the answer was
  first created) it follows the path that the port's batch decoders
  document, with ``reference/ctc.py``'s bookkeeping: a prefix that was
  pruned from the beam and derived again later reports the frame of its
  latest entry into the beam.  Every entry carries a record ``(frame,
  parent record)``; an extension that reaches a prefix the beam holds joins
  that tip's record, any other opens a new record at the current frame.
  A node decides its state (a state moves only with a label), so two
  entries of one node never disagree on it, and CRF has no ghosts.
- Failures are returned as the wire's status codes (``SearchFailure``),
  where upstream returns its ``SearchError``.
- ``q`` rounds the inputs and the result of every arithmetic step:
  ``f32``, the configuration's precision, leaves upstream's float32
  arithmetic as it is; ``bf16`` is the precision control.
"""

from __future__ import annotations

import numpy as np

from .ctc import INCOMPARABLE_VALUES, RAN_OUT_OF_BEAM, ROOT, SearchFailure, Tree
from .precision import bf16, f32, round_array


def _merge_sort_truncate(beam, beam_size, q):
    """Merge entries of one node (left fold in node order), check for NaN,
    sort by probability (stable), truncate."""
    beam.sort(key=lambda e: e["node"])
    merged = []
    for e in beam:
        if merged and merged[-1]["node"] == e["node"]:
            acc = merged[-1]
            acc["lab"] = q(acc["lab"] + e["lab"])
            acc["gap"] = q(acc["gap"] + e["gap"])
        else:
            merged.append(e)
    total = [q(e["lab"] + e["gap"]) for e in merged]
    if len(merged) >= 2 and any(p != p for p in total):  # a NaN
        raise SearchFailure(INCOMPARABLE_VALUES, "Failed to compare values (NaNs in input?)")
    order = sorted(range(len(merged)), key=lambda k: -float(total[k]))
    if not order:
        raise SearchFailure(RAN_OUT_OF_BEAM,
                            "Ran out of search space (beam_cut_threshold too high)")
    return [merged[k] for k in order[:beam_size]]


def crf_beam_search(probs, init_state, alphabet, beam_size=5, beam_cut_threshold=0.0, q=f32):
    """``(sequence, first_path, latest_path)`` of one chunk; raises
    ``SearchFailure`` where upstream raises."""
    probs = round_array(probs, q)
    init_state = round_array(init_state, q)
    thr = q(beam_cut_threshold)
    T, S, A1 = probs.shape
    n_base = A1 - 1
    tree = Tree()
    beam = [dict(node=ROOT, lab=q(init_state.max()), gap=q(init_state[0]),
                 state=int(init_state.argmax()), rec=None)]

    for idx in range(T):
        held = {e["node"]: e["rec"] for e in beam}
        next_beam = []
        for tip in beam:
            node, state, rec = tip["node"], tip["state"], tip["rec"]
            lab, gap = tip["lab"], tip["gap"]
            pr = probs[idx, state]
            if pr[0] > thr:
                next_beam.append(dict(node=node, state=state, lab=q(0.0),
                                      gap=q(q(lab + gap) * pr[0]), rec=rec))
            for label in range(n_base):
                p = pr[label + 1]
                if p < thr:
                    continue
                child = tree.get_child(node, label)
                if child is None:
                    child = tree.add_node(node, label, idx)
                next_beam.append(dict(node=child, state=(state * n_base) % S + label,
                                      lab=q(q(lab + gap) * p), gap=q(0.0),
                                      rec=held[child] if child in held else (idx, rec)))
        beam = _merge_sort_truncate(next_beam, beam_size, q)
        top = q(beam[0]["lab"] + beam[0]["gap"])
        for e in beam:
            e["lab"] = q(e["lab"] / top)
            e["gap"] = q(e["gap"] / top)

    seq, first = "", []
    if beam[0]["node"] != ROOT:
        for label, time in tree.traceback(beam[0]["node"]):
            first.append(time)
            seq += alphabet[label + 1]
    latest, rec = [], beam[0]["rec"]
    while rec is not None:
        latest.append(rec[0])
        rec = rec[1]
    return seq[::-1], first[::-1], latest[::-1]


def search(probs, init_state, decode, precision="float32"):
    """``(status, sequence, first path, latest path)`` of one chunk, with the
    configuration's decode settings, in ``precision`` (``float32`` or
    ``bfloat16``)."""
    q = {"float32": f32, "bfloat16": bf16}[precision]
    try:
        seq, first, latest = crf_beam_search(probs, init_state, decode["alphabet"],
                                             decode["beam_size"],
                                             decode["beam_cut_threshold"], q=q)
    except SearchFailure as e:
        return e.code, "", [], []
    return 0, seq, first, latest
