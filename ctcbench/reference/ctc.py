"""Reference CTC prefix beam search (upstream src/search.rs:159-301).

A frozen copy of the repository's NumPy oracle, in the reference's exact
operation order.  Beside upstream's path (the frame at which each prefix
of the answer was first created) it follows the path that the batch
decoders document: a prefix that was pruned from the beam and derived
again later reports the frame of its latest entry into the beam.  The
benchmark compares the program's paths with the second, and logs how many
reads have a path that differs from the first without judging them.

Latest-entry bookkeeping: every beam entry carries a record ``(frame,
parent record)`` and a ``ghost`` flag.  An extension that reaches a prefix
the beam holds joins that tip's record; any other extension opens a new
record at the current frame.  A ghost is an entry that a beam without a
tree cannot hold: upstream keeps a collapsed repeat's child alive at
probability 0 when the child exists in its tree but the tip has no gap
mass; such an entry, and whatever only it produces, is a ghost, and a
ghost is never "a prefix the beam holds".
"""

from __future__ import annotations

import numpy as np

from .precision import f32, round_array

ROOT = -1

#: upstream's search errors as the wire's per-read status codes (0 is OK)
RAN_OUT_OF_BEAM, INCOMPARABLE_VALUES, INVALID_ENVELOPE = 1, 2, 3


class Tree:
    """Flat suffix tree with a (parent, label) child map (src/tree.rs)."""

    def __init__(self):
        self.parent = []
        self.label = []
        self.data = []
        self.children = {}

    def get_child(self, node, label):
        return self.children.get((node, label))

    def add_node(self, parent, label, data):
        nid = len(self.parent)
        self.children[(parent, label)] = nid
        self.parent.append(parent)
        self.label.append(label)
        self.data.append(data)
        return nid

    def tip_label(self, node):
        return self.label[node] if node >= 0 else None

    def traceback(self, node):
        out = []
        while node >= 0:
            out.append((self.label[node], self.data[node]))
            node = self.parent[node]
        return out  # leaf -> root


class SearchFailure(RuntimeError):
    """Upstream's SearchError; ``code`` is the wire status code."""

    def __init__(self, code, message):
        super().__init__(message)
        self.code = code


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
            if acc["ghost"] and not e["ghost"]:
                acc["rec"], acc["ghost"] = e["rec"], False
        else:
            merged.append(e)
    beam = merged
    probs = [q(e["lab"] + e["gap"]) for e in beam]
    if len(beam) >= 2 and any(np.isnan(p) for p in probs):
        raise SearchFailure(INCOMPARABLE_VALUES,
                            "Failed to compare values (NaNs in input?)")
    beam.sort(key=lambda e: -float(q(e["lab"] + e["gap"])))
    del beam[beam_size:]
    if not beam:
        raise SearchFailure(RAN_OUT_OF_BEAM,
                            "Ran out of search space (beam_cut_threshold too high)")
    return beam


def beam_search(probs, alphabet, beam_size=5, beam_cut_threshold=0.0,
                collapse_repeats=True, q=f32):
    """``(sequence, first_path, latest_path)`` of one read's ``[T, A+1]``
    posteriors; raises ``SearchFailure`` where upstream raises."""
    probs = round_array(probs, q)
    thr = q(beam_cut_threshold)
    tree = Tree()
    beam = [dict(node=ROOT, lab=q(0.0), gap=q(1.0), rec=None, ghost=False)]

    for idx in range(probs.shape[0]):
        pr = probs[idx]
        held = {e["node"]: e["rec"] for e in beam if not e["ghost"]}
        next_beam = []
        for tip in beam:
            node, lab, gap = tip["node"], tip["lab"], tip["gap"]
            rec, ghost = tip["rec"], tip["ghost"]
            tip_label = tree.tip_label(node)

            def arrive(child, lab_p, ghost=ghost, rec=rec):
                if child in held:
                    child_rec = held[child]
                else:
                    child_rec = (idx, rec)
                next_beam.append(dict(node=child, lab=lab_p, gap=q(0.0), rec=child_rec,
                                      ghost=ghost))

            if pr[0] > thr:
                next_beam.append(dict(node=node, lab=q(0.0), gap=q(q(lab + gap) * pr[0]),
                                      rec=rec, ghost=ghost))
            for label in range(len(pr) - 1):
                p = pr[label + 1]
                if p < thr:
                    continue
                if collapse_repeats and tip_label == label:
                    next_beam.append(dict(node=node, lab=q(lab * p), gap=q(0.0), rec=rec,
                                          ghost=ghost))
                    child = tree.get_child(node, label)
                    if child is None and gap > 0.0:
                        child = tree.add_node(node, label, idx)
                    if child is not None:
                        # no gap mass: upstream keeps the child at probability
                        # 0 only because its tree remembers it
                        arrive(child, q(gap * p),
                               ghost=ghost or not (gap > 0.0 or child in held))
                else:
                    child = tree.get_child(node, label)
                    if child is None:
                        child = tree.add_node(node, label, idx)
                    arrive(child, q(q(lab + gap) * p))
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
