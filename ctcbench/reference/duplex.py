"""Reference duplex beam search (upstream src/duplex.rs:443-650).

A frozen copy of the repository's NumPy oracle: the two reads' posteriors
in log space, a banded forward pass over read 2 per prefix (bounded by the
alignment envelope), and the beam over read 1.  ``q`` rounds after every
arithmetic step, as in ``ctc.py``.
"""

from __future__ import annotations

import numpy as np

from .ctc import (INCOMPARABLE_VALUES, INVALID_ENVELOPE, RAN_OUT_OF_BEAM, ROOT,
                  SearchFailure, Tree)
from .precision import f32, round_array

NEG_INF = np.float32("-inf")


class _Log:
    """Log-space arithmetic at the rounding ``q`` (src/duplex.rs:42-63)."""

    def __init__(self, q):
        self.q = q

    def add(self, a, b):
        small, big = (a, b) if a <= b else (b, a)
        if small == NEG_INF:
            return self.q(big)
        return self.q(big + self.q(np.log1p(self.q(np.exp(self.q(small - big))))))

    def mul(self, a, b):
        return self.q(a + b)

    def total(self, lg):
        return self.add(lg[0], lg[1])


class SecondaryProbs:
    """Banded forward pass over read 2's frames (src/duplex.rs:151-210)."""

    def __init__(self, offset):
        self.offset = offset
        self.probs = []
        self.max_prob = NEG_INF

    def get(self, at):
        i = at - self.offset
        if 0 <= i < len(self.probs):
            return self.probs[i]
        return (NEG_INF, NEG_INF)

    def end(self):
        return self.offset + len(self.probs)

    def discard_until(self, keep_from):
        if keep_from > self.offset:
            first = keep_from - self.offset
            del self.probs[: max(0, min(first, len(self.probs)))]
            self.offset = keep_from

    def update_max(self, lo, hi, ls):
        begin = min(max(lo - self.offset, 0), len(self.probs))
        end = min(max(hi - self.offset, begin), len(self.probs))
        m = NEG_INF
        for lg in self.probs[begin:end]:
            t = ls.total(lg)
            m = t if m < t else m
        self.max_prob = m


def _fill(sp, net2, parent, label, is_repeat, start, hi, last, ls):
    for idx in range(start, hi):
        row = net2[idx]
        gap_prob = ls.mul(ls.total(last), row[0])
        pl, pg = parent.get(idx - 1)
        if is_repeat:
            label_prob = ls.mul(row[label + 1], ls.add(last[0], pg))
        else:
            label_prob = ls.mul(row[label + 1], ls.add(last[0], ls.add(pl, pg)))
        last = (label_prob, gap_prob)
        sp.probs.append(last)
        t = ls.total(last)
        sp.max_prob = t if sp.max_prob < t else sp.max_prob


def build_secondary_probs(net2, parent, label, is_repeat, lo, hi, ls):
    """src/duplex.rs:212-249."""
    out = SecondaryProbs(lo)
    _fill(out, net2, parent, label, is_repeat, lo, hi, (NEG_INF, NEG_INF), ls)
    return out


def extend_secondary_probs(sp, net2, parent, label, is_repeat, lo, hi, ls):
    """src/duplex.rs:338-387."""
    if lo > sp.offset:
        sp.discard_until(lo - 1)
        if not sp.probs:
            sp.offset = lo
        sp.update_max(lo, hi, ls)
    last = sp.probs[-1] if sp.probs else (NEG_INF, NEG_INF)
    _fill(sp, net2, parent, label, is_repeat, sp.end(), hi, last, ls)


def root_probs(net2_blank_col, upper, ls):
    """src/duplex.rs:389-409."""
    sp = SecondaryProbs(-1)
    sp.max_prob = np.float32(0.0)
    cur = np.float32(0.0)
    sp.probs.append((NEG_INF, cur))
    for i in range(upper):
        cur = ls.mul(cur, net2_blank_col[i])
        sp.probs.append((NEG_INF, cur))
    return sp


def _log(a, q):
    with np.errstate(divide="ignore", invalid="ignore"):
        return round_array(np.log(round_array(a, q)).astype(np.float32), q)


def beam_search_duplex(net1, net2, alphabet, envelope, beam_size=5, beam_cut_threshold=0.0,
                       collapse_repeats=True, q=f32):
    """The consensus sequence of one pair: ``net1 [T1, A+1]``, ``net2 [T2,
    A+1]`` linear posteriors and ``envelope [T1, 2]`` (read 2's window per
    frame of read 1); raises ``SearchFailure`` where upstream raises."""
    ls = _Log(q)
    l1 = _log(net1, q)
    l2 = _log(net2, q)
    with np.errstate(divide="ignore"):
        thr = q(np.log(q(beam_cut_threshold)))
    T1, A1 = l1.shape
    T2 = l2.shape[0]
    envelope = np.asarray(envelope)

    tree = Tree()
    beam = [dict(node=ROOT, p1l=NEG_INF, p1g=np.float32(0.0), p2max=np.float32(0.0))]
    root_sp = root_probs(l2[:, 0], int(envelope[0, 1]), ls)
    last_upper = 0

    for t in range(T1):
        lo = max(int(envelope[t, 0]), 0)
        hi = min(int(envelope[t, 1]), T2)
        if lo >= hi or lo > last_upper:
            raise SearchFailure(INVALID_ENVELOPE, "Invalid envelope values")

        if hi > last_upper:
            beam.sort(key=lambda e: e["node"])  # parents before children
            for tip in beam:
                node = tip["node"]
                if node >= 0:
                    par = tree.parent[node]
                    parent_sp = tree.data[par] if par >= 0 else root_sp
                    extend_secondary_probs(
                        tree.data[node], l2, parent_sp, tree.label[node],
                        tree.tip_label(par) == tree.label[node], lo, hi, ls,
                    )
        last_upper = hi

        pr = l1[t]
        next_beam = []
        for tip in beam:
            node = tip["node"]
            tip_label = tree.tip_label(node)
            p1_total = ls.add(tip["p1l"], tip["p1g"])
            if pr[0] > thr:
                next_beam.append(dict(node=node, p1l=NEG_INF, p1g=ls.mul(p1_total, pr[0]),
                                      p2max=tip["p2max"]))
            for label in range(A1 - 1):
                p = pr[label + 1]
                if p < thr:
                    continue
                parent_sp = tree.data[node] if node >= 0 else root_sp
                if collapse_repeats and tip_label == label:
                    next_beam.append(dict(node=node, p1l=ls.mul(tip["p1l"], p), p1g=NEG_INF,
                                          p2max=tip["p2max"]))
                    child = tree.get_child(node, label)
                    if child is None and tip["p1g"] > NEG_INF:
                        sp = build_secondary_probs(l2, parent_sp, label, True, lo, hi, ls)
                        child = tree.add_node(node, label, sp)
                    if child is not None:
                        next_beam.append(dict(node=child, p1l=ls.mul(tip["p1g"], p),
                                              p1g=NEG_INF, p2max=tip["p2max"]))
                else:
                    child = tree.get_child(node, label)
                    if child is None:
                        sp = build_secondary_probs(l2, parent_sp, label, False, lo, hi, ls)
                        child = tree.add_node(node, label, sp)
                    next_beam.append(dict(node=child, p1l=ls.mul(p1_total, p), p1g=NEG_INF,
                                          p2max=tip["p2max"]))

        # merge by node (fold the read-1 pairs), refresh p2max from the tree,
        # check for NaN, sort by score, truncate (src/duplex.rs:595-635)
        next_beam.sort(key=lambda e: e["node"])
        merged = []
        for e in next_beam:
            if merged and merged[-1]["node"] == e["node"]:
                acc = merged[-1]
                acc["p1l"] = ls.add(acc["p1l"], e["p1l"])
                acc["p1g"] = ls.add(acc["p1g"], e["p1g"])
            else:
                merged.append(e)
        for e in merged:
            if e["node"] >= 0:
                e["p2max"] = tree.data[e["node"]].max_prob
        beam = merged

        def score(e):
            return ls.mul(ls.add(e["p1l"], e["p1g"]), e["p2max"])

        scores = [score(e) for e in beam]
        if len(beam) >= 2 and any(np.isnan(s) for s in scores):
            raise SearchFailure(INCOMPARABLE_VALUES,
                                "Failed to compare values (NaNs in input?)")
        beam.sort(key=lambda e: -float(score(e)))
        del beam[beam_size:]
        if not beam:
            raise SearchFailure(RAN_OUT_OF_BEAM,
                                "Ran out of search space (beam_cut_threshold too high)")

    seq = ""
    if beam[0]["node"] != ROOT:
        for label, _ in tree.traceback(beam[0]["node"]):
            seq += alphabet[label + 1]
    return seq[::-1]
