"""Reference CRF duplex beam search (upstream src/duplex.rs:652-834).

The two reads of a pair are CRF scores, ``[T, n_state, A+1]`` linear
probabilities (stay first, then one entry a base), each with its
``init_state [n_state]``.  Read 1 drives a beam as in ``crf.py``: every tip
reads the row of its own state, a label ``a`` moves state ``s`` to ``(s *
A) % n_state + a``, and there is no collapse of repeats.  Each prefix
carries a banded forward pass over read 2 under the envelope, as in
``duplex.py``, reading read 2's rows at a fixed state:

- the root band is the blank-state walk from ``argmax(init2)``: cell ``i``
  adds read 2's stay entry at the walk's state, which moves to ``(state *
  A) % n_state`` a cell (src/duplex.rs:411-441);
- a new child's band is built at its parent tip's state (the state before
  the child's label; src/duplex.rs:251-288), an extension at the beam
  entry's own state, the state after the label (src/duplex.rs:290-336,
  711-731), as upstream does;
- neither recurrence has a repeat branch.

The bands of the children a step creates are built side by side (``build``,
one cell of every band at a time on arrays): each band's cells go through
the same float32 operations in the same order as one at a time, so the
values are those of building them one by one.  Nothing reads a new band
before the step's candidates are all made.

A tip's score is its read-1 total times its band's largest total over the
current window; entries of one node merge, a NaN among two or more scores
fails the pair, the beam keeps ``beam_size`` by score.

Departures from upstream, each for the benchmark's comparison:

- Failures are returned as the wire's status codes (``SearchFailure``),
  where upstream returns its ``SearchError``.
- ``q`` rounds the inputs and the result of every arithmetic step: ``f32``,
  the configuration's precision, leaves upstream's float32 arithmetic as it
  is; ``bf16`` is the precision control.  The init states are rounded by
  ``q`` before their argmax.
- An envelope of None is the full range of read 2 for every frame of read 1.
- ``log``, ``exp`` and ``ln_1p`` are upstream's float32 functions correctly
  rounded: computed in float64 and rounded once to float32, as libm's
  ``logf``, ``expf`` and ``log1pf`` that upstream calls nearly always give.
  The sibling references take NumPy's float32 functions, vectorised
  approximations that differ from the correctly rounded result on 22 %
  (``log`` on (0, 1)), 40 % (``exp`` on band differences) and 17 %
  (``log1p``) of arguments; PyTorch's on the CPU on about 1 %.  On pairs of
  thousands of frames such differences, an ulp in a band at a time, move a
  near tie of the beam (``PERF.md``).
"""

from __future__ import annotations

import numpy as np

from .ctc import (INCOMPARABLE_VALUES, INVALID_ENVELOPE, RAN_OUT_OF_BEAM, ROOT,
                  SearchFailure, Tree)
from .duplex import NEG_INF, SecondaryProbs, _Log
from .precision import bf16, f32, round_array


def _f32(fn, x):
    """float32 ``fn(x)`` correctly rounded: computed in float64 and rounded
    once (scalars and arrays)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return fn(np.asarray(x, np.float64)).astype(np.float32)


def _log(a, q):
    """The inputs' logs, each input and result rounded by ``q``."""
    return round_array(_f32(np.log, round_array(a, q)), q)


class _Scalars(_Log):
    """``duplex._Log`` with upstream's float32 ``exp`` and ``ln_1p`` correctly
    rounded (``_f32``) in place of NumPy's float32 ones."""

    def add(self, a, b):
        small, big = (a, b) if a <= b else (b, a)
        q = self.q
        if small == NEG_INF:
            return q(big)
        return q(big + q(_f32(np.log1p, q(_f32(np.exp, q(small - big))))))


def _fill(sp, l2, parent, label, state, start, hi, last, ls):
    """Append cells ``[start, hi)`` to ``sp`` at read 2's rows of ``state``."""
    for idx in range(start, hi):
        row = l2[idx, state]
        gap_prob = ls.mul(ls.total(last), row[0])
        pl, pg = parent.get(idx - 1)
        label_prob = ls.mul(row[label + 1], ls.add(last[0], ls.add(pl, pg)))
        last = (label_prob, gap_prob)
        sp.probs.append(last)
        t = ls.total(last)
        sp.max_prob = t if sp.max_prob < t else sp.max_prob


class _Cells:
    """``_Scalars``' ``add`` and ``mul`` on float32 arrays, element by element
    in the same operations and roundings, so that each element equals the
    scalar result (callers hold ``np.errstate(invalid="ignore")``)."""

    def __init__(self, q):
        self.r = None if q is f32 else (lambda a: round_array(a, q))

    def add(self, a, b):
        first = a <= b
        small, big = np.where(first, a, b), np.where(first, b, a)
        r = self.r
        if r is None:  # float32 arrays: every operation already rounds to float32
            return np.where(small == NEG_INF, big,
                            big + _f32(np.log1p, _f32(np.exp, small - big)))
        return np.where(small == NEG_INF, r(big),
                        r(big + r(_f32(np.log1p, r(_f32(np.exp, r(small - big)))))))

    def mul(self, a, b):
        return a + b if self.r is None else self.r(a + b)


def _window(sp, start, n):
    """Cells ``[start, start + n)`` of ``sp`` as (label, gap) float32 arrays,
    ``-inf`` outside it, as ``sp.get`` reads them."""
    lab, gap = np.full(n, NEG_INF, np.float32), np.full(n, NEG_INF, np.float32)
    i0 = start - sp.offset
    a, b = max(i0, 0), min(i0 + n, len(sp.probs))
    if a < b:
        seg = np.array(sp.probs[a:b], np.float32).reshape(-1, 2)
        lab[a - i0:b - i0], gap[a - i0:b - i0] = seg[:, 0], seg[:, 1]
    return lab, gap


def build(l2, new, lo, hi, cells):
    """src/duplex.rs:251-288 for every band ``new`` holds, ``(parent band,
    label, state)`` each, over one window ``[lo, hi)``: the bands are built
    side by side, a cell of each at a time, in the recurrence's order.
    Returns the new ``SecondaryProbs``."""
    n, m = hi - lo, len(new)
    states = np.array([s for _, _, s in new], np.int64)
    labels = np.array([a for _, a, _ in new], np.int64)
    rows = l2[np.arange(lo, hi)[:, None], states[None, :]]  # [n, m, A+1]
    stay = rows[:, :, 0]
    emit = np.take_along_axis(rows, labels[None, :, None] + 1, axis=2)[:, :, 0]
    windows = {}
    for parent, _, _ in new:
        if id(parent) not in windows:
            windows[id(parent)] = _window(parent, lo - 1, n)
    pl = np.stack([windows[id(p)][0] for p, _, _ in new], 1)
    pg = np.stack([windows[id(p)][1] for p, _, _ in new], 1)
    lab, gap = np.empty((n, m), np.float32), np.empty((n, m), np.float32)
    last_l = last_g = np.full(m, NEG_INF, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        # the parent's (label + gap) at the previous cell, and each cell's
        # total, do not feed the recurrence: they are taken for all cells
        # at once
        parent = cells.add(pl, pg)
        for c in range(n):
            g = cells.mul(cells.add(last_l, last_g), stay[c])
            last_l = cells.mul(emit[c], cells.add(last_l, parent[c]))
            last_g = g
            lab[c], gap[c] = last_l, last_g
        total = cells.add(lab, gap)
    top = np.full(m, NEG_INF, np.float32)
    for t in total:
        top = np.where(top < t, t, top)
    out = []
    for j in range(m):
        sp = SecondaryProbs(lo)
        sp.probs = list(zip(lab[:, j], gap[:, j]))
        sp.max_prob = top[j]
        out.append(sp)
    return out


def extend(sp, l2, parent, label, state, lo, hi, ls):
    """src/duplex.rs:290-336."""
    if lo > sp.offset:
        sp.discard_until(lo - 1)
        if not sp.probs:
            sp.offset = lo
        sp.update_max(lo, hi, ls)
    last = sp.probs[-1] if sp.probs else (NEG_INF, NEG_INF)
    _fill(sp, l2, parent, label, state, sp.end(), hi, last, ls)


def root_probs(l2, state, upper, ls):
    """src/duplex.rs:411-441: the blank-state walk from ``state``."""
    T2, S, A1 = l2.shape
    sp = SecondaryProbs(-1)
    sp.max_prob = np.float32(0.0)
    cur = np.float32(0.0)
    sp.probs.append((NEG_INF, cur))
    for i in range(min(int(upper), T2)):
        cur = ls.mul(cur, l2[i, state, 0])
        sp.probs.append((NEG_INF, cur))
        state = (state * (A1 - 1)) % S
    return sp


def crf_beam_search_duplex(net1, init1, net2, init2, alphabet, envelope=None, beam_size=5,
                           beam_cut_threshold=0.0, q=f32):
    """The consensus sequence of one pair; raises ``SearchFailure`` where
    upstream raises."""
    ls, cells = _Scalars(q), _Cells(q)
    l1 = _log(net1, q)
    l2 = _log(net2, q)
    thr = q(_f32(np.log, q(beam_cut_threshold)))
    T1, S, A1 = l1.shape
    T2 = l2.shape[0]
    n_base = A1 - 1
    if envelope is None:
        envelope = np.stack([np.zeros(T1, np.int64), np.full(T1, T2, np.int64)], axis=1)
    envelope = np.asarray(envelope)
    start1 = int(np.argmax(round_array(init1, q)))
    start2 = int(np.argmax(round_array(init2, q)))

    tree = Tree()
    beam = [dict(node=ROOT, state=start1, p1l=NEG_INF, p1g=np.float32(0.0),
                 p2max=np.float32(0.0))]
    root_sp = root_probs(l2, start2, int(envelope[0, 1]), ls)
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
                    extend(tree.data[node], l2, parent_sp, tree.label[node], tip["state"], lo,
                           hi, ls)
        last_upper = hi

        next_beam, new = [], []
        for tip in beam:
            node, state = tip["node"], tip["state"]
            pr = l1[t, state]
            p1_total = ls.add(tip["p1l"], tip["p1g"])
            if pr[0] > thr:
                next_beam.append(dict(node=node, state=state, p1l=NEG_INF,
                                      p1g=ls.mul(p1_total, pr[0]), p2max=tip["p2max"]))
            for label in range(n_base):
                p = pr[label + 1]
                if p < thr:
                    continue
                child = tree.get_child(node, label)
                if child is None:
                    # its band is built below, with the step's other new ones
                    child = tree.add_node(node, label, None)
                    new.append((child, tree.data[node] if node >= 0 else root_sp, label, state))
                next_beam.append(dict(node=child, state=(state * n_base) % S + label,
                                      p1l=ls.mul(p1_total, p), p1g=NEG_INF,
                                      p2max=tip["p2max"]))

        if new:
            for (child, *_), sp in zip(new, build(l2, [x[1:] for x in new], lo, hi, cells)):
                tree.data[child] = sp

        # merge by node, refresh p2max from the tree, check for NaN, sort by
        # score, truncate, as the plain duplex beam does
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
            raise SearchFailure(INCOMPARABLE_VALUES, "Failed to compare values (NaNs in input?)")
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


def search(net1, init1, net2, init2, env, decode, precision="float32"):
    """``(status, sequence)`` of one pair, with the configuration's decode
    settings, in ``precision`` (``float32`` or ``bfloat16``)."""
    q = {"float32": f32, "bfloat16": bf16}[precision]
    try:
        return 0, crf_beam_search_duplex(net1, init1, net2, init2, decode["alphabet"], env,
                                         decode["beam_size"], decode["beam_cut_threshold"], q=q)
    except SearchFailure as e:
        return e.code, ""
