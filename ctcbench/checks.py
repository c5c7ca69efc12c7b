"""What decides ``correct``: the sample drawn from the seed, the reference
run over it in worker processes, and the numbers compared with their limits.

The workers are ``python -m ctcbench.checks`` processes: each reads its
jobs (pickled by this process) on its standard input and writes the results
on its standard output.  They import only this module, ``ctcbench.reference``
and NumPy, and never touch the card.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class Check:
    """One number compared with its limit: the run is correct when every
    ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def sample(candidates: Sequence[int], sizes: Sequence[int], n: int, seed: int) -> List[int]:
    """``n`` of ``candidates`` drawn from ``seed``, the one of the largest
    ``sizes`` always among them, in their order."""
    candidates = list(candidates)
    if len(candidates) <= n:
        return candidates
    longest = int(np.argmax(np.asarray(sizes)))
    rest = [i for i in range(len(candidates)) if i != longest]
    rng = np.random.default_rng([seed, 0x5A])
    pick = sorted([longest, *rng.choice(rest, size=n - 1, replace=False).tolist()])
    return [candidates[i] for i in pick]


def ref_beam(probs, decode, precision="float32"):
    """``(status, sequence, first path, latest path)`` of one read."""
    from .reference import bf16, f32
    from .reference.ctc import SearchFailure, beam_search

    q = {"float32": f32, "bfloat16": bf16}[precision]
    try:
        seq, first, latest = beam_search(
            probs, decode["alphabet"], decode["beam_size"], decode["beam_cut_threshold"],
            decode["collapse_repeats"], q=q)
    except SearchFailure as e:
        return e.code, "", [], []
    return 0, seq, first, latest


def ref_duplex(net1, net2, env, decode, precision="float32"):
    """``(status, sequence)`` of one pair."""
    from .reference import bf16, f32
    from .reference.ctc import SearchFailure
    from .reference.duplex import beam_search_duplex

    q = {"float32": f32, "bfloat16": bf16}[precision]
    try:
        return 0, beam_search_duplex(net1, net2, decode["alphabet"], env, decode["beam_size"],
                                     decode["beam_cut_threshold"], decode["collapse_repeats"],
                                     q=q)
    except SearchFailure as e:
        return e.code, ""


def run_all(fn, jobs, sizes, workers=None):
    """``[fn(*job) for job in jobs]``, spread over worker processes so that
    each gets about the same total of ``sizes``; every worker has ended when
    this returns."""
    if not jobs:
        return []
    workers = workers or max(1, min(6, (os.cpu_count() or 2) - 2, len(jobs)))
    if workers == 1:
        return [fn(*job) for job in jobs]
    shares, load = [[] for _ in range(workers)], [0] * workers
    for i in sorted(range(len(jobs)), key=lambda i: -sizes[i]):
        w = load.index(min(load))
        shares[w].append(i)
        load[w] += sizes[i]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    procs = []
    try:
        for share in shares:
            p = subprocess.Popen([sys.executable, "-m", f"{__package__}.checks"], env=env,
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            procs.append(p)
            p.stdin.write(pickle.dumps((fn.__name__, [jobs[i] for i in share])))
            p.stdin.close()
        out = [None] * len(jobs)
        for p, share in zip(procs, shares):
            results = pickle.loads(p.stdout.read())
            if p.wait() != 0:
                raise RuntimeError(f"a reference worker exited with {p.returncode}")
            for i, r in zip(share, results):
                out[i] = r
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def compare_beam(got, want):
    """Counts of the sample's reads whose status, sequence and (latest-entry)
    path differ from the reference, and whose path differs from upstream's
    first-creation path (reported, not judged).  ``got`` holds ``(sequence,
    path, status)``; a missing answer is ``None``."""
    n = dict(status=0, seq=0, path=0, first=0, bad=[])
    for k, (g, (status, seq, first, latest)) in enumerate(zip(got, want)):
        if g is None:
            n["status"] += 1
            n["bad"].append(k)
            continue
        gseq, gpath, gstatus = g
        wrong = (int(gstatus) != status, gseq != seq, list(gpath) != list(latest))
        for key, w in zip(("status", "seq", "path"), wrong):
            n[key] += w
        n["first"] += list(gpath) != list(first)
        if any(wrong):
            n["bad"].append(k)
    return n


def beam_checks(got, want, missing: int, log, what):
    """The checks of a beam cell, every limit 0 (an exact comparison).
    Logs how many of the sample's paths differ from upstream's
    first-creation path, and which of ``what`` (the sample's names for the
    log) differ from the reference."""
    n = compare_beam(got, want)
    log(f"checked {len(got)}; paths that differ from upstream's first-creation path: "
        f"{n['first']}; differing: {[what[k] for k in n['bad']]}")
    return [
        Check("missing_answers", missing, 0),
        Check("status_mismatch", n["status"], 0),
        Check("seq_mismatch", n["seq"], 0),
        Check("path_mismatch", n["path"], 0),
    ]


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance of two strings: their common ends cut off, then
    one NumPy row of the table a character of the shorter."""
    i = 0
    while i < min(len(a), len(b)) and a[i] == b[i]:
        i += 1
    j = 0
    while j < min(len(a), len(b)) - i and a[-1 - j] == b[-1 - j]:
        j += 1
    a, b = a[i:len(a) - j], b[i:len(b) - j]
    if len(a) > len(b):
        a, b = b, a
    if not a:
        return len(b)
    bs = np.frombuffer(b.encode(), np.uint8)
    cols = np.arange(len(b) + 1)
    row = cols.copy()
    for k, ch in enumerate(a.encode(), 1):
        sub = row[:-1] + (bs != ch)
        nxt = np.empty_like(row)
        nxt[0] = k
        nxt[1:] = np.minimum(row[1:] + 1, sub)
        # an insertion chain along the row: nxt[j] = min over i <= j of nxt[i] + j - i
        row = np.minimum.accumulate(nxt - cols) + cols
    return int(row[-1])


#: Duplex sequences: at most this many pairs of a sample may differ from the
#: reference at all, and the sample's summed edit distance over its summed
#: reference bases may reach at most ``EDIT_SHARE_LIMIT``.  Sound runs read
#: at most 1 pair and 3e-5; the bfloat16 control 11-12 pairs and 0.035, a
#: base changed in every answer 12 pairs, half of the answers blanked 0.55
#: and more (PERF.md, section 4, gives the readings).
DIFFERING_PAIRS_LIMIT = 4
EDIT_SHARE_LIMIT = 0.005


def duplex_numbers(got, want):
    """``(status, differing pairs, summed edit distance, summed reference
    bases)`` of a sample: ``got`` holds ``(sequence, status)`` or None for a
    missing answer, ``want`` the reference's ``(status, sequence)``."""
    status = differing = edits = bases = 0
    for g, (wstatus, wseq) in zip(got, want):
        bases += len(wseq)
        if g is None:
            status += 1
            differing += 1
            edits += len(wseq)
            continue
        status += int(g[1]) != wstatus
        if g[0] != wseq:
            differing += 1
            edits += edit_distance(g[0], wseq)
    return status, differing, edits, bases


def duplex_checks(got, want, missing: int):
    """The checks of a duplex cell; missing answers and statuses exact."""
    status, differing, edits, bases = duplex_numbers(got, want)
    return [Check("missing_answers", missing, 0), Check("status_mismatch", status, 0),
            Check("differing_pairs", differing, DIFFERING_PAIRS_LIMIT),
            Check("edit_share", edits / max(bases, 1), EDIT_SHARE_LIMIT)]


def _worker():
    name, jobs = pickle.loads(sys.stdin.buffer.read())
    fn = {"ref_beam": ref_beam, "ref_duplex": ref_duplex}[name]
    sys.stdout.buffer.write(pickle.dumps([fn(*job) for job in jobs]))


if __name__ == "__main__":
    _worker()
