"""Closed loop, one caller: ``decode_many_crf_duplex`` over CRF pairs left
on the card.

A pool of ``pool_pairs`` pairs (``gen/crf_pairs.py``), each read's
``[T, n_state, A+1]`` scores a tensor of its own on the card, as a GPU
basecaller leaves each read's stitched scores: read 1's lengths from the
configuration's distribution, read 2's from read 1's times
``U(*read2_ratio)`` (both as seed-free quantiles dealt to the calls in an
order drawn from the seed, ``common.deal``), envelopes on the true
alignment.  Each call passes the next ``call_pairs`` pairs, wrapping, to
``decode_many_crf_duplex`` with the configuration's decode settings and the
port's defaults for everything else (batch size, bucket edges, engine), so a
change of a default shows here.

The check draws ``check_pairs`` distinct pairs of the pool from those whose
answers were kept (the longest among them; the pool wraps, so a window keeps
some pairs more than once), copies them home and decodes each once with the
NumPy reference (``reference/crf_duplex.py``) in worker processes that this
module starts (``checks.run_all``'s workers know only the beam and duplex
references).  Every kept answer of a drawn pair is compared with its
reference answer, and the pair counts by the answer furthest from it.  The
numbers are ``checks.duplex_checks``'.
"""

from __future__ import annotations

import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .. import roofline_crf_duplex
from ..checks import duplex_checks, duplex_numbers, edit_distance, sample
from ..gen import crf_pairs, posteriors
from ..reference.crf_duplex import search
from .common import bucket_of, closed_loop, deal, generator, kept_indices, length_grid, reset_peak
from .crf_chunks import reference_workers

#: the program's counters this cell reads (``crf_duplex_pad.batch_frames_per_frame``)
COUNTERS = ("decode_many_crf_duplex.frames", "decode_many_crf_duplex.batch_frames")

#: calls of a window, for the control's sample
CONTROL_CALLS = 20


def make_pool(cell, seed, device):
    """The cell's pool on ``device``: ``(pairs, hidden, read 1's lengths)``."""
    c = cell.config
    n, C = cell.traffic["pool_pairs"], cell.traffic["call_pairs"]
    t1 = deal(length_grid(c, n), n // C, seed, 1)
    ratio = deal(posteriors.uniform_grid(n, *c["read2_ratio"]), n // C, seed, 2)
    t2 = np.rint(t1 * ratio).astype(np.int64)
    pairs, hidden = crf_pairs.crf_duplex_pairs(t1, t2, c["decode"]["n_state"], c["posteriors"],
                                               c["envelope"], generator(seed, device), device)
    return pairs, hidden, t1


def run_reference(jobs, workers=None):
    """``[reference.crf_duplex.search(*job) for job in jobs]``, the jobs
    spread over worker processes started with ``spawn``, the longest first;
    every worker has ended when this returns."""
    if not jobs:
        return []
    workers = workers or reference_workers(len(jobs))
    if workers == 1:
        return [search(*job) for job in jobs]
    order = sorted(range(len(jobs)), key=lambda i: -len(jobs[i][0]))
    out = [None] * len(jobs)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        for i, r in zip(order, ex.map(search, *zip(*[jobs[i] for i in order]))):
            out[i] = r
    return out


def _home(pair, decode):
    """A pair's reference job: its arrays on the host, the decode settings."""
    return (*(x.cpu().numpy() for x in pair[:4]), pair[4], decode)


def checked_pairs(kept, t1, n, seed):
    """The pool's pairs a check decodes: ``n`` distinct ones of those that
    ``kept`` (pool indices, repeats allowed) names, drawn from ``seed``, the
    one of the longest read 1 (``t1``) always among them, in pool order."""
    which = sorted(set(kept))
    return sample(which, [t1[j] for j in which], n, seed)


def furthest(answers, want):
    """Of one pair's kept answers (``(sequence, status)`` or None), the one
    furthest from the reference's ``want`` (``(status, sequence)``): a
    missing answer, else a wrong status, else the most edits."""
    status, seq = want

    def distance(g):
        if g is None:
            return (2, 0)
        return (int(int(g[1]) != status), 0 if g[0] == seq else edit_distance(g[0], seq))

    return max(answers, key=distance)


def control_jobs(cell, seed, device):
    """The reference's jobs for the pairs a run checks, drawn as a run draws
    them (``checked_pairs``) from the pairs kept of ``CONTROL_CALLS``
    calls."""
    pairs, _, t1 = make_pool(cell, seed, device)
    n, C = len(pairs), cell.traffic["call_pairs"]
    kept = []
    for i in range(CONTROL_CALLS):
        idx = [(i * C + j) % n for j in range(C)]
        kept += [idx[k] for k in kept_indices(C, t1[idx], cell.traffic["keep_per_call"], seed, i)]
    which = checked_pairs(kept, t1, cell.traffic["check_pairs"], seed)
    return search, [_home(pairs[j], cell.config["decode"]) for j in which]


class Driver:
    roles = {"pad": "decode_many_crf_duplex.pad", "device": "crf_duplex.device",
             "detok": "crf_duplex.detok"}

    def __init__(self, cell, seed, device, tracer, log):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.decode = self.config["decode"]
        self.seed, self.device, self.tracer, self.log = seed, device, tracer, log
        self.work = {}
        self.kept = []
        self.missing = 0

    def _decode(self, pairs):
        d = self.decode
        return self.entry(pairs, d["alphabet"], beam_size=d["beam_size"],
                          beam_cut_threshold=d["beam_cut_threshold"], device=self.device)

    def setup(self):
        # first, so that a program without the entry point fails at once
        from fast_ctc_decode_tpu_torch import decode_many_crf_duplex

        self.entry = decode_many_crf_duplex
        self.pairs, hidden, self.t1 = make_pool(self.cell, self.seed, self.device)
        self.log(f"pool: {crf_pairs.stats(self.pairs, hidden)} on {self.pairs[0][0].device}")
        del hidden
        self.cells = np.array([int((e[:, 1] - e[:, 0]).sum()) for *_, e in self.pairs])
        reset_peak(self.device)
        first = {}
        for i, p in enumerate(self.pairs):
            first.setdefault((bucket_of(p[0].shape[0]), bucket_of(p[2].shape[0])), i)
        self._decode([self.pairs[i] for i in sorted(first.values())])
        self._decode(self.pairs[: self.traffic["call_pairs"]])

    def counters(self):
        from fast_ctc_decode_tpu_torch.utils import profiling

        counts = getattr(profiling.METRICS, "counts", {})
        return {k: counts[k] for k in COUNTERS if k in counts}

    def window(self, seconds):
        from ..harness import Window

        n, C = len(self.pairs), self.traffic["call_pairs"]
        span = self.tracer.span
        tot = dict(f1=0, f2=0, cells=0, pairs=0, bases=0, failed=0)

        def call(i):
            with span("ctcbench.pool"):
                idx = [(i * C + j) % n for j in range(C)]
                pairs = [self.pairs[j] for j in idx]
            with span("ctcbench.call"):
                res = self._decode(pairs)
            with span("ctcbench.results"):
                self.missing += max(0, C - len(res))
                tot["failed"] += sum(1 for r in res if r[1] != 0)
                tot["pairs"] += C
                tot["f1"] += int(self.t1[idx].sum())
                tot["f2"] += sum(p[2].shape[0] for p in pairs)
                tot["cells"] += int(self.cells[idx].sum())
                tot["bases"] += sum(len(r[0]) for r in res)
                for k in kept_indices(C, self.t1[idx], self.traffic["keep_per_call"],
                                      self.seed, i):
                    self.kept.append((idx[k], res[k] if k < len(res) else None))

        dt, calls = closed_loop(seconds, call, self.log)
        K, A1 = self.decode["beam_size"], len(self.decode["alphabet"])
        self.work["crf_duplex"] = roofline_crf_duplex.crf_duplex_work(
            tot["f1"], tot["cells"], tot["pairs"], tot["bases"], K, A1, self.decode["n_state"])
        self.log(f"{calls} calls of {C} pairs, read 1 frames {tot['f1']}, read 2 frames "
                 f"{tot['f2']}, band cells {tot['cells']}, bases {tot['bases']}")
        return Window(dt, tot["pairs"], tot["failed"] + self.missing,
                      {"pairs_per_s": tot["pairs"] / dt})

    def release(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        which = checked_pairs([j for j, _ in self.kept], self.t1, self.traffic["check_pairs"],
                              self.seed)
        answers = {j: [g for i, g in self.kept if i == j] for j in which}
        jobs = [_home(self.pairs[j], self.decode) for j in which]
        t0 = time.perf_counter()
        want = run_reference(jobs)
        self.log(f"reference over {len(jobs)} pairs ({sum(len(j[0]) for j in jobs)} frames "
                 f"of read 1) in {reference_workers(len(jobs))} processes: "
                 f"{time.perf_counter() - t0:.3f} s")
        got = [furthest(answers[j], w) for j, w in zip(which, want)]
        wrong = [j for j, g, w in zip(which, got, want) if g is None or tuple(g) != (w[1], w[0])]
        _, _, edits, bases = duplex_numbers(got, want)
        self.log(f"checked pairs {which} of the pool ({sum(map(len, answers.values()))} kept "
                 f"answers), {bases} reference bases, {edits} edits; differing: {wrong} (read 1 "
                 f"frames {[int(self.t1[j]) for j in wrong]})")
        return duplex_checks(got, want, self.missing)

    def close(self):
        pass
