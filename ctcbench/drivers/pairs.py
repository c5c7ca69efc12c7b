"""Closed loop, one caller: ``decode_many_duplex`` over host pairs.

A pool of ``pool_pairs`` pairs: read 1's lengths from the configuration's
distribution, read 2's from read 1's times ``U(*read2_ratio)`` (both as
seed-free quantiles in an order drawn from the seed), envelopes on the true
alignment (``gen/pairs.py``).  Each call takes the next ``call_pairs``
pairs, wrapping, with the port's defaults for the rest (batch size, engine).
"""

from __future__ import annotations

import numpy as np

from .. import roofline
from ..checks import duplex_checks, duplex_numbers, ref_duplex, run_all, sample
from ..gen import posteriors
from ..gen.pairs import duplex_pairs
from .common import (bucket_of, closed_loop, deal, generator, kept_indices, length_grid,
                     reset_peak)


def make_pool(cell, seed, device):
    """The cell's pool of pairs and read 1's lengths."""
    n, C = cell.traffic["pool_pairs"], cell.traffic["call_pairs"]
    t1 = deal(length_grid(cell.config, n), n // C, seed, 1)
    ratio = deal(posteriors.uniform_grid(n, *cell.config["read2_ratio"]), n // C, seed, 2)
    t2 = np.rint(t1 * ratio).astype(np.int64)
    pairs = duplex_pairs(t1, t2, cell.config["posteriors"], cell.config["envelope"],
                         generator(seed, device), device)
    return pairs, t1


#: calls of a window, for the control's sample (a 51 s window makes about 55)
CONTROL_CALLS = 50


def control_jobs(cell, seed, device):
    """The reference's jobs for a sample of ``check_pairs`` pairs drawn as a
    run draws it: from the pairs kept of ``CONTROL_CALLS`` calls (the longest
    among them)."""
    pairs, t1 = make_pool(cell, seed, device)
    n, C = len(pairs), cell.traffic["call_pairs"]
    kept = []
    for i in range(CONTROL_CALLS):
        idx = [(i * C + j) % n for j in range(C)]
        kept += [idx[k] for k in kept_indices(C, t1[idx], cell.traffic["keep_per_call"], seed, i)]
    picks = sample(range(len(kept)), t1[kept], cell.traffic["check_pairs"], seed)
    return ref_duplex, [(*pairs[kept[p]], cell.config["decode"]) for p in picks]


class Driver:
    roles = {"pad": "decode_many_duplex.pad", "device": "duplex.device",
             "detok": "duplex.detok"}

    def __init__(self, cell, seed, device, tracer, log):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.decode = self.config["decode"]
        self.seed, self.device, self.tracer, self.log = seed, device, tracer, log
        self.work = {}
        self.kept = []
        self.missing = 0

    def _decode(self, pairs):
        from fast_ctc_decode_tpu_torch import decode_many_duplex

        d = self.decode
        return decode_many_duplex(pairs, d["alphabet"], beam_size=d["beam_size"],
                                  beam_cut_threshold=d["beam_cut_threshold"],
                                  collapse_repeats=d["collapse_repeats"], device=self.device)

    def setup(self):
        self.pairs, t1 = make_pool(self.cell, self.seed, self.device)
        t2 = np.array([p[1].shape[0] for p in self.pairs])
        n = len(self.pairs)
        reset_peak(self.device)
        self.t1 = t1
        widths = np.concatenate([e[:, 1] - e[:, 0] for _, _, e in self.pairs])
        self.cells = np.array([int((e[:, 1] - e[:, 0]).sum()) for _, _, e in self.pairs])
        self.log(f"pool: {n} pairs, read 1 {posteriors.stats(_rows(self.pairs, 0), t1)}, "
                 f"read 2 frames {int(t2.sum())}, envelope width mean {widths.mean():.2f} "
                 f"max {int(widths.max())}")
        first = {}
        for i, (T1, T2) in enumerate(zip(t1, t2)):
            first.setdefault((bucket_of(T1), bucket_of(T2)), i)
        self._decode([self.pairs[i] for i in sorted(first.values())])
        self._decode(self.pairs[: self.traffic["call_pairs"]])

    def counters(self):
        return {}

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
                tot["f2"] += sum(p[1].shape[0] for p in pairs)
                tot["cells"] += int(self.cells[idx].sum())
                tot["bases"] += sum(len(r[0]) for r in res)
                for k in kept_indices(C, self.t1[idx], self.traffic["keep_per_call"],
                                      self.seed, i):
                    self.kept.append((idx[k], res[k] if k < len(res) else None))

        dt, calls = closed_loop(seconds, call, self.log)
        K, A1 = self.decode["beam_size"], len(self.decode["alphabet"])
        self.work["duplex"] = roofline.duplex_work(tot["f1"], tot["f2"], tot["cells"],
                                                   tot["pairs"], tot["bases"], K, A1)
        self.log(f"{calls} calls of {C} pairs")
        return Window(dt, tot["pairs"], tot["failed"] + self.missing,
                      {"pairs_per_s": tot["pairs"] / dt})

    def release(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        picks = sample(range(len(self.kept)), [self.t1[j] for j, _ in self.kept],
                       self.traffic["check_pairs"], self.seed)
        got = [self.kept[p][1] for p in picks]
        jobs = [(*self.pairs[self.kept[p][0]], self.decode) for p in picks]
        want = run_all(ref_duplex, jobs, [len(j[0]) * 1.0 for j in jobs])
        wrong = [self.kept[p][0] for p, g, w in zip(picks, got, want)
                 if g is None or tuple(g) != (w[1], w[0])]
        _, _, edits, bases = duplex_numbers(got, want)
        self.log(f"checked pairs {sorted(self.kept[p][0] for p in picks)} of the pool, "
                 f"{bases} reference bases, {edits} edits; differing: {wrong}")
        return duplex_checks(got, want, self.missing)

    def close(self):
        pass


def _rows(pairs, which):
    import torch

    return torch.from_numpy(np.concatenate([p[which] for p in pairs]))
