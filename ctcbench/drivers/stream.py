"""Closed loop, one caller: ``decode_many`` over host reads.

Each call takes the next ``call_reads`` reads of a pool of ``pool_reads``,
wrapping, and passes them to ``decode_many`` with the configuration's decode
settings and the port's defaults for everything else (batch size, bucket
edges, engine), so a change of a default shows here.
"""

from __future__ import annotations

from .. import roofline
from ..checks import beam_checks, ref_beam, run_all, sample
from .common import bucket_of, closed_loop, deal, host_reads, kept_indices, length_grid


def pool(cell, seed):
    """Read lengths of the pool, call by call (``common.deal``)."""
    n, C = cell.traffic["pool_reads"], cell.traffic["call_reads"]
    return deal(length_grid(cell.config, n), n // C, seed)


def control_jobs(cell, seed, device):
    """The reference's jobs for a sample of the cell's size drawn from the
    pool of ``seed`` (the longest read among them), for ``ctcbench.control``."""
    lengths = pool(cell, seed)
    reads, _ = host_reads(lengths, cell.config["posteriors"], seed, device)
    picks = sample(range(len(reads)), lengths, cell.traffic["check_reads"], seed)
    return ref_beam, [(reads[i], cell.config["decode"]) for i in picks]


class Driver:
    roles = {"detok": "beam.detok", "pad": "decode_many.pad", "device": "beam.device"}

    def __init__(self, cell, seed, device, tracer, log):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.decode = self.config["decode"]
        self.seed, self.device, self.tracer, self.log = seed, device, tracer, log
        self.work = {}
        self.kept = []
        self.missing = 0

    def _decode(self, reads):
        from fast_ctc_decode_tpu_torch import decode_many

        d = self.decode
        return decode_many(reads, d["alphabet"], beam_size=d["beam_size"],
                           beam_cut_threshold=d["beam_cut_threshold"],
                           collapse_repeats=d["collapse_repeats"], device=self.device)

    def setup(self):
        self.lengths = pool(self.cell, self.seed)
        self.reads, stats = host_reads(self.lengths, self.config["posteriors"], self.seed,
                                       self.device)
        self.log(f"pool: {stats}")
        first = {}
        for i, T in enumerate(self.lengths):
            first.setdefault(bucket_of(T), i)
        self._decode([self.reads[i] for i in sorted(first.values())])
        self._decode(self.reads[: self.traffic["call_reads"]])

    def counters(self):
        return {}

    def window(self, seconds):
        from ..harness import Window

        n, C = len(self.reads), self.traffic["call_reads"]
        span = self.tracer.span
        tot = dict(frames=0, reads=0, bases=0, failed=0)

        def call(i):
            with span("ctcbench.pool"):
                idx = [(i * C + j) % n for j in range(C)]
                reads = [self.reads[j] for j in idx]
            with span("ctcbench.call"):
                res = self._decode(reads)
            with span("ctcbench.results"):
                self.missing += max(0, C - len(res))
                tot["failed"] += sum(1 for r in res if r[2] != 0)
                tot["frames"] += int(self.lengths[idx].sum())
                tot["reads"] += C
                tot["bases"] += sum(len(r[0]) for r in res)
                for k in kept_indices(C, self.lengths[idx], self.traffic["keep_per_call"],
                                      self.seed, i):
                    self.kept.append((idx[k], res[k] if k < len(res) else None))

        dt, calls = closed_loop(seconds, call, self.log)
        K, A1 = self.decode["beam_size"], len(self.decode["alphabet"])
        self.work["beam"] = roofline.beam_work(tot["frames"], tot["reads"], tot["bases"], K, A1)
        self.log(f"{calls} calls of {C} reads, {tot['frames']} frames")
        return Window(dt, tot["reads"], tot["failed"] + self.missing,
                      {"frames_per_s": tot["frames"] / dt})

    def release(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        picks = sample(range(len(self.kept)), [self.lengths[j] for j, _ in self.kept],
                       self.traffic["check_reads"], self.seed)
        got = [self.kept[p][1] for p in picks]
        reads = [self.reads[self.kept[p][0]] for p in picks]
        want = run_all(ref_beam, [(r, self.decode) for r in reads], [len(r) for r in reads])
        return beam_checks(got, want, self.missing, self.log,
                           [f"read {self.kept[p][0]}" for p in picks])

    def close(self):
        pass
