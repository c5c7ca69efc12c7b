"""Closed loop, one caller: ``decode_many_crf`` over chunks left on the card.

A pool of ``pool_chunks`` chunks of ``chunk_frames`` frames over the
configuration's ``n_state`` states (``gen/crf.py``) is made on the card, as
a CRF basecaller's network leaves its output batches there.  Each call
passes the next ``call_chunks`` chunks of the pool, wrapping, to
``decode_many_crf`` as ``(posteriors, init_state)`` views of the pool, with
the configuration's decode settings and the port's defaults for everything
else (batch size, bucket edges, engine), so a change of a default shows
here.

The check copies a sample of the kept answers' chunks home and decodes them
with the NumPy reference (``reference/crf.py``) in worker processes that
this module starts (``checks.run_all``'s workers know only the beam and
duplex references).
"""

from __future__ import annotations

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .. import roofline_crf
from ..checks import beam_checks, sample
from ..gen import crf
from ..reference.crf import search
from .common import closed_loop, generator, kept_indices, reset_peak

#: the program's counters this cell reads (``crf_copy.bytes_per_frame``)
COUNTERS = ("decode_many_crf.frames", "decode_many_crf.moved_bytes")

#: calls of a window, for the control's sample
CONTROL_CALLS = 50


def make_pool(cell, seed, device):
    """The cell's pool on ``device``: ``gen.crf.crf_chunks``' tuple."""
    c = cell.config
    return crf.crf_chunks(cell.traffic["pool_chunks"], c["chunk_frames"],
                          c["decode"]["n_state"], c["posteriors"], generator(seed, device),
                          device)


def reference_workers(n: int) -> int:
    """Worker processes for ``n`` jobs, as ``checks.run_all`` counts them."""
    return max(1, min(6, (os.cpu_count() or 2) - 2, n))


def run_reference(jobs, workers=None):
    """``[reference.crf.search(*job) for job in jobs]``, the jobs spread over
    worker processes started with ``spawn``; every worker has ended when
    this returns."""
    if not jobs:
        return []
    workers = workers or reference_workers(len(jobs))
    if workers == 1:
        return [search(*job) for job in jobs]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(search, *zip(*jobs)))


def control_jobs(cell, seed, device):
    """The reference's jobs for a sample of ``check_chunks`` chunks drawn as
    a run draws it, from the chunks kept of ``CONTROL_CALLS`` calls: ``(fn,
    [(posteriors, init_state, decode), ...])`` as host arrays."""
    probs, init = make_pool(cell, seed, device)[:2]
    n, C = probs.shape[0], cell.traffic["call_chunks"]
    kept = [(i * C + k) % n for i in range(CONTROL_CALLS)
            for k in kept_indices(C, np.ones(C), cell.traffic["keep_per_call"], seed, i)]
    picks = sample(range(len(kept)), np.ones(len(kept)), cell.traffic["check_chunks"], seed)
    return search, [(probs[kept[p]].cpu().numpy(), init[kept[p]].cpu().numpy(),
                     cell.config["decode"]) for p in picks]


class Driver:
    roles = {"detok": "crf.detok", "pad": "decode_many_crf.pad", "device": "crf.device"}

    def __init__(self, cell, seed, device, tracer, log):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.decode = self.config["decode"]
        self.seed, self.device, self.tracer, self.log = seed, device, tracer, log
        self.work = {}
        self.kept = []
        self.missing = 0

    def _decode(self, chunks):
        from fast_ctc_decode_tpu_torch import decode_many_crf

        d = self.decode
        return decode_many_crf(chunks, d["alphabet"], beam_size=d["beam_size"],
                               beam_cut_threshold=d["beam_cut_threshold"], device=self.device)

    def setup(self):
        self.probs, self.init, targets, start, _ = make_pool(self.cell, self.seed, self.device)
        self.log(f"pool: {crf.stats(targets, self.init, start)}, "
                 f"{self.probs.numel() * self.probs.element_size()} bytes on {self.probs.device}")
        del targets, start
        # each chunk as the network's batch holds it: a view of the pool's rows
        self.chunks = list(zip(self.probs.unbind(0), self.init.unbind(0)))
        reset_peak(self.device)
        self._decode(self.chunks[: self.traffic["call_chunks"]])

    def counters(self):
        from fast_ctc_decode_tpu_torch.utils import profiling

        counts = getattr(profiling.METRICS, "counts", {})
        return {k: counts[k] for k in COUNTERS if k in counts}

    def window(self, seconds):
        from ..harness import Window

        n, C = self.probs.shape[0], self.traffic["call_chunks"]
        T = self.config["chunk_frames"]
        span = self.tracer.span
        tot = dict(frames=0, reads=0, bases=0, failed=0)

        def call(i):
            with span("ctcbench.pool"):
                idx = [(i * C + j) % n for j in range(C)]
                chunks = [self.chunks[j] for j in idx]
            with span("ctcbench.call"):
                res = self._decode(chunks)
            with span("ctcbench.results"):
                self.missing += max(0, C - len(res))
                tot["failed"] += sum(1 for r in res if r[2] != 0)
                tot["frames"] += C * T
                tot["reads"] += C
                tot["bases"] += sum(len(r[0]) for r in res)
                for k in kept_indices(C, np.ones(C), self.traffic["keep_per_call"], self.seed,
                                      i):
                    self.kept.append((idx[k], res[k] if k < len(res) else None))

        dt, calls = closed_loop(seconds, call, self.log)
        K, A1 = self.decode["beam_size"], len(self.decode["alphabet"])
        self.work["crf"] = roofline_crf.crf_work(tot["frames"], tot["reads"], tot["bases"], K,
                                                 A1, self.decode["n_state"])
        self.log(f"{calls} calls of {C} chunks, {tot['frames']} frames, {tot['bases']} bases")
        return Window(dt, tot["reads"], tot["failed"] + self.missing,
                      {"frames_per_s": tot["frames"] / dt})

    def release(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        picks = sample(range(len(self.kept)), np.ones(len(self.kept)),
                       self.traffic["check_chunks"], self.seed)
        got = [self.kept[p][1] for p in picks]
        chunks = [self.kept[p][0] for p in picks]
        jobs = [(self.probs[j].cpu().numpy(), self.init[j].cpu().numpy(), self.decode)
                for j in chunks]
        t0 = time.perf_counter()
        want = run_reference(jobs)
        self.log(f"reference over {len(jobs)} chunks in {reference_workers(len(jobs))} "
                 f"processes: {time.perf_counter() - t0:.3f} s")
        return beam_checks(got, want, self.missing, self.log, [f"chunk {j}" for j in chunks])

    def close(self):
        pass
