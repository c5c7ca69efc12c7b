"""Profiling helpers: wall-clock reads/s counters and torch.profiler traces.

The reference has no observability at all; this is the framework-native
replacement: per-stage timers and a trace context usable around any decode
call.  The pipeline records the stages ``beam.device``, ``beam.detok``,
``decode_many.pad`` and ``decode_many.checkpoint`` (the same names as
``fast_ctc_decode_tpu.utils.profiling``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


@dataclass
class Counters:
    reads: int = 0
    frames: int = 0
    seconds: float = 0.0
    stages: Dict[str, float] = field(default_factory=dict)

    @property
    def reads_per_sec(self) -> float:
        return self.reads / self.seconds if self.seconds else 0.0

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def timed(counters: Counters, stage: str, reads: int = 0, frames: int = 0):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        counters.seconds += dt
        counters.reads += reads
        counters.frames += frames
        counters.stages[stage] = counters.stages.get(stage, 0.0) + dt


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler trace context (no-op when logdir is None).

    Records CPU activity, plus CUDA activity when a card is present, and
    writes ``trace.json`` (Chrome trace format) into ``logdir``.
    """
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def block(tree):
    """Wait for the device work behind a tree of tensors (for honest timing).

    Synchronises every CUDA device that holds a tensor of the tree; CPU
    tensors are computed eagerly and need no wait.
    """
    devices = {
        leaf.device
        for leaf in _leaves(tree)
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda
    }
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


# ------------------------------------------------------- pipeline metrics

log = logging.getLogger("fast_ctc_decode_tpu_torch")

#: process-wide per-stage metrics, populated by the batch pipeline:
#: stage -> seconds, plus read/error counters.  Reset with reset_metrics().
METRICS = Counters()


def reset_metrics() -> Counters:
    """Reset and return the process-wide pipeline metrics object."""
    global METRICS
    METRICS = Counters()
    return METRICS


@contextlib.contextmanager
def stage(name: str, reads: int = 0, frames: int = 0):
    """Record a pipeline stage into the process-wide METRICS and emit a
    DEBUG log line with the stage wall time."""
    t0 = time.perf_counter()
    with timed(METRICS, name, reads=reads, frames=frames):
        yield
    log.debug(
        "stage %s: %.3fs (reads=%d)", name, time.perf_counter() - t0, reads
    )
