"""Profiling helpers: per-stage timers, counters and torch.profiler traces.

The reference has no observability at all; this is the framework-native
replacement: one span mechanism, ``stage(name)``, one counter mechanism,
``count(name, n)``, and a trace context usable around any decode call.  A
stage adds its wall seconds to ``METRICS.stages`` and, while a profiler
records, marks the same interval as a ``record_function`` range: on the
clock the profiler gives the card's kernels and copies, nested as the
stages nest.

The pipeline (``parallel/pipeline.py``) names its stages by path (``beam``,
``crf``, ``duplex``, ``crf_duplex``):

- ``decode_many``, ``decode_many_crf``, ``decode_many_duplex``,
  ``decode_many_crf_duplex``: the whole call, with ``<call>.bucket`` (reads grouped by length), ``<call>.pad``
  and ``<call>.checkpoint`` inside it;
- ``<path>.device``: a batch's device decode, and inside it
  ``<path>.upload`` (the copies to the card), ``<path>.launch`` (the kernel
  wrappers' host side: checks, allocations, enqueue; the concatenation of
  duplex chunks), ``<path>.wait`` (the kernels' remaining time: a stream
  sync on a CUDA device, empty elsewhere) and ``<path>.fetch`` (the copies
  home); the duplex paths add
  ``<path>.prep`` (``prep_duplex_batch``) and, on the tree engine,
  ``<path>.size`` (the launch sizing);
- ``<path>.detok``: host assembly of the results.

``beam.device``, ``beam.detok``, ``decode_many.pad`` and
``decode_many.checkpoint`` are the JAX package's names too.

A counter adds a whole number to ``METRICS.counts`` under its name.
``decode_many_crf`` counts ``decode_many_crf.frames`` (the real frames of
the reads it decodes; padding and reads resumed from a checkpoint are not
counted), ``decode_many_crf.moved_bytes`` (the posterior and init-state
bytes its pad stage writes into batch buffers, on the decode device or on
the host; the zeros of padding are not counted, and a batch decoded in
place adds only its stacked init states, or 0) and
``decode_many_crf.in_place_frames`` (the real frames of batches decoded in
place, from the caller's tensor: counted only where that happens).
``decode_many_crf_duplex`` counts ``decode_many_crf_duplex.frames`` (the
real frames of both reads of the pairs it decodes) and
``decode_many_crf_duplex.batch_frames`` (the frames of both reads in the
batches it hands the decoder, bucket padding included), on every path.
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
    stages: Dict[str, float] = field(default_factory=dict)  # stage -> seconds
    counts: Dict[str, int] = field(default_factory=dict)  # counter -> total


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

#: process-wide per-stage seconds and counters, populated by the batch
#: pipeline.  Reset with reset_metrics().
METRICS = Counters()


def reset_metrics() -> Counters:
    """Reset and return the process-wide pipeline metrics object."""
    global METRICS
    METRICS = Counters()
    return METRICS


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage: its wall seconds add into ``METRICS.stages``
    under ``name``.  While a torch.profiler records, the stage is also a
    ``record_function`` range of that name; otherwise no range is opened
    (entering one costs ~10 us even with no profiler, the check ~0.2 us).
    Also a decorator: ``@stage("decode_many")``."""
    counters = METRICS
    span = (torch.profiler.record_function(name) if torch.autograd._profiler_enabled()
            else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with span:
            yield
    finally:
        counters.stages[name] = counters.stages.get(name, 0.0) + time.perf_counter() - t0


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of ``METRICS.counts``."""
    counts = METRICS.counts
    counts[name] = counts.get(name, 0) + int(n)
