"""The traced run: torch.profiler over the measured window, read in memory.

The profile records the host's operators and the benchmark's own spans
(``record_function``: ``ctcbench.window`` around the window, and
``ctcbench.pool``, ``ctcbench.call``, ``ctcbench.results`` around the work
of each call) and the card's activity (kernels, copies, fills).  No trace
file is written.  From it:

- ``window_s``: the length of ``ctcbench.window``;
- ``busy_s``: the union of the card's activity inside the window;
- ``kernel_s``: the summed time of every kernel inside the window (all
  kernels, by no name, so a fused, split or renamed kernel keeps the same
  yardstick);
- ``device_ops``: the ten device operations that took most time, by name;
- ``idle_gaps``: the card's idle time inside the window, by what the host
  was doing then (the innermost host span or operator over the middle of
  each gap), the ten largest.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

WINDOW = "ctcbench.window"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    kinds: dict = field(default_factory=dict)  # events seen, by (device, activity)


def _ns(ev, what):
    """Start or duration of a kineto event in ns, across torch versions."""
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(1e3 * getattr(ev, f"{what}_us")())


def _kind(ev) -> str:
    """``kernel``, ``memcpy`` or ``memset`` for the card's own work; None for
    anything else, such as the card's copy of a host span."""
    if "CPU" in str(ev.device_type()):
        return None
    flag = getattr(ev, "is_user_annotation", None)
    name = ev.name()
    if (flag is not None and flag()) or name.startswith("ctcbench."):
        return None
    low = name.lower()
    for kind in ("memcpy", "memset"):
        if low.startswith(kind):
            return kind
    return "kernel"


class Tracer:
    """Profiles the window when ``on``; ``span(name)`` marks a piece of the
    benchmark's host work in the profile (a no-op when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.summary = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
        self.prof = prof

    def summarise(self) -> TraceSummary:
        self.summary = summarise(self.prof.profiler.kineto_results.events())
        self.prof = None
        return self.summary


def summarise(events) -> TraceSummary:
    """Read the window, the card's busy time and kernels, and the idle gaps
    from a profile's kineto events."""
    host, dev, kinds = [], [], {}
    w0 = w1 = None
    for ev in events:
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        name = ev.name()
        kind = _kind(ev)
        key = f"{ev.device_type()}/{kind}"
        kinds[key] = kinds.get(key, 0) + 1
        if kind is not None:
            dev.append((start, start + dur, name, kind))
        elif "CPU" in str(ev.device_type()):
            if name == WINDOW:
                w0, w1 = start, start + dur
            host.append((start, start + dur, name))
    if w0 is None:
        raise RuntimeError("the profile holds no measured window")
    # times relative to the window's start, exact in float64
    host = [(a - w0, b - w0, n) for a, b, n in host]
    dev = [(a - w0, b - w0, n, k) for a, b, n, k in dev]
    w0, w1 = 0, w1 - w0

    clipped = sorted((max(a, w0), min(b, w1), n, k) for a, b, n, k in dev if b > w0 and a < w1)
    by_name = {}
    kernel_ns = 0.0
    for a, b, n, k in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
        if k == "kernel":
            kernel_ns += b - a
    merged = []
    for a, b, _, _ in clipped:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_ns = sum(b - a for a, b in merged)

    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle = {}
    names = [n for _, _, n in host]
    hs = np.array([h[0] for h in host] + [0.0])
    he = np.array([h[1] for h in host] + [0.0])
    hl = np.where(np.array(names + [WINDOW]) == WINDOW, np.inf, he - hs)
    for i in range(0, len(gaps), 256):
        g = np.array(gaps[i:i + 256])
        mid = 0.5 * (g[:, 0] + g[:, 1])[:, None]
        inner = np.where((hs <= mid) & (mid <= he), hl, np.inf).argmin(1)
        for (a, b), j, m in zip(g, inner, mid[:, 0]):
            over = j < len(names) and hs[j] <= m <= he[j] and names[j] != WINDOW
            name = names[j] if over else "host, no span"
            idle[name] = idle.get(name, 0.0) + (b - a)

    def top(d):
        return [[n, v / 1e9] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return TraceSummary(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, kernel_s=kernel_ns / 1e9,
        device_ops=top(by_name), idle_gaps=top(idle), kinds=kinds,
    )
