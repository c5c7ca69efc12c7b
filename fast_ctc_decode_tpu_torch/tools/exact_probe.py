"""Probe the exact 1D beam kernel: does the step cost grow with ``max_nodes``,
and how many reads a block fill the card best?

Port of ``tools/exact_probe.py``, which times the JAX package's XLA tree
engine at ``max_nodes`` 20008 / 8192 / 2048 / 512.  Here the same batch
(L2-normalised posteriors from seed 42, A+1 = 5, beam 5, cut 0.1, every
read T frames long) goes through ``beam_exact_cuda.beam_search_exact_kernel_batch``
at those budgets, with the default four reads a block, and then through a
sweep of reads per block (1, 2, 4, 8) at the worst-case budget.  Each line
gives the time (median of ``iters`` after one warm-up), reads/s and the
largest status code (4 = NODE_OVERFLOW: the budget was too small).

The tree lives in uninitialised scratch with validated lookups, so the
budget should change only the memory a call allocates, not the time of a
step.

On a CUDA device the times are CUDA events.  ``device="cpu"`` runs the plain
engine (the wrapper's CPU path, which takes no reads-per-block) by the host
clock: a check of the tool, not a measurement of the kernel.

Usage: ``python -m fast_ctc_decode_tpu_torch.tools.exact_probe [B] [T] [--quick] [--device cpu]``
(``--quick``: B=8, T=50, one timed call per line).
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import beam_exact_cuda
from .kernel_ablate import event_ms

BUDGETS = (20008, 8192, 2048, 512)
READS_PER_BLOCK = (1, 2, 4, 8)
BEAM, THR, A1 = 5, 0.1, 5


def make_batch(B: int, T: int, device):
    """The JAX probe's batch: seed 42, L2-normalised rows, full lengths."""
    rng = np.random.RandomState(42)
    probs = rng.rand(B, T, A1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    return torch.from_numpy(probs).to(device), lengths


def _host_ms(fn, iters):
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(B: int, T: int, *, device=None, iters: int = 5):
    """Time the kernel at each budget, then at each reads-per-block.
    Returns ``[(line, row)]`` with ``row`` = dict(max_nodes, reads_per_block,
    ms, reads_per_s, max_err)."""
    dev = resolve_device(device)
    probs, lengths = make_batch(B, T, dev)
    worst = beam_exact_cuda.beam_ops.default_max_nodes(T, BEAM, A1 - 1)
    timer = event_ms if dev.type == "cuda" else _host_ms
    clock = "CUDA events" if dev.type == "cuda" else "host clock, plain engine on the CPU"
    configs = [(N, beam_exact_cuda.READS_PER_BLOCK) for N in BUDGETS]
    configs += [(worst, r) for r in READS_PER_BLOCK]
    out = []
    for N, rpb in configs:
        def call(N=N, rpb=rpb):
            return beam_exact_cuda.beam_search_exact_kernel_batch(
                probs, lengths, THR, beam_size=BEAM, max_nodes=N, reads_per_block=rpb)

        ms = timer(call, iters)
        max_err = int(call()["err"].max())
        row = dict(max_nodes=N, reads_per_block=rpb, ms=ms, reads_per_s=B / (ms / 1e3),
                   max_err=max_err)
        line = (f"exact probe B={B} T={T} max_nodes={N} reads/block={rpb}: {ms!r} ms "
                f"({row['reads_per_s']:.1f} reads/s), largest status {max_err} [{clock}]")
        out.append((line, row))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    quick = "--quick" in argv
    argv = [a for a in argv if a != "--quick"]
    B = int(argv[0]) if len(argv) > 0 else (8 if quick else 1024)
    T = int(argv[1]) if len(argv) > 1 else (50 if quick else 1000)
    dev = resolve_device(device)
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(0)}, B={B} T={T}, beam {BEAM}, cut {THR}", flush=True)
    rows = run(B, T, device=dev, iters=1 if quick else 5)
    for line, _ in rows:
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
