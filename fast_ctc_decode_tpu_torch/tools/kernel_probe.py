"""Split the main path's kernels into stages and time each, then time both
designs of the version-2 beam kernel over batch sizes.

Port of ``tools/kernel_probe.py``, which splits ``beam_search_pallas_batch``
into its input transpose, the fused Pallas kernel and the traceback, then
sweeps the Pallas ``(block_b, block_t)`` tiling.  Here, on the same batch
(L2-normalised posteriors from seed 42, A+1 = 5, beam 5, cut 0.1, every
read T frames long):
  1. the stages of ``beam_cuda.beam_search_kernel_batch``: the beam kernel
     alone (``raw=True``), the traceback kernel alone on the materialised id
     log, and the whole (there is no transpose: the kernels read [B, T, A+1]);
  2. in place of the TPU's tiling sweep, which has no counterpart, both
     designs of the version-2 beam kernel (``design="thread"``: one thread
     per read; ``"warp"``: one warp per read) at B in ``SWEEP_B``, with the
     faster of the two at each B: the times that set
     ``beam_cuda.THREAD_MIN_B``;
  3. the warp design at 1, 2, 4 and 8 reads a block (B = 1024).
Each line gives the time (median of ``iters`` after one warm-up) and reads/s.

On a CUDA device the times are CUDA events.  ``device="cpu"`` runs the
wrappers' CPU path (the plain engine, which has neither design) by the host
clock: a check of the tool, not a measurement of the kernels.

Usage: ``python -m fast_ctc_decode_tpu_torch.tools.kernel_probe [B] [T] [iters] [--quick] [--device cpu]``
(B: the stage split's batch, default 32768; ``--quick``: B=8, T=50, a sweep
over B in (1, 8), one timed call per line).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops import beam_cuda
from .exact_probe import _host_ms
from .kernel_ablate import event_ms

SWEEP_B = (1, 256, 1024, 2048, 4096, 8192, 16384, 32768)
READS_PER_BLOCK = (1, 2, 4, 8)
RPB_B = 1024
BEAM, THR, A1 = 5, 0.1, 5


def make_batch(B: int, T: int, device):
    """The JAX probe's batch: seed 42, L2-normalised rows, full lengths."""
    rng = np.random.RandomState(42)
    probs = rng.rand(B, T, A1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    return torch.from_numpy(probs).to(device), lengths


def run(B: int, T: int, *, device=None, iters: int = 5, sweep_b=SWEEP_B, rpb_b=RPB_B):
    """Time the stages at B, both designs at each of ``sweep_b``, and the warp
    design at each reads-per-block at ``rpb_b``.  Returns ``[(line, row)]``,
    ``row`` a dict with ``what`` ("stage", "design", "reads_per_block"),
    ``B``, ``ms``, ``reads_per_s`` and the row's own keys."""
    dev = resolve_device(device)
    timer = event_ms if dev.type == "cuda" else _host_ms
    clock = "CUDA events" if dev.type == "cuda" else "host clock, plain engine on the CPU"
    out = []

    def emit(what, B, fn, label, **keys):
        ms = timer(fn, iters)
        row = dict(what=what, B=B, ms=ms, reads_per_s=B / (ms / 1e3), **keys)
        out.append((f"kernel probe {label} B={B} T={T}: {ms!r} ms "
                    f"({row['reads_per_s']:.1f} reads/s) [{clock}]", row))
        return ms

    probs, lengths = make_batch(B, T, dev)
    raw = beam_cuda.beam_search_kernel_batch(probs, lengths, THR, beam_size=BEAM, raw=True)
    ids_log, fin = raw["ids_log"], raw["fin"]
    design = beam_cuda.design_for(B)
    emit("stage", B, lambda: beam_cuda.beam_search_kernel_batch(
        probs, lengths, THR, beam_size=BEAM, raw=True), f"beam kernel ({design})",
        stage="beam", design=design)
    emit("stage", B, lambda: beam_cuda.traceback_kernel(fin, ids_log, T=T, K=BEAM, A=A1 - 1),
         "traceback kernel", stage="traceback")
    emit("stage", B, lambda: beam_cuda.beam_search_kernel_batch(
        probs, lengths, THR, beam_size=BEAM), "whole (beam + traceback)", stage="whole")
    del probs, lengths, raw, ids_log, fin

    for b in sweep_b:
        probs, lengths = make_batch(b, T, dev)
        ms = {
            d: emit("design", b, lambda d=d: beam_cuda.beam_ids_kernel(
                probs, lengths, THR, beam_size=BEAM, design=d), f"design {d}", design=d)
            for d in beam_cuda.DESIGNS
        }
        best = min(ms, key=ms.get)
        out.append((f"kernel probe B={b}: {best} is faster ({ms[best]!r} ms); "
                    f"the wrapper routes B={b} to {beam_cuda.design_for(b)} "
                    f"(THREAD_MIN_B = {beam_cuda.THREAD_MIN_B})",
                    dict(what="faster", B=b, design=best, routed=beam_cuda.design_for(b))))

    probs, lengths = make_batch(rpb_b, T, dev)
    for r in READS_PER_BLOCK:
        emit("reads_per_block", rpb_b, lambda r=r: beam_cuda.beam_ids_kernel(
            probs, lengths, THR, beam_size=BEAM, design="warp", reads_per_block=r),
            f"design warp, {r} reads a block", reads_per_block=r)
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
    B = int(argv[0]) if len(argv) > 0 else (8 if quick else 32768)
    T = int(argv[1]) if len(argv) > 1 else (50 if quick else 1000)
    iters = int(argv[2]) if len(argv) > 2 else (1 if quick else 5)
    dev = resolve_device(device)
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(0)}, B={B} T={T}, beam {BEAM}, cut {THR}", flush=True)
    kw = dict(sweep_b=(1, 8), rpb_b=8) if quick else {}
    rows = run(B, T, device=dev, iters=iters, **kw)
    for line, _ in rows:
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
