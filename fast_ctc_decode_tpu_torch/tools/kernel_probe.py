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
  2b. the same sweep at the shapes in ``WIDE_SHAPES``, which run the wide
     instance ``<16, 7>``: beam 16 at A+1 = 8 (its widest) and beam 8 at
     A+1 = 5 (its narrowest labels), each batch from seed 42 as above: the
     times behind ``beam_cuda.design_for``'s route of that instance, and
     whether the crossover depends on K and A inside it;
  3. the warp design at 1, 2, 4 and 8 reads a block (B = 1024);
  4. the traceback kernel's two routes (``route="sweep"``: the log streamed
     backward through shared memory; ``"walk"``: one gather a node) on the
     id log of the version-2 beam at B in ``TRACEBACK_B``, each checked
     equal to the other, with the faster of the two and the route the
     wrapper takes; then at each B of ``TRACEBACK_BLOCK_B`` the sweep over
     warps a block (32 reads each) and steps a tile, and the walk over warps:
     the times that set ``beam_cuda.TRACEBACK_WARPS`` / ``TRACEBACK_STEPS``.
Each line gives the time (median of ``iters`` after one warm-up) and reads/s;
the traceback's times are per call of ``TRACEBACK_CALLS`` calls back to back
between the two events, so that its ~0.1-0.4 ms on the card is not the
wrapper's host work between calls.

On a CUDA device the times are CUDA events.  ``device="cpu"`` runs the
wrappers' CPU path (the plain engine, which has neither design) by the host
clock: a check of the tool, not a measurement of the kernels.

Usage: ``python -m fast_ctc_decode_tpu_torch.tools.kernel_probe [B] [T] [iters] [--quick] [--device cpu]``
(B: the stage split's batch, default 32768; ``--quick``: B=8, T=50, sweeps
over B in (1, 8), the wide shapes included, the traceback's blocks at B=8
over two warps and two steps settings, one timed call per line).
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
TRACEBACK_B = (1, 256, 1024, 4096, 8192, 32768)
TRACEBACK_BLOCK_B = (256, 1024, 32768)
TRACEBACK_WARPS = (1, 2, 4, 8)
TRACEBACK_STEPS = (2, 4, 6, 8, 12, 16, 32)
TRACEBACK_CALLS = 10
BEAM, THR, A1 = 5, 0.1, 5
#: (beam, A+1) of the wide instance's design sweep: its widest shape, and a
#: narrower one inside it
WIDE_SHAPES = ((16, 8), (8, 5))


def make_batch(B: int, T: int, device, a1: int = A1):
    """The JAX probe's batch: seed 42, L2-normalised rows, full lengths.
    The first b reads of a batch equal the batch of b reads."""
    rng = np.random.RandomState(42)
    probs = rng.rand(B, T, a1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    return torch.from_numpy(probs).to(device), lengths


def run(B: int, T: int, *, device=None, iters: int = 5, sweep_b=SWEEP_B, rpb_b=RPB_B,
        tb_b=TRACEBACK_B, tb_block_b=TRACEBACK_BLOCK_B, tb_warps=TRACEBACK_WARPS,
        tb_steps=TRACEBACK_STEPS, wide_shapes=WIDE_SHAPES):
    """Time the stages at B, both designs at each of ``sweep_b`` (beam 5,
    then each (beam, A+1) of ``wide_shapes``), the warp design at each
    reads-per-block at ``rpb_b``, both traceback routes at each of ``tb_b``
    and the traceback's blocks (``tb_warps`` x ``tb_steps``) at each of
    ``tb_block_b``.  Returns ``[(line, row)]``, ``row`` a dict with ``what``
    ("stage", "design", "faster", "reads_per_block", "traceback",
    "traceback_faster", "traceback_block"), ``B``, ``ms``, ``reads_per_s``
    and the row's own keys; "design" and "faster" rows carry ``beam`` and
    ``A1``."""
    dev = resolve_device(device)
    timer = event_ms if dev.type == "cuda" else _host_ms
    clock = "CUDA events" if dev.type == "cuda" else "host clock, plain engine on the CPU"
    out = []

    def emit(what, B, fn, label, **keys):
        if what.startswith("traceback") and dev.type == "cuda":
            ms = event_ms(lambda: [fn() for _ in range(TRACEBACK_CALLS)], iters) / TRACEBACK_CALLS
        else:
            ms = timer(fn, iters)
        row = dict(what=what, B=B, ms=ms, reads_per_s=B / (ms / 1e3), **keys)
        out.append((f"kernel probe {label} B={B} T={T}: {ms!r} ms "
                    f"({row['reads_per_s']:.1f} reads/s) [{clock}]", row))
        return ms

    probs, lengths = make_batch(B, T, dev)
    raw = beam_cuda.beam_search_kernel_batch(probs, lengths, THR, beam_size=BEAM, raw=True)
    ids_log, fin = raw["ids_log"], raw["fin"]
    design = beam_cuda.design_for(B, BEAM, A1 - 1)
    emit("stage", B, lambda: beam_cuda.beam_search_kernel_batch(
        probs, lengths, THR, beam_size=BEAM, raw=True), f"beam kernel ({design})",
        stage="beam", design=design)
    emit("stage", B, lambda: beam_cuda.traceback_kernel(fin, ids_log, T=T, K=BEAM, A=A1 - 1),
         "traceback kernel", stage="traceback")
    emit("stage", B, lambda: beam_cuda.beam_search_kernel_batch(
        probs, lengths, THR, beam_size=BEAM), "whole (beam + traceback)", stage="whole")
    del probs, lengths, raw, ids_log, fin

    for K, a1 in ((BEAM, A1), *wide_shapes):
        inst = beam_cuda.instance(K, a1 - 1)
        shape = "" if (K, a1) == (BEAM, A1) else f"beam {K} A+1={a1} <{inst[0]}, {inst[1]}> "
        probs_all, lengths_all = make_batch(max(sweep_b), T, dev, a1)
        for b in sweep_b:
            probs, lengths = probs_all[:b], lengths_all[:b]
            ms = {
                d: emit("design", b, lambda d=d: beam_cuda.beam_ids_kernel(
                    probs, lengths, THR, beam_size=K, design=d), f"{shape}design {d}",
                    design=d, beam=K, A1=a1)
                for d in beam_cuda.DESIGNS
            }
            best = min(ms, key=ms.get)
            routed = beam_cuda.design_for(b, K, a1 - 1)
            out.append((f"kernel probe {shape}B={b}: {best} is faster ({ms[best]!r} ms); "
                        f"the wrapper routes B={b} to {routed} "
                        f"(THREAD_MIN_B = {beam_cuda.THREAD_MIN_B} at <5, 4>)",
                        dict(what="faster", B=b, design=best, routed=routed, beam=K, A1=a1)))
        del probs_all, lengths_all, probs, lengths

    probs, lengths = make_batch(rpb_b, T, dev)
    for r in READS_PER_BLOCK:
        emit("reads_per_block", rpb_b, lambda r=r: beam_cuda.beam_ids_kernel(
            probs, lengths, THR, beam_size=BEAM, design="warp", reads_per_block=r),
            f"design warp, {r} reads a block", reads_per_block=r)
    del probs, lengths

    K, A = BEAM, A1 - 1
    for b in tb_b:
        fin, ids_log = _id_log(b, T, dev)
        tb = lambda route, **kw: beam_cuda.traceback_kernel(fin, ids_log, T=T, K=K, A=A,
                                                             route=route, **kw)
        if not all(torch.equal(x, y) for x, y in zip(tb("sweep"), tb("walk"))):
            raise AssertionError(f"traceback routes differ at B={b}")
        ms = {route: emit("traceback", b, lambda route=route: tb(route), f"traceback {route}",
                          route=route) for route in beam_cuda.TRACEBACK_ROUTES}
        best = min(ms, key=ms.get)
        routed = beam_cuda.traceback_route(T, K)[0]
        out.append((f"kernel probe traceback B={b}: {best} is faster ({ms[best]!r} ms); the "
                    f"wrapper routes it to {routed}",
                    dict(what="traceback_faster", B=b, route=best, routed=routed)))
        if b in tb_block_b:
            for w in tb_warps:
                # the steps a tile that fit the block, each once
                for st in sorted({beam_cuda.traceback_route(T, K, warps=w, steps=st)[1]
                                  for st in tb_steps}):
                    emit("traceback_block", b, lambda w=w, st=st: tb("sweep", warps=w, steps=st),
                         f"traceback sweep, {w} warps a block, {st} steps a tile",
                         route="sweep", warps=w, steps=st)
                emit("traceback_block", b, lambda w=w: tb("walk", warps=w),
                     f"traceback walk, {w} warps a block", route="walk", warps=w, steps=0)
        del fin, ids_log
    return out


def _id_log(B: int, T: int, device):
    """(fin, ids_log) of the version-2 beam on the probe's batch of B reads."""
    probs, lengths = make_batch(B, T, device)
    raw = beam_cuda.beam_search_kernel_batch(probs, lengths, THR, beam_size=BEAM, raw=True)
    return raw["fin"], raw["ids_log"]


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
    kw = dict(sweep_b=(1, 8), rpb_b=8, tb_b=(1, 8), tb_block_b=(8,), tb_warps=(1, 4),
              tb_steps=(4, 32)) if quick else {}
    rows = run(B, T, device=dev, iters=iters, **kw)
    for line, _ in rows:
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
