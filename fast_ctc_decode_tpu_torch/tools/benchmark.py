"""Benchmark suite of the port: the counterpart of ``tests/benchmark.py``.

It times each decoder entry point on the README workload (L2-normalised
random posteriors, alphabet NACGT, beam 5, cut 0.1), with the reference
benchmark's pure-Python viterbi (argmax + groupby) for scale: sec/read of
one read through the single-read API, and reads/s (pairs/s) of batches, the
engines' native unit.  The rows and their order are the JAX script's.

Modes:
  default: sec/read of the python viterbi, ``api.viterbi_search`` and
           ``api.beam_search`` (exact and fast) on one T=1000 read from seed
           42 (or the first read of ``reads.npy``), then the batched 1D beam
           at B=4096 through ``fast`` (the plain engine) and, on the card,
           ``cuda`` (B=4096 is below ``beam_cuda.THREAD_MIN_B``: the warp
           design; the row names the design it ran) and the exact kernel at
           B=256;
  --full:  adds the CRF beam (B=512, T=400, S=64): ``fast``, and on the card
           ``cuda`` and the exact kernel (B=64); then the banded duplex
           (B=256, T1=T2=500, ``diag_env(500, 500, 40)``): the plain slot
           engine ``ops/duplex_fast.duplex_fast_batch`` (the counterpart of
           the JAX script's XLA ``fast``), the exact single pair
           (``api.beam_search_duplex(engine="exact")``), the plain exact
           engine ``ops/duplex.duplex_exact_batch`` batched at 32, and on the
           card the slot kernel, the tree kernel and the CRF tree kernel
           (S=16);
  --quick: the JAX script's small shapes (one read of T=25, B=64; CRF B=32,
           T=50, S=8; duplex B=16, T=60, half-width 8) and 3 iterations.

Kernel rows run only on a CUDA device: on the CPU the wrappers would run
their plain versions under a kernel's name.  On the card each time is a wall
between two ``torch.cuda.synchronize()`` (batches: ``iters`` calls back to
back after a warm-up; inputs placed on the card once, before timing); on the
CPU (``--device cpu``) the tool checks itself by the host clock and measures
nothing.  Without a card and without ``--device`` it raises.

Run: python -m fast_ctc_decode_tpu_torch.tools.benchmark [--quick] [--full]
     [--device cpu] [reads.npy]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from .workloads import card_info, crf_root_gaps, diag_env, mean_s, norm_batch, pop_device

#: tree budget of the exact 1D kernel rows: the JAX script's
#: ``beam_exact_pallas.DEFAULT_KERNEL_NODES`` (~1.7x the ~7k nodes a T=1000
#: read allocates)
EXACT_KERNEL_NODES = 12288
TREE_KERNEL_MAX_NODES = 4096  # the tree duplex kernel's budget cap (the JAX script's)


def python_viterbi(probs, alphabet="NACGT"):
    """The reference benchmark's python decoder (benchmark.py:8-13)."""
    from itertools import groupby

    path = np.argmax(probs, axis=1)
    return "".join(alphabet[b] for b, g in groupby(path) if b)


def main(argv=None):
    """Print the rows; returns ``[(name, value, unit, kernel)]`` in print
    order (``kernel``: the row times a CUDA kernel and runs only on the
    card)."""
    device, argv = pop_device(sys.argv[1:] if argv is None else argv)
    quick, full = "--quick" in argv, "--full" in argv
    paths = [a for a in argv if not a.startswith("-")]
    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    from .. import api
    from ..ops import beam_cuda, beam_exact_cuda, beam_fast, duplex, duplex_cuda
    from ..ops import duplex_exact_cuda, duplex_fast

    if paths:
        x = np.load(paths[0]).astype(np.float32)
    else:
        rng = np.random.RandomState(42)
        x = rng.rand(25 if quick else 1000, 5).astype(np.float32)
        x /= np.linalg.norm(x, ord=2, axis=1, keepdims=True)
    T, A1 = x.shape
    iters = 3 if quick else 10
    name, power = card_info(dev)
    print(f"device: {dev} ({name}{', ' + power if power else ''}), read shape: {x.shape}"
          f"{'' if on_card else ' [host clock: a check of the tool, not a measurement]'}",
          flush=True)
    to = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    rows = []

    def row(label, value, unit, kernel=False):
        rows.append((label, value, unit, kernel))
        return value

    def rate(label, n, fn, n_iters, unit, kernel=False):
        dt = mean_s(fn, n_iters, dev)
        print(f"{label}: {row(label, n / dt, unit, kernel):>12,.1f} {unit}", flush=True)

    single = (
        ("viterbi python argmax+groupby", lambda: python_viterbi(x)),
        ("viterbi_search (this repo)", lambda: api.viterbi_search(x, "NACGT", device=dev)),
        ("beam_search single read (exact engine)",
         lambda: api.beam_search(x, "NACGT", 5, 0.1, device=dev)),
        ("beam_search single read (fast engine)",
         lambda: api.beam_search(x, "NACGT", 5, 0.1, engine="fast", device=dev)),
    )
    print(f"{'decoder':46s} {'sec/read':>12s}")
    for label, fn in single:
        print(f"{label:46s} {row(label, mean_s(fn, iters, dev), 'sec/read'):12.6f}", flush=True)

    # ---- batched 1D beam: the engine's native operating point ----
    B = 64 if quick else 4096
    xs_d = to(norm_batch(B, T, A1, 7))
    ln_d = to(np.full((B,), T, np.int32))
    thr = np.float32(0.1)
    print()
    rate(f"1D beam fast x{B}", B,
         lambda: beam_fast.beam_search_fast_batch(xs_d, ln_d, thr, beam_size=5), iters, "reads/s")
    if on_card:
        rate(f"1D beam cuda ({beam_cuda.design_for(B)} design) x{B}", B,
             lambda: beam_cuda.beam_search_kernel_batch(xs_d, ln_d, thr, beam_size=5),
             iters, "reads/s", kernel=True)
        Bx = min(B, 256)
        xs_x, ln_x = xs_d[:Bx].contiguous(), ln_d[:Bx].contiguous()
        rate(f"1D beam exact kernel x{Bx}", Bx,
             lambda: beam_exact_cuda.beam_search_exact_kernel_batch(
                 xs_x, ln_x, thr, beam_size=5, max_nodes=EXACT_KERNEL_NODES),
             max(iters // 2, 1), "reads/s", kernel=True)

    if not full:
        return rows

    # ---- CRF beam ----
    Bc, Tc, S = (32, 50, 8) if quick else (512, 400, 64)
    rng = np.random.RandomState(3)
    cp = rng.rand(Bc, Tc, S, A1).astype(np.float32)
    cp /= cp.sum(-1, keepdims=True)
    ci = rng.rand(Bc, S).astype(np.float32)
    cpd, cid, cld = to(cp), to(ci), to(np.full((Bc,), Tc, np.int32))
    zero = np.float32(0.0)
    rate(f"CRF beam fast x{Bc} (S={S})", Bc,
         lambda: beam_fast.crf_beam_search_fast_batch(cpd, cid, cld, zero, beam_size=5),
         iters, "reads/s")
    if on_card:
        rate(f"CRF beam cuda x{Bc} (S={S})", Bc,
             lambda: beam_cuda.crf_beam_search_kernel_batch(cpd, cid, cld, zero, beam_size=5),
             iters, "reads/s", kernel=True)
        Bxc = min(Bc, 64)
        cpx, cix, clx = (v[:Bxc].contiguous() for v in (cpd, cid, cld))
        rate(f"CRF beam exact kernel x{Bxc} (S={S})", Bxc,
             lambda: beam_exact_cuda.crf_beam_search_exact_kernel_batch(
                 cpx, cix, clx, zero, beam_size=5, max_nodes=EXACT_KERNEL_NODES),
             max(iters // 2, 1), "reads/s", kernel=True)

    # ---- banded duplex ----
    Bd, T1 = (16, 60) if quick else (256, 500)
    T2 = T1
    env = diag_env(T1, T2, 8 if quick else 40)
    ep = duplex_fast._prep_envelope_fast(env, T2)
    n1 = norm_batch(Bd, T1, A1, 11)
    n2 = norm_batch(Bd, T2, A1, 12)
    with np.errstate(divide="ignore"):
        l1 = np.log(n1).astype(np.float32)
        l2 = np.log(n2).astype(np.float32)
    rg = np.zeros((Bd, ep.Wr), np.float32)
    rg[:, 1:] = np.cumsum(l2[:, : ep.Wr - 1, 0], axis=1)
    a1d, a2d, rgd = to(l1), to(l2), to(rg)
    lod, hid = to(np.tile(ep.lo, (Bd, 1))), to(np.tile(ep.hi, (Bd, 1)))
    std = to(np.zeros(Bd, np.int32))
    lnd = to(np.full(Bd, T1, np.int32))
    ninf = np.float32(-np.inf)
    n_dup = max(iters // 2, 2)

    rate(f"duplex banded fast(plain) x{Bd} (W={ep.W})", Bd,
         lambda: duplex_fast.duplex_fast_batch(
             a1d, a2d, rgd, lod, hid, ninf, std, lnd, beam_size=5, collapse_repeats=True,
             needs_ext=ep.needs_ext, crf=False),
         n_dup, "pairs/s")
    if on_card:
        rate(f"duplex banded slot kernel x{Bd} (W={ep.W})", Bd,
             lambda: duplex_cuda.duplex_kernel_batch(
                 a1d, a2d, rgd, lod, hid, ninf, lnd, beam_size=5, collapse_repeats=True,
                 needs_ext=ep.needs_ext),
             n_dup, "pairs/s", kernel=True)

    # exact tree engine: single pair + small batch
    label = "duplex banded exact single pair"
    dt = mean_s(lambda: api.beam_search_duplex(
        n1[0], n2[0], "NACGT", envelope=env, engine="exact", device=dev), max(iters // 3, 2), dev)
    print(f"{label}: {row(label, dt, 's/pair'):.3f} s/pair", flush=True)
    Be = min(Bd, 32)
    # the port's _prep_envelope gives (lo, hi, W, Wr, needs_ext); the JAX one
    # also gives the slot engine's Wext, which the tree engine does not take
    lo_, hi_, We, _, ne = duplex._prep_envelope(env, T2)
    N = duplex._duplex_max_nodes(T1, 5, A1 - 1, We)
    lob, hib = to(np.tile(lo_, (Be, 1))), to(np.tile(hi_, (Be, 1)))
    a1e, a2e, rge = (v[:Be].contiguous() for v in (a1d, a2d, rgd))
    rate(f"duplex banded exact batched x{Be}", Be,
         lambda: duplex.duplex_exact_batch(
             a1e, a2e, rge, lob, hib, ninf, std[:Be].contiguous(), lnd[:Be].contiguous(),
             beam_size=5, collapse_repeats=True, max_nodes=N, W=We, needs_ext=ne, crf=False),
         2, "pairs/s")

    if on_card:
        # the tree kernel: the reference's band reuse at throughput
        lobx, hibx = to(np.tile(lo_, (Bd, 1))), to(np.tile(hi_, (Bd, 1)))
        nx = min(N, TREE_KERNEL_MAX_NODES)
        rate(f"duplex banded exact kernel x{Bd}", Bd,
             lambda: duplex_exact_cuda.duplex_exact_kernel_batch(
                 a1d, a2d, rgd, lobx, hibx, ninf, std, lnd, beam_size=5,
                 collapse_repeats=True, max_nodes=nx, W=We, needs_ext=ne, crf=False),
             2, "pairs/s", kernel=True)
        # the CRF duplex inputs draw on after the CRF beam's, as in the JAX script
        Sx = 16
        c1 = rng.rand(Bd, T1, Sx, A1).astype(np.float32)
        c1 /= c1.sum(-1, keepdims=True)
        c2 = rng.rand(Bd, T2, Sx, A1).astype(np.float32)
        c2 /= c2.sum(-1, keepdims=True)
        with np.errstate(divide="ignore"):
            cl1 = np.log(c1).astype(np.float32)
            cl2 = np.log(c2).astype(np.float32)
        crg = crf_root_gaps(cl2, ep.Wr, Sx, A1)
        cl1d, cl2d, crgd = to(cl1), to(cl2), to(crg)
        rate(f"CRF duplex exact kernel x{Bd} (S={Sx})", Bd,
             lambda: duplex_exact_cuda.duplex_exact_kernel_batch(
                 cl1d, cl2d, crgd, lobx, hibx, ninf, std, lnd, beam_size=5,
                 collapse_repeats=False, max_nodes=nx, W=We, needs_ext=ne, crf=True),
             2, "pairs/s", kernel=True)
    return rows


if __name__ == "__main__":
    main()
