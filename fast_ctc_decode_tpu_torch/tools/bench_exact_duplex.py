"""Micro-bench of the tree duplex kernel alone: the counterpart of
``tools/bench_exact_duplex.py``.

It times ``ops/duplex_exact_cuda.duplex_exact_kernel_batch`` (the kernel of
``csrc/duplex_exact_kernel.cu``) on the JAX tool's workload: B pairs (argv,
256 by default) of T1 = T2 = 500 frames, rows from ``RandomState(11)``
L2-normalised, the diagonal envelope ``diag_env(500, 500, 40)``, beam 5, no
cut, a tree budget of ``min(_duplex_max_nodes(T1, 5, 4, W), 4096)`` nodes;
``--crf`` decodes CRF posteriors of S = 16 states instead, with the
uncapped budget ``_duplex_max_nodes(T1, 5, 4, W)``.  Every status must be
OK.

The JAX tool caps the CRF budget at 4096 too, and fails its own check
there: on its CRF pairs the JAX package's exact engine reports
NODE_OVERFLOW at 4096 nodes (at T=500 a pair needs more), so its ``--crf``
run would time pairs cut short.  The cap was sized for the TPU kernel's
on-chip node tables; the port's tree kernel keeps its trees in global
scratch memory, and its CRF run takes the default budget of the port's
decoders.

It prints pairs/s and ms a batch: the mean of three calls back to back
between two ``torch.cuda.synchronize()``, after a warm-up.

Runs on the card; ``--device cpu`` runs the kernel's plain version on the
CPU as a check of the tool (host clock, not a measurement).  Without a card
and without ``--device`` it raises.

Run: python -m fast_ctc_decode_tpu_torch.tools.bench_exact_duplex [B] [--crf] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops import duplex, duplex_exact_cuda
from .workloads import crf_root_gaps, diag_env, mean_s, pop_device

A1 = 5
BEAM = 5
S = 16
ITERS = 3
MAX_NODES_CAP = 4096  # the JAX tool's budget cap; the plain run keeps it


def make_inputs(B, crf=False, *, T=500, w=40, seed=11):
    """The JAX tool's inputs (T1 = T2 = ``T``, ``diag_env(T, T, w)``): a dict
    of host arrays (l1, l2 log posteriors; root_gap; lo, hi [B, T1] int32;
    init_states, lengths [B] int32) and the ints W, N and the bool
    needs_ext."""
    T1 = T2 = T
    rng = np.random.RandomState(seed)
    env = diag_env(T1, T2, w)
    # the port's _prep_envelope gives (lo, hi, W, Wr, needs_ext); the JAX one
    # also gives the slot engine's Wext, which the tree kernel does not take
    lo_, hi_, We, Wre, ne = duplex._prep_envelope(env, T2)
    N = duplex._duplex_max_nodes(T1, BEAM, A1 - 1, We)
    N = N if crf else min(N, MAX_NODES_CAP)
    if crf:
        x1 = rng.rand(B, T1, S, A1).astype(np.float32)
        x2 = rng.rand(B, T2, S, A1).astype(np.float32)
    else:
        x1 = rng.rand(B, T1, A1).astype(np.float32)
        x2 = rng.rand(B, T2, A1).astype(np.float32)
    x1 /= np.linalg.norm(x1, ord=2, axis=-1, keepdims=True)
    x2 /= np.linalg.norm(x2, ord=2, axis=-1, keepdims=True)
    with np.errstate(divide="ignore"):
        l1 = np.log(x1).astype(np.float32)
        l2 = np.log(x2).astype(np.float32)
    if crf:
        rg = crf_root_gaps(l2, Wre, S, A1)
    else:
        rg = np.zeros((B, Wre), np.float32)
        rg[:, 1:] = np.cumsum(l2[:, : Wre - 1, 0], axis=1)
    return {
        "l1": l1, "l2": l2, "root_gap": rg,
        "lo": np.tile(lo_, (B, 1)).astype(np.int32),
        "hi": np.tile(hi_, (B, 1)).astype(np.int32),
        "init_states": np.zeros(B, np.int32), "lengths": np.full(B, T1, np.int32),
        "W": int(We), "N": int(N), "needs_ext": bool(ne),
    }


def decode(inp, device, crf=False):
    """The tree kernel's wrapper on ``inp`` (from ``make_inputs``) placed on
    ``device``: returns a no-argument callable that launches it once."""
    t = {k: torch.from_numpy(inp[k]).to(device)
         for k in ("l1", "l2", "root_gap", "lo", "hi", "init_states", "lengths")}
    return lambda: duplex_exact_cuda.duplex_exact_kernel_batch(
        t["l1"], t["l2"], t["root_gap"], t["lo"], t["hi"], np.float32(-np.inf),
        t["init_states"], t["lengths"], beam_size=BEAM, collapse_repeats=not crf,
        max_nodes=inp["N"], W=inp["W"], needs_ext=inp["needs_ext"], crf=crf,
    )


def main(argv=None):
    """Print the line; returns (pairs/s, ms a batch)."""
    device, argv = pop_device(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    args = [a for a in argv if not a.startswith("--")]
    B = int(args[0]) if args else 256
    crf = "--crf" in argv

    inp = make_inputs(B, crf)
    fn = decode(inp, dev, crf)
    errs = fn()["err"].cpu().numpy()
    if (errs != 0).any():
        raise AssertionError(f"errors: {np.unique(errs)}")
    dt = mean_s(fn, ITERS, dev)
    tag = "CRF " if crf else ""
    where = f"on {torch.cuda.get_device_name(dev)}" if dev.type == "cuda" else (
        "plain version on the CPU, host clock")
    print(f"{tag}exact duplex kernel x{B} (W={inp['W']}, N={inp['N']}): "
          f"{B / dt:>8,.1f} pairs/s  ({dt * 1e3:.1f} ms/batch) [{where}]", flush=True)
    return B / dt, dt * 1e3


if __name__ == "__main__":
    main()
