"""A/B the three versions of the fused 1D beam kernel on a CUDA card.

Port of ``tools/ab_bench.py``.  It first holds versions 1, 2 and 3 to one
another on the whole batch, all four fields of the output dict (labels_rev,
times_rev, count, err) bit for bit, and exits (``SystemExit``) at the first
mismatch; then it times each version's beam kernel alone (``raw=True``: the
forward beam, CUDA events) and the full pipeline (beam kernel + traceback
kernel), median of ``iters`` runs, with reads/s.

Version 2 is the redesigned kernel: at this tool's B=32768 it runs one
thread per read with a one-pass selection (``beam_cuda.design_for``; below
``beam_cuda.THREAD_MIN_B`` reads it runs one warp per read), while versions 1
and 3 keep the first design, K selection rounds, as the yardstick.  All three
must still agree bit for bit.

The JAX tool also sweeps the Pallas ``(block_b, block_t)`` tiling; that is
the TPU's VMEM blocking and has no counterpart here (the T loop runs inside
the thread or warp of a read), so it is not carried over;
``tools/kernel_probe.py`` sweeps the batch size over both version-2 designs.

Usage (on a CUDA card): ``python -m fast_ctc_decode_tpu_torch.tools.ab_bench [B] [T] [iters]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import beam_cuda
from .kernel_ablate import event_ms

FIELDS = ("labels_rev", "times_rev", "count", "err")
VERSIONS = (1, 2, 3)


def parity(probs, lengths, thr, *, beam_size=5):
    """Run every version's full pipeline once; SystemExit naming the first
    field and reads where one differs from version 1.  Returns version 1's
    output dict."""
    outs = {
        v: beam_cuda.beam_search_kernel_batch(probs, lengths, thr, beam_size=beam_size,
                                              version=v)
        for v in VERSIONS
    }
    ref = outs[VERSIONS[0]]
    for v in VERSIONS[1:]:
        for f in FIELDS:
            a, b = ref[f], outs[v][f]
            if not torch.equal(a, b):
                bad = torch.nonzero(~(a == b).reshape(a.shape[0], -1).all(-1))[:10, 0]
                raise SystemExit(
                    f"PARITY FAIL v{VERSIONS[0]} vs v{v} {f}: reads {bad.tolist()}")
    return ref


def time_versions(probs, lengths, thr, *, beam_size=5, iters=5):
    """``{(version, "raw" | "full"): ms}`` (CUDA events, median of ``iters``)."""
    out = {}
    for v in VERSIONS:
        out[(v, "raw")] = event_ms(lambda v=v: beam_cuda.beam_search_kernel_batch(
            probs, lengths, thr, beam_size=beam_size, version=v, raw=True), iters)
        out[(v, "full")] = event_ms(lambda v=v: beam_cuda.beam_search_kernel_batch(
            probs, lengths, thr, beam_size=beam_size, version=v), iters)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    B = int(argv[0]) if len(argv) > 0 else 16384
    T = int(argv[1]) if len(argv) > 1 else 1000
    iters = int(argv[2]) if len(argv) > 2 else 5
    if not torch.cuda.is_available():
        raise SystemExit("ab_bench times the CUDA kernels: no CUDA device")
    rng = np.random.RandomState(42)
    probs = rng.rand(B, T, 5).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    dev = torch.device("cuda")
    pd = torch.from_numpy(probs).to(dev)
    ld = torch.full((B,), T, dtype=torch.int32, device=dev)
    print(f"{torch.cuda.get_device_name(0)}, B={B} T={T}, beam 5, cut 0.1", flush=True)
    parity(pd, ld, 0.1)
    print(f"parity v1 == v2 == v3 OK ({', '.join(FIELDS)})", flush=True)
    for (v, kind), ms in time_versions(pd, ld, 0.1, iters=iters).items():
        tag = f"v{v} {'raw kernel' if kind == 'raw' else 'full pipeline'}"
        print(f"{tag:34s} {ms:9.2f} ms {B / (ms / 1e3):12.0f} reads/s", flush=True)


if __name__ == "__main__":
    main()
