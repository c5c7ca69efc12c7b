"""Ablation timing of the version-1 beam kernel's step phases.

Port of ``tools/kernel_ablate.py``: semantically WRONG variants of the fused
1D beam, with single phases stubbed out, are timed against the whole kernel
to attribute step time to the phases:

  - ``idlog``: no id-log store;
  - ``mix``: a child's hash is its tip's own hash (no mixing);
  - ``match``: no matching and no arrivals, every pushed extension is fresh;
  - ``err``: no status flags;
  - ``rounds``: one selection round; slots 1..K-1 keep their old state;
  - ``hpick``: new hashes ``sel_id * 7`` and ``sel_id * 13`` (int32
    wraparound) instead of the winners' hashes.

``run_ablate`` launches the CUDA kernel (``csrc/beam_ablate_kernel.cu``,
the version-1 body of ``csrc/beam_core.cuh`` with a compile-time phase mask)
on a CUDA tensor.  That body runs the design of the main path's kernel: one
thread per read, the frame loaded a step ahead, the one-pass selection (a
sorted insert; ``rounds`` keeps a one-slot list) and matching per tip; so the
deltas attribute the one-pass step, not the first design's K rounds that
the JAX tool's kernel runs.  It computes the same stubbed function as the
JAX tool, whatever the design.  The tool stays one of version 1, as the
JAX tool is built over ``_beam_kernel``.  On a CPU tensor ``run_ablate``
runs ``ablate_plain``, the same stubbed step in plain torch built from
``ops/beam_fast.py``'s pieces.  The kernel
exists for the nine sets that ``main`` times (``SETS``), at beam <= 5 and
A+1 <= 5 (the tool's beam 5 over "NACGT"); anything else raises ValueError.
Nothing in the library uses these variants.

Usage (on a CUDA card): ``python -m fast_ctc_decode_tpu_torch.tools.kernel_ablate [B] [T] [iters]``
prints each set's kernel time and its delta against the whole kernel.
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from .. import errors
from ..ops import _build
from ..ops import beam_cuda
from ..ops import beam_fast

PHASES = {"idlog": 1, "mix": 2, "match": 4, "err": 8, "rounds": 16, "hpick": 32}
#: the sets the tool times, in its order (tools/kernel_ablate.py:346-347)
SETS = ("", "idlog", "mix", "match", "err", "rounds", "hpick", "match,mix", "rounds,err")
MAX_BEAM, MAX_A = 5, 4  # the kernel's one instance, <5, 4>
_MASKS = {sum(PHASES[n] for n in s.split(",") if n) for s in SETS}

#: kernel launches since the last reset (the plain version counts nothing)
launches = {"ablate": 0}


def phase_mask(ablate: str) -> int:
    """The kernel's phase mask of a comma-separated set; ValueError for a set
    that has no kernel instance."""
    names = tuple(n for n in ablate.split(",") if n) if ablate else ()
    if any(n not in PHASES for n in names):
        raise ValueError(f"unknown ablation phase in {ablate!r}; phases: {sorted(PHASES)}")
    mask = sum(PHASES[n] for n in set(names))
    if mask not in _MASKS:
        raise ValueError(f"ablation set {ablate!r} is not one of {SETS}")
    return mask


def ablate_plain(probs, lengths, thr, *, beam_size, ablate=""):
    """The stubbed version-1 step in plain torch: ``{"fin" [B], "err" [B]}``
    (int32, on the input's device), collapse_repeats on."""
    mask = phase_mask(ablate)
    B, T, A1 = probs.shape
    A, K = A1 - 1, int(beam_size)
    dev = probs.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    thr = torch.tensor(float(thr), dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    lbl = torch.arange(A, device=dev)
    c = beam_fast._init_fast_carry(
        K,
        torch.zeros((B,), dtype=torch.float32, device=dev),
        torch.ones((B,), dtype=torch.float32, device=dev),
        torch.zeros((B,), dtype=torch.int64, device=dev),
    )
    fid = torch.arange(K * A, dtype=torch.int32, device=dev).expand(B, K * A)
    R = 1 if mask & PHASES["rounds"] else K
    for t in range(T):
        active = (t < lengths) & (c.err == errors.OK)
        p = probs[:, t]
        p0, plab = p[:, 0], p[:, 1:]
        is_rep = c.lastlab[:, :, None] == lbl
        if mask & PHASES["mix"]:
            th1 = c.h1[:, :, None].expand(B, K, A)
            th2 = c.h2[:, :, None].expand(B, K, A)
        else:
            th1 = beam_fast._mix1(c.h1[:, :, None], lbl)
            th2 = beam_fast._mix2(c.h2[:, :, None], lbl)
        pushed = c.valid[:, :, None] & ~(plab[:, None, :] < thr)
        lg = c.lab + c.gap
        m_ext = torch.where(is_rep, c.gap[:, :, None], lg[:, :, None]) * plab[:, None, :]
        if mask & PHASES["match"]:
            matched = torch.zeros_like(pushed)
            push_ext = pushed
            recv = torch.zeros_like(c.lab)
            recv_any = torch.zeros_like(c.valid)
        else:
            m = (
                (th1[..., None] == c.h1[:, None, None, :])
                & (th2[..., None] == c.h2[:, None, None, :])
                & (lbl[None, None, :, None] == c.lastlab[:, None, None, :])
                & c.valid[:, None, None, :]
            )
            matched = m.any(-1)
            push_ext = pushed & (~is_rep | matched | (c.gap > 0)[:, :, None])
            arrive = (m & push_ext[..., None]).flatten(1, 2)  # [B, K*A, K]
            m_flat = m_ext.flatten(1)
            # arrivals summed one by one in (k, a) order, as the kernel does
            # (with 'mix' stubbed a tip can receive several)
            recv = torch.zeros_like(c.lab)
            for i in range(K * A):
                recv = recv + torch.where(arrive[:, i], m_flat[:, i, None], 0.0)
            recv_any = arrive.any(1)
        p_stay = torch.gather(plab, 1, c.lastlab.clamp(0, A - 1))
        stay_push = c.valid & (c.lastlab >= 0) & ~(p_stay < thr)
        stay_lab = torch.where(stay_push, c.lab * p_stay, 0.0)
        blank_push = c.valid & (p0[:, None] > thr)
        tip_gap = torch.where(blank_push, lg * p0[:, None], 0.0)
        tip_lab = stay_lab + recv
        tip_valid = blank_push | stay_push | recv_any

        fresh_valid = (push_ext & ~matched).flatten(1)
        c_valid = torch.cat([tip_valid, fresh_valid], 1)
        c_lab = torch.cat([tip_lab, m_ext.flatten(1)], 1)
        c_gap = torch.cat([tip_gap, torch.zeros_like(m_ext.flatten(1))], 1)
        c_id = torch.cat([c.id, t * K * A + fid], 1)
        c_h1 = torch.cat([c.h1, th1.flatten(1)], 1)
        c_h2 = torch.cat([c.h2, th2.flatten(1)], 1)
        c_ll = torch.cat([c.lastlab, lbl.repeat(K).expand(B, K * A)], 1)
        total = c_lab + c_gap
        key = torch.where(c_valid, torch.where(total.isnan(), inf, total + 0.0), -inf)

        lab, gap, ids = c.lab.clone(), c.gap.clone(), c.id.clone()
        h1, h2, ll, valid = c.h1.clone(), c.h2.clone(), c.lastlab.clone(), c.valid.clone()
        top = None
        for r in range(R):
            mx = key.amax(1, keepdim=True)
            v = mx[:, 0] > -inf
            at = key == mx
            sid = torch.where(at, c_id, beam_fast._I32_MAX).amin(1, keepdim=True)
            chosen = at & (c_id == sid)
            lane = chosen.to(torch.int32).argmax(1, keepdim=True)

            def pick(x):
                return x.gather(1, lane)[:, 0]

            sel_lab, sel_gap = pick(c_lab) + 0.0, pick(c_gap) + 0.0
            if top is None:
                top = sel_lab + sel_gap
            sel_id = torch.where(v, pick(c_id), beam_fast.EMPTY)
            if mask & PHASES["hpick"]:
                h1[:, r] = (sel_id.to(torch.int64) * 7) & beam_fast._MASK32
                h2[:, r] = (sel_id.to(torch.int64) * 13) & beam_fast._MASK32
            else:
                h1[:, r], h2[:, r] = pick(c_h1), pick(c_h2)
            ll[:, r] = pick(c_ll)
            lab[:, r] = sel_lab
            gap[:, r] = sel_gap
            ids[:, r] = sel_id
            valid[:, r] = v
            key = key.masked_fill(chosen, -inf)
        lab[:, :R] = torch.where(valid[:, :R], lab[:, :R] / top[:, None], 0.0)
        gap[:, :R] = torch.where(valid[:, :R], gap[:, :R] / top[:, None], 0.0)

        if mask & PHASES["err"]:
            step_err = torch.zeros_like(c.err)
        else:
            cnt = c_valid.sum(1)
            nan_flag = (cnt >= 2) & (c_valid & total.isnan()).any(1)
            step_err = torch.where(
                nan_flag, errors.INCOMPARABLE_VALUES,
                torch.where(cnt == 0, errors.RAN_OUT_OF_BEAM, errors.OK),
            ).to(torch.int32)
        act = active[:, None]
        c = beam_fast.FastCarry(
            id=torch.where(act, ids, c.id), h1=torch.where(act, h1, c.h1),
            h2=torch.where(act, h2, c.h2), lastlab=torch.where(act, ll, c.lastlab),
            state=c.state, lab=torch.where(act, lab, c.lab), gap=torch.where(act, gap, c.gap),
            valid=torch.where(act, valid, c.valid),
            err=torch.where(c.err > 0, c.err, torch.where(active, step_err, 0)).to(torch.int32),
        )
    return {"fin": c.id[:, 0].contiguous(), "err": c.err}


def run_ablate(probs, lengths, thr, *, beam_size, ablate=""):
    """Forward beam with the phases of ``ablate`` stubbed: ``{"fin", "err"}``.

    probs [B, T, A+1] f32 and lengths [B] i32 on one device: the kernel on a
    CUDA tensor (beam_size <= 5, A+1 <= 5, one of ``SETS``; ValueError
    otherwise), ``ablate_plain`` on a CPU tensor."""
    mask = phase_mask(ablate)
    if not isinstance(probs, torch.Tensor) or probs.dim() != 3:
        raise ValueError("probs must be a [B, T, A+1] torch.Tensor")
    B, T, A1 = probs.shape
    K = int(beam_size)
    beam_cuda._check(probs, "probs", torch.float32, (B, T, A1), probs.device)
    beam_cuda._check(lengths, "lengths", torch.int32, (B,), probs.device)
    beam_cuda._bounds(T, K, A1 - 1)
    if K > MAX_BEAM or A1 - 1 > MAX_A:
        raise ValueError(
            f"the ablation kernel has one instance, beam <= {MAX_BEAM} and A+1 <= "
            f"{MAX_A + 1}; got beam {K}, A+1 {A1}"
        )
    if probs.device.type == "cpu":
        return ablate_plain(probs, lengths, thr, beam_size=K, ablate=ablate)
    return _launch(probs, lengths, thr, K=K, mask=mask, what=ablate or "none")


def _launch(probs, lengths, thr, *, K, mask, what):
    """Launch the ablation kernel of phase mask ``mask`` on ``probs``'s device."""
    B, T, A1 = probs.shape
    dev = probs.device
    ids_log = torch.empty((T, K, B), dtype=torch.int32, device=dev)
    fin = torch.empty((B,), dtype=torch.int32, device=dev)
    err = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return {"fin": fin, "err": err}
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.ctc_beam_ablate_launch(
            probs.data_ptr(), lengths.data_ptr(), float(thr), B, T, A1 - 1, K, mask,
            ids_log.data_ptr(), fin.data_ptr(), err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    beam_cuda._raise_for(rc, f"ablation kernel ({what})")
    launches["ablate"] += 1
    return {"fin": fin, "err": err}


def event_ms(fn, iters):
    """Median device time of ``fn`` in ms between two CUDA events, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_sets(probs, lengths, thr, *, beam_size=5, iters=5):
    """``{set: ms}``: each set's kernel time (CUDA events, median of
    ``iters``) on the CUDA tensors ``probs``, ``lengths``."""
    return {
        ab: event_ms(lambda ab=ab: run_ablate(probs, lengths, thr, beam_size=beam_size,
                                              ablate=ab), iters)
        for ab in SETS
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    B = int(argv[0]) if len(argv) > 0 else 16384
    T = int(argv[1]) if len(argv) > 1 else 1000
    iters = int(argv[2]) if len(argv) > 2 else 5
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablate times the CUDA kernel: no CUDA device")
    rng = np.random.RandomState(42)
    probs = rng.rand(B, T, 5).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    dev = torch.device("cuda")
    pd = torch.from_numpy(probs).to(dev)
    ld = torch.full((B,), T, dtype=torch.int32, device=dev)
    print(f"{torch.cuda.get_device_name(0)}, B={B} T={T}, beam 5, cut 0.1", flush=True)
    ms = time_sets(pd, ld, 0.1, iters=iters)
    base = ms[""]
    for ab, dt in ms.items():
        print(f"ablate={ab or 'none':12s} {dt:8.2f} ms  delta {-(dt - base):+7.2f} ms", flush=True)


if __name__ == "__main__":
    main()
