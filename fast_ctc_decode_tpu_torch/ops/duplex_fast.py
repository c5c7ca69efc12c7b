"""Plain PyTorch duplex pair-consensus beam search: per-slot bands, no tree.

Port of ``fast_ctc_decode_tpu/ops/duplex_fast.py`` (plain and CRF), batched
over read pairs with a Python loop over network_1 time.  It is at once
``engine="fast"``, the CPU path, and the plain version that the CUDA slot
kernel (``csrc/duplex_kernel.cu`` via ``ops/duplex_cuda.py``) is checked
against bit for bit.

The algorithm (see the JAX module's docstring for the exactness contract
against the reference ``duplex::beam_search`` / ``crf_beam_search``):

 - **Bands live in beam slots.**  Each of the K hypotheses carries the
   banded forward DP over network_2 of its own prefix and a copy of its
   parent's band (for the extension recurrence), refreshed while the parent
   is live in the beam.
 - **Hash prefix identity, analytic merge, K rounds of (max score, tie ->
   min position-coded id)** with explicit validity, so a zero-probability
   hypothesis stays selectable.  No renormalisation (log space).
 - **Band cells are built sequentially**, two logsumexps per cell in the
   reference's order (duplex.rs:229-247), as the JAX package's Pallas slot
   kernel does; the JAX XLA engine uses an associative scan instead, so this
   engine meets it at the level of its contract: sequence and status code.

Layout: bands are stored in absolute network_2 columns (``[B, K, T2 + 1]``,
column ``t2``; column T2 takes dropped writes), one layout for all three
envelope classes of the JAX engine (static, window-relative, circular).
Reads are masked by each band's ``[off, end)`` window exactly as there, so
the values are the same whichever layout holds them.

Log-space primitives follow the reference's operand ordering: ``ls_add``
orders by value and short-circuits ``small == -inf``; ``ls_max`` never
admits NaN (duplex.rs:33-63).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import errors
from .beam_fast import _SEED1, _SEED2, _mix1, _mix2, _traceback_scan_batch

NEG = float("-inf")
_I32_MAX = 2**31 - 1


def ls_add(a, b):
    """LogSpace + (logsumexp) with reference operand ordering (duplex.rs:42-63)."""
    cond = a <= b
    big = torch.where(cond, b, a)
    small = torch.where(cond, a, b)
    return torch.where(small == NEG, big, big + torch.log1p(torch.exp(small - big)))


def ls_add_cr(a, b):
    """``ls_add`` with ``exp`` and ``log1p`` correctly rounded: each computed
    in float64 and rounded once to float32, as the libm ``expf`` / ``log1pf``
    that the reference's f32 ``exp`` / ``ln_1p`` call nearly always give (the
    CRF tree engine's; ``csrc/duplex_core.cuh``'s ``ls_add<true>``)."""
    cond = a <= b
    big = torch.where(cond, b, a)
    small = torch.where(cond, a, b)
    e = torch.exp((small - big).double()).float()
    return torch.where(small == NEG, big, big + torch.log1p(e.double()).float())


def ls_max(m, t):
    """LogSpace::max: NaN in ``t`` never replaces ``m`` (duplex.rs:33-39)."""
    return torch.where(m < t, t, m)


def _nan_clean_max(tot, mask):
    """Masked max over the last axis that skips NaN entries, as the
    reference's ls_max fold (a max of non-NaN values is order-free)."""
    return torch.where(mask & ~tot.isnan(), tot, NEG).amax(-1)


def _root_read(root_gap, t2):
    """Root band gap value at cell t2 (``root_gap[b, i]`` holds cell i - 1;
    duplex.rs:389-409); -inf outside.  ``t2``: [B, ...] integer tensor."""
    B, Wr = root_gap.shape
    idx = t2.long() + 1
    ok = (idx >= 0) & (idx < Wr)
    flat = idx.clamp(0, Wr - 1).reshape(B, -1)
    val = root_gap.gather(1, flat).reshape(idx.shape)
    return torch.where(ok, val, NEG)


class DuplexFastCarry(NamedTuple):
    id: torch.Tensor  # [B, K] i32 position-coded node id; -1 root, -2 empty
    h1: torch.Tensor  # [B, K] i64 (uint32 values) prefix hash
    h2: torch.Tensor  # [B, K] i64
    ph1: torch.Tensor  # [B, K] i64 parent prefix hash (for the copy refresh)
    ph2: torch.Tensor  # [B, K] i64
    lastlab: torch.Tensor  # [B, K] i64 last label, -1 root
    plastlab: torch.Tensor  # [B, K] i64 parent's last label
    state: torch.Tensor  # [B, K] i64 CRF state used by this slot's band
    p1l: torch.Tensor  # [B, K] f32
    p1g: torch.Tensor  # [B, K] f32
    p2m: torch.Tensor  # [B, K] f32 band max total
    valid: torch.Tensor  # [B, K] bool
    blab: torch.Tensor  # [B, K, T2 + 1] f32 own band, absolute t2 columns
    bgap: torch.Tensor  # [B, K, T2 + 1] f32
    boff: torch.Tensor  # [B, K] i64 window start (t2)
    bend: torch.Tensor  # [B, K] i64 window end (exclusive)
    pblab: torch.Tensor  # [B, K, T2 + 1] f32 parent band copy
    pbgap: torch.Tensor  # [B, K, T2 + 1] f32
    pboff: torch.Tensor  # [B, K] i64
    pbend: torch.Tensor  # [B, K] i64
    proot: torch.Tensor  # [B, K] bool parent is the virtual root
    last_upper: torch.Tensor  # [B] i64
    err: torch.Tensor  # [B] i32


def _init_carry(B, K, C, init_states, device):
    is0 = (torch.arange(K, device=device) == 0).expand(B, K)
    z64 = torch.zeros((B, K), dtype=torch.int64, device=device)
    negk = torch.full((B, K), NEG, dtype=torch.float32, device=device)
    band = lambda: torch.full((B, K, C), NEG, dtype=torch.float32, device=device)  # noqa: E731
    return DuplexFastCarry(
        id=torch.where(is0, -1, -2).to(torch.int32),
        h1=torch.where(is0, _SEED1, z64),
        h2=torch.where(is0, _SEED2, z64),
        ph1=z64.clone(),
        ph2=z64.clone(),
        lastlab=torch.full((B, K), -1, dtype=torch.int64, device=device),
        plastlab=torch.full((B, K), -2, dtype=torch.int64, device=device),
        state=torch.where(is0, init_states.long()[:, None], z64),
        p1l=negk.clone(),
        p1g=torch.where(is0, 0.0, negk),
        p2m=torch.where(is0, 0.0, negk),
        valid=is0.clone(),
        blab=band(), bgap=band(), boff=z64.clone(), bend=z64.clone(),
        pblab=band(), pbgap=band(), pboff=z64.clone(), pbend=z64.clone(),
        proot=torch.zeros((B, K), dtype=torch.bool, device=device),
        last_upper=torch.zeros((B,), dtype=torch.int64, device=device),
        err=torch.zeros((B,), dtype=torch.int32, device=device),
    )


def _l2_rows(l2, t2, state, crf):
    """network_2 log rows at cells ``t2`` [B, ...] (CRF: at ``state``
    [B, ...]): [B, ..., A+1]."""
    B, T2 = l2.shape[0], l2.shape[1]
    bi = torch.arange(B, device=l2.device).view((B,) + (1,) * (t2.dim() - 1))
    tt = t2.long().clamp(0, max(T2 - 1, 0))
    if crf:
        S = l2.shape[2]
        return l2[bi, tt, state.long().clamp(0, S - 1)]
    return l2[bi, tt]


def _pick(x, s):
    """x[b, s[b]] for [B, K, ...] x and [B] slot indices."""
    return x[torch.arange(x.shape[0], device=x.device), s]


def _extend_slot(c, s, act, lo, hi, l2, root_gap, *, A, crf):
    """Extend the band of slot ``s`` [B] to ``hi`` where ``act`` (per
    duplex.rs:338-387 plain / 290-336 CRF): discard below lo - 1, refresh the
    window max, append every cell of [end, hi) reading the parent copy at
    the previous cell, then refresh the parent copies of the slots whose
    parent is this one.

    The JAX engine caps the appended cells at a static ``Wext``; with a
    dipping-then-recovering upper bound that cap can leave cells inside the
    window unwritten (layout-dependent values).  Appending all of them, as
    the reference and the JAX Pallas kernel do, keeps every readable cell
    defined; it equals the JAX engine wherever the cap does not bind."""
    B, K, C = c.blab.shape
    dev = c.blab.device
    off, end = _pick(c.boff, s), _pick(c.bend, s)
    lastlab, plastlab, state = _pick(c.lastlab, s), _pick(c.plastlab, s), _pick(c.state, s)
    proot, pboff, pbend = _pick(c.proot, s), _pick(c.pboff, s), _pick(c.pbend, s)
    row_lab, row_gap = _pick(c.blab, s).clone(), _pick(c.bgap, s).clone()
    pb_lab, pb_gap = _pick(c.pblab, s), _pick(c.pbgap, s)
    p2m = _pick(c.p2m, s)

    # discard_until(lo - 1) + update_max(lo, hi) when the window must slide
    do_discard = act & (lo > off)
    emptied = end <= lo - 1
    off2 = torch.where(do_discard, torch.where(emptied, lo, lo - 1), off)
    end2 = torch.where(do_discard & emptied, lo, end)
    cols = torch.arange(C, device=dev)
    in_win = (cols >= torch.maximum(lo, off2)[:, None]) & (cols < torch.minimum(hi, end2)[:, None])
    p2m = torch.where(do_discard, _nan_clean_max(ls_add(row_lab, row_gap), in_win), p2m)

    # the CRF extension recurrence has no repeat branch (duplex.rs:323-328)
    is_rep = (plastlab == lastlab) if not crf else torch.zeros_like(act)
    has_last = end2 > off2
    last_col = (end2 - 1).clamp(0, C - 1)[:, None]
    last_lab = torch.where(has_last, row_lab.gather(1, last_col)[:, 0], NEG)
    last_gap = torch.where(has_last, row_gap.gather(1, last_col)[:, 0], NEG)
    lab_idx = lastlab.clamp(0, A - 1)[:, None] + 1
    n_new = torch.where(act, hi - end2, 0)
    for j in range(int(n_new.max()) if act.numel() else 0):  # the longest catch-up
        t2 = end2 + j
        a = j < n_new
        r = _l2_rows(l2, t2, state, crf)  # [B, A+1]
        p0, pl = r[:, 0], r.gather(1, lab_idx)[:, 0]
        pv = t2 - 1
        pcol = pv.clamp(0, C - 1)[:, None]
        p_ok = (pv >= pboff) & (pv < pbend) & ~proot
        ppl = torch.where(p_ok, pb_lab.gather(1, pcol)[:, 0], NEG)
        ppg = torch.where(
            proot, _root_read(root_gap, pv), torch.where(p_ok, pb_gap.gather(1, pcol)[:, 0], NEG)
        )
        base = torch.where(is_rep, ppg, ls_add(ppl, ppg))
        gap_n = ls_add(last_lab, last_gap) + p0
        lab_n = pl + ls_add(last_lab, base)
        wcol = torch.where(a, t2, C - 1)[:, None]  # column T2 takes dropped writes
        row_lab.scatter_(1, wcol, torch.where(a, lab_n, row_lab.gather(1, wcol)[:, 0])[:, None])
        row_gap.scatter_(1, wcol, torch.where(a, gap_n, row_gap.gather(1, wcol)[:, 0])[:, None])
        p2m = torch.where(a, ls_max(p2m, ls_add(lab_n, gap_n)), p2m)
        last_lab = torch.where(a, lab_n, last_lab)
        last_gap = torch.where(a, gap_n, last_gap)
    end3 = torch.where(act, hi, end2)

    sel = (torch.arange(K, device=dev) == s[:, None]) & act[:, None]
    g = lambda new, old: torch.where(sel, new[:, None], old)  # noqa: E731
    g2 = lambda new, old: torch.where(sel[..., None], new[:, None], old)  # noqa: E731
    c = c._replace(
        blab=g2(row_lab, c.blab), bgap=g2(row_gap, c.bgap),
        boff=g(off2, c.boff), bend=g(end3, c.bend), p2m=g(p2m, c.p2m),
    )
    # refresh parent copies of slots whose parent is this (just-extended)
    # slot: the reference reads the parent's live tree band (duplex.rs:493)
    child = (
        act[:, None] & c.valid & (c.ph1 == _pick(c.h1, s)[:, None])
        & (c.ph2 == _pick(c.h2, s)[:, None]) & ~c.proot
    )
    return c._replace(
        pblab=torch.where(child[..., None], row_lab[:, None], c.pblab),
        pbgap=torch.where(child[..., None], row_gap[:, None], c.pbgap),
        pboff=torch.where(child, off2[:, None], c.pboff),
        pbend=torch.where(child, end3[:, None], c.pbend),
    )


def _build_fresh_bands(c, lo, hi, wc, rows, root_gap, is_rep):
    """Bands of all K*A fresh candidates over cells [lo, hi) (at most ``wc``
    of them), built cell by cell in the reference's order.

    ``rows``: [B, K or 1, wc, A+1] network_2 rows of cells lo + j.
    Returns (lab, gap [B, K, A, wc] window-relative, -inf past hi - lo;
    p2m [B, K, A] the NaN-free band max)."""
    B, K, C = c.blab.shape
    dev = c.blab.device
    j = torch.arange(wc, device=dev)
    pv = lo[:, None] + j - 1  # [B, wc] parent cells
    pcol = pv.clamp(0, C - 1)[:, None, :].expand(B, K, wc)
    t_ok = (pv[:, None] >= c.boff[..., None]) & (pv[:, None] < c.bend[..., None])
    root = (c.id == -1)[..., None]
    par_lab = torch.where(t_ok & ~root, c.blab.gather(2, pcol), NEG)
    par_gap = torch.where(root, _root_read(root_gap, pv)[:, None], torch.where(t_ok, c.bgap.gather(2, pcol), NEG))
    base_tot = ls_add(par_lab, par_gap)  # [B, K, wc]
    base = torch.where(is_rep[..., None], par_gap[:, :, None], base_tot[:, :, None])  # [B, K, A, wc]
    cmask = j < (hi - lo)[:, None]  # [B, wc]

    A = is_rep.shape[2]
    lab_out = torch.full((B, K, A, wc), NEG, dtype=torch.float32, device=dev)
    gap_out = torch.full((B, K, A, wc), NEG, dtype=torch.float32, device=dev)
    p2m = torch.full((B, K, A), NEG, dtype=torch.float32, device=dev)
    last_lab = torch.full((B, K, A), NEG, dtype=torch.float32, device=dev)
    last_tot = last_lab
    for i in range(wc):
        r = rows[:, :, i]  # [B, K or 1, A+1]
        gap_n = last_tot + r[..., :1]
        lab_n = r[..., 1:] + ls_add(last_lab, base[..., i])
        tot = ls_add(lab_n, gap_n)
        m = cmask[:, i, None, None]
        lab_out[..., i] = torch.where(m, lab_n, NEG)
        gap_out[..., i] = torch.where(m, gap_n, NEG)
        p2m = torch.where(m & (p2m < tot), tot, p2m)
        last_lab, last_tot = lab_n, tot
    return lab_out, gap_out, p2m


def _step(c, t, l1t, l2, root_gap, lo, hi, wc, lengths, thr, *, A, K, collapse, crf, needs_ext):
    """One network_1 step for every pair; returns the next carry."""
    B, _, C = c.blab.shape
    dev = l2.device
    KA = K * A
    in_range = t < lengths
    env_bad = in_range & ((lo >= hi) | (lo > c.last_upper))
    alive = c.err == errors.OK
    active = alive & in_range & ~env_bad
    c = c._replace(err=torch.where(alive & env_bad, errors.INVALID_ENVELOPE, c.err).to(torch.int32))

    # ---- band extension, parents before children in node-id order
    # (duplex.rs:490-522) ----
    if needs_ext:
        ext_flag = active & (hi > c.last_upper)
        key = torch.where(c.valid & (c.id >= 0), c.id, _I32_MAX)
        order = torch.argsort(key, dim=1, stable=True)
        for r in range(K):
            s = order[:, r]
            act = ext_flag & _pick(c.valid, s) & (_pick(c.id, s) >= 0) & (_pick(c.bend, s) < hi)
            c = _extend_slot(c, s, act, lo, hi, l2, root_gap, A=A, crf=crf)
    c = c._replace(last_upper=torch.where(active, hi, c.last_upper))

    # ---- expansion (duplex.rs:526-592 / 740-779) ----
    if crf:
        prow = l1t.gather(1, c.state.clamp(0, l1t.shape[1] - 1)[..., None].expand(B, K, A + 1))
    else:
        prow = l1t[:, None, :]  # [B, 1, A+1]
    p0, plab = prow[..., 0], prow[..., 1:]
    lbl = torch.arange(A, device=dev)
    pushed_lab = c.valid[..., None] & ~(plab < thr)
    gap_pos = c.p1g > NEG
    if collapse and not crf:
        is_rep = c.lastlab[..., None] == lbl
    else:
        is_rep = torch.zeros((B, K, A), dtype=torch.bool, device=dev)

    th1 = _mix1(c.h1[..., None], lbl)
    th2 = _mix2(c.h2[..., None], lbl)
    m = (
        (th1[..., None] == c.h1[:, None, None, :]) & (th2[..., None] == c.h2[:, None, None, :])
        & (lbl[None, None, :, None] == c.lastlab[:, None, None, :]) & c.valid[:, None, None, :]
    )  # [B, K, A, K]: extension (k, a) lands on tip j
    matched = m.any(-1)
    p1tot = ls_add(c.p1l, c.p1g)
    m_ext = torch.where(is_rep, c.p1g[..., None], p1tot[..., None]) + plab
    push_ext = pushed_lab & (~is_rep | matched | gap_pos[..., None])

    # analytic merge: tips receive blank + stay + at most one arrival
    arr = m & push_ext[..., None]
    recv_any = arr.any(1).any(1)
    recv = torch.where(arr, m_ext[..., None], NEG).amax(1).amax(1)
    recv = torch.where(recv_any, recv, NEG)
    nan_arr = (arr & m_ext.isnan()[..., None]).any(1).any(1)
    recv = torch.where(nan_arr, float("nan"), recv)
    if collapse and not crf:
        p_stay = plab.expand(B, K, A).gather(2, c.lastlab.clamp(0, A - 1)[..., None])[..., 0]
        stay_push = c.valid & (c.lastlab >= 0) & ~(p_stay < thr)
        stay_lab = torch.where(stay_push, c.p1l + p_stay, NEG)
    else:
        stay_push = torch.zeros_like(c.valid)
        stay_lab = torch.full_like(c.p1l, NEG)
    blank_push = c.valid & (p0 > thr)
    tip_gap = torch.where(blank_push, p1tot + p0, NEG)
    tip_lab = ls_add(stay_lab, recv)
    tip_valid = blank_push | stay_push | recv_any
    fresh_valid = push_ext & ~matched

    # ---- fresh candidates' bands ----
    j = torch.arange(wc, device=dev)
    t2 = (lo[:, None] + j)[:, None, :]  # [B, 1, wc]
    if crf:
        rows = _l2_rows(l2, t2.expand(B, K, wc), c.state[..., None].expand(B, K, wc), True)
    else:
        rows = _l2_rows(l2, t2, None, False)  # [B, 1, wc, A+1]
    f_lab, f_gap, p2m_new = _build_fresh_bands(c, lo, hi, wc, rows, root_gap, is_rep)

    # ---- candidate table: K tips then K*A fresh; selection ----
    fid = t * KA + torch.arange(KA, dtype=torch.int32, device=dev)
    c_valid = torch.cat([tip_valid, fresh_valid.reshape(B, KA)], 1)
    c_p1l = torch.cat([tip_lab, torch.where(fresh_valid, m_ext, NEG).reshape(B, KA)], 1)
    c_p1g = torch.cat([tip_gap, torch.full((B, KA), NEG, device=dev)], 1)
    c_p2m = torch.cat([c.p2m, p2m_new.reshape(B, KA)], 1)
    c_id = torch.cat([c.id, fid.expand(B, KA)], 1)
    score = ls_add(c_p1l, c_p1g) + c_p2m
    cnt = c_valid.sum(1)
    nan_flag = (cnt >= 2) & (c_valid & score.isnan()).any(1)
    empty_flag = cnt == 0
    inf = torch.tensor(float("inf"), device=dev)
    key = torch.where(c_valid, torch.where(score.isnan(), inf, score + 0.0), NEG)

    # validity is tracked explicitly, NOT via key > -inf: a -inf score is a
    # legitimate zero-probability hypothesis (the reference keeps it)
    remaining = c_valid
    lanes, oks = [], []
    for _ in range(K):
        mx = torch.where(remaining, key, NEG).amax(1, keepdim=True)
        at_mx = remaining & (key == mx)
        sid = torch.where(at_mx, c_id, _I32_MAX).amin(1, keepdim=True)
        chosen = at_mx & (c_id == sid)
        oks.append(remaining.any(1))
        lanes.append(chosen.to(torch.int32).argmax(1))
        remaining = remaining & ~chosen
    lane = torch.stack(lanes, 1)  # [B, K] candidate index of each new slot
    v_k = torch.stack(oks, 1)
    is_tip = lane < K
    src = torch.where(is_tip, lane, (lane - K) // A)  # tip slot or fresh source tip
    fa = (lane - K).clamp_min(0) % A

    def tipf(x):
        return x.gather(1, src)

    def cand(tip_vals, fresh_vals):
        return torch.where(is_tip, tipf(tip_vals), fresh_vals)

    new_state = ((tipf(c.state) * A) % max(l1t.shape[1], 1) + fa) if crf else torch.zeros_like(fa)
    flane = (lane - K).clamp_min(0)
    fresh_ab = torch.stack([f_lab, f_gap], 0).reshape(2, B, KA, wc)
    fb = fresh_ab.gather(2, flane[None, :, :, None].expand(2, B, K, wc))  # [2, B, K, wc]
    ok_col = (j < (hi - lo)[:, None])[:, None, :]
    fcol = torch.where(ok_col, lo[:, None, None] + j, C - 1).expand(B, K, wc)
    fresh_band = [
        torch.full((B, K, C), NEG, device=dev).scatter_(2, fcol, torch.where(ok_col, fb[i], NEG))
        for i in range(2)
    ]
    srcb = src[..., None].expand(B, K, C)
    tip3 = is_tip[..., None]
    nc = DuplexFastCarry(
        id=torch.where(v_k, c_id.gather(1, lane), -2).to(torch.int32),
        h1=cand(c.h1, th1.reshape(B, KA).gather(1, flane)),
        h2=cand(c.h2, th2.reshape(B, KA).gather(1, flane)),
        ph1=cand(c.ph1, tipf(c.h1)),
        ph2=cand(c.ph2, tipf(c.h2)),
        lastlab=cand(c.lastlab, fa),
        plastlab=cand(c.plastlab, tipf(c.lastlab)),
        state=cand(c.state, new_state),
        p1l=torch.where(v_k, c_p1l.gather(1, lane) + 0.0, NEG),
        p1g=torch.where(v_k, c_p1g.gather(1, lane) + 0.0, NEG),
        p2m=torch.where(v_k, c_p2m.gather(1, lane) + 0.0, NEG),
        valid=v_k,
        blab=torch.where(tip3, c.blab.gather(1, srcb), fresh_band[0]),
        bgap=torch.where(tip3, c.bgap.gather(1, srcb), fresh_band[1]),
        boff=cand(c.boff, lo[:, None].expand(B, K)),
        bend=cand(c.bend, hi[:, None].expand(B, K)),
        pblab=torch.where(tip3, c.pblab.gather(1, srcb), c.blab.gather(1, srcb)),
        pbgap=torch.where(tip3, c.pbgap.gather(1, srcb), c.bgap.gather(1, srcb)),
        pboff=cand(c.pboff, tipf(c.boff)),
        pbend=cand(c.pbend, tipf(c.bend)),
        proot=cand(c.proot, tipf(c.id) == -1),
        last_upper=c.last_upper,
        err=c.err,
    )
    step_err = torch.where(
        nan_flag, errors.INCOMPARABLE_VALUES,
        torch.where(empty_flag, errors.RAN_OUT_OF_BEAM, errors.OK),
    )
    err = torch.where(c.err > 0, c.err, torch.where(active, step_err, errors.OK)).to(torch.int32)
    act = active[:, None]
    gated = [
        torch.where(act[..., None] if new.dim() == 3 else act, new, old)
        for new, old in zip(nc[:-2], c[:-2])
    ]
    return DuplexFastCarry(*gated, last_upper=c.last_upper, err=err)


def check_pair_batch(l1, l2, root_gap, lo, hi, init_states, lengths, *, beam_size, crf):
    """Validate a duplex batch; returns (B, T1, T2, S, A)."""
    want = 4 if crf else 3
    for name, x in (("l1", l1), ("l2", l2), ("root_gap", root_gap)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 torch.Tensor")
    if l1.dim() != want or l2.dim() != want or l1.shape[-1] < 2:
        layout = "[B, T, S, A+1]" if crf else "[B, T, A+1]"
        raise ValueError(f"l1 and l2 must be {layout} with A >= 1")
    B, T1 = l1.shape[0], l1.shape[1]
    T2 = l2.shape[1]
    if l2.shape[0] != B or l2.shape[-1] != l1.shape[-1] or (crf and l2.shape[2] != l1.shape[2]):
        raise ValueError("l1 and l2 disagree on the batch, state or label axes")
    if root_gap.dim() != 2 or root_gap.shape[0] != B or root_gap.shape[1] < 1:
        raise ValueError("root_gap must be [B, Wr] with Wr >= 1")
    for name, x in (("lo", lo), ("hi", hi)):
        if not isinstance(x, torch.Tensor) or tuple(x.shape) != (B, T1) or x.dtype != torch.int32:
            raise ValueError(f"{name} must be a [B, T1] int32 tensor")
    for name, x in (("init_states", init_states), ("lengths", lengths)):
        if not isinstance(x, torch.Tensor) or tuple(x.shape) != (B,) or x.dtype != torch.int32:
            raise ValueError(f"{name} must be a [B] int32 tensor")
    if int(beam_size) < 1:
        raise ValueError("beam_size must be >= 1")
    A = l1.shape[-1] - 1
    if T1 * int(beam_size) * A > _I32_MAX:
        raise ValueError("T1 * beam_size * A overflows the int32 node ids")
    return B, T1, T2, (l1.shape[2] if crf else 1), A


def duplex_fast_batch(
    l1, l2, root_gap, lo, hi, threshold_log, init_states, lengths, *,
    beam_size: int, collapse_repeats: bool, needs_ext: bool, crf: bool,
):
    """Slot-band duplex decode of a batch of read pairs (one device).

    l1 [B, T1, A+1] / l2 [B, T2, A+1] (CRF: [B, T, S, A+1]) f32 log probs;
    root_gap [B, Wr] f32 (-inf past each pair's root band); lo/hi [B, T1]
    i32 clamped envelopes; init_states, lengths [B] i32.  ``needs_ext``
    enables band extension, as the JAX engine's static argument does
    (``EnvPrep``); band widths need no argument here.

    Returns dict: labels_rev [B, T1] (0-based labels, deepest first, -1
    padded), count [B], err [B]; all int32 — ``duplex_fast_batch``'s
    contract in the JAX package.
    """
    ids_log, fin, err = duplex_fast_ids(
        l1, l2, root_gap, lo, hi, threshold_log, init_states, lengths,
        beam_size=beam_size, collapse_repeats=collapse_repeats, needs_ext=needs_ext,
        crf=crf,
    )
    T1, A = l1.shape[1], l1.shape[-1] - 1
    labels_rev, _, count = _traceback_scan_batch(fin, ids_log, T1, int(beam_size), A)
    return {"labels_rev": labels_rev, "count": count, "err": err}


def duplex_fast_ids(
    l1, l2, root_gap, lo, hi, threshold_log, init_states, lengths, *,
    beam_size: int, collapse_repeats: bool, needs_ext: bool, crf: bool,
):
    """The forward pass of ``duplex_fast_batch``: ``(ids_log [T1, K, B],
    fin [B], err [B])``, all int32; ids are position-coded
    (``t*K*A + k*A + a``), so ``beam_fast._traceback_scan_batch`` (and the
    CUDA traceback kernel) walk the log."""
    B, T1, T2, S, A = check_pair_batch(
        l1, l2, root_gap, lo, hi, init_states, lengths, beam_size=beam_size, crf=crf
    )
    K = int(beam_size)
    dev = l1.device
    thr = torch.tensor(float(np.float32(threshold_log)), dtype=torch.float32, device=dev)
    lo64, hi64 = lo.long(), hi.long()
    # cells built per step: the widest active window of the batch
    span = (hi64 - lo64).clamp_min(0)
    span = torch.where(torch.arange(T1, device=dev)[None, :] < lengths[:, None].long(), span, 0)
    wcs = span.amax(0).tolist() if B else [0] * T1
    c = _init_carry(B, K, T2 + 1, init_states, dev)
    ids_log = torch.empty((T1, K, B), dtype=torch.int32, device=dev)
    for t in range(T1):
        ids_log[t] = c.id.T
        c = _step(
            c, t, l1[:, t], l2, root_gap, lo64[:, t], hi64[:, t], int(wcs[t]), lengths, thr,
            A=A, K=K, collapse=bool(collapse_repeats), crf=bool(crf),
            needs_ext=bool(needs_ext),
        )
    return ids_log, c.id[:, 0].contiguous(), c.err


# ------------------------------------------------------------- host helpers


class EnvPrep(NamedTuple):
    lo: np.ndarray
    hi: np.ndarray
    W: int
    Wr: int
    needs_ext: bool


class EnvPrepBatch(NamedTuple):
    lo: np.ndarray  # [B, T1] i32 clamped lower bounds
    hi: np.ndarray  # [B, T1] i32 clamped upper bounds
    W: np.ndarray  # [B] i64 tree engines' band width
    Wr: np.ndarray  # [B] i64 root band width
    needs_ext: np.ndarray  # [B] bool: the upper bound grows after step 0 (slot engines)
    tree_needs_ext: np.ndarray  # [B] bool: the upper bound grows at all (tree engines)


def prep_envelopes(envelopes: np.ndarray, T2: int) -> EnvPrepBatch:
    """Clamp a batch of envelopes ``[B, T1, 2]`` and size each pair's bands,
    as the JAX package's ``_prep_envelope_fast`` does pair by pair for the
    fields the port reads.

    Its host replay of the off/upper evolution (discard_until fires only when
    the upper bound grows, duplex.rs:490-522) is a set of prefix maxima along
    the frames: the upper bound before a step is the running maximum of hi
    (from 0); the replay stops at the first step with hi <= lo or lo above
    that bound; a step grows when hi exceeds it, and off is the running
    maximum of lo - 1 over growing steps (from 0).  W is the widest
    ``max(upper - off, hi - lo + 1)`` of the valid steps, at least 1; a
    moving window with non-decreasing lower bounds takes max(hi - lo) + 2.
    The slot engines size nothing from it; W is the tree engines' band
    width."""
    env = np.asarray(envelopes)
    lo = np.maximum(env[..., 0], 0).astype(np.int32)
    hi = np.minimum(env[..., 1], T2).astype(np.int32)
    B, T1 = lo.shape
    if T1 == 0:
        return EnvPrepBatch(lo, hi, np.ones(B, np.int64), np.ones(B, np.int64),
                            np.zeros(B, bool), np.zeros(B, bool))
    l, h = lo.astype(np.int64), hi.astype(np.int64)
    upper = np.maximum.accumulate(np.maximum(h, 0), axis=1)  # after each step
    before = np.zeros_like(upper)
    before[:, 1:] = upper[:, :-1]
    valid = ~np.logical_or.accumulate((h <= l) | (l > before), axis=1)
    grows = valid & (h > before)
    off = np.maximum.accumulate(np.maximum(np.where(grows, l - 1, 0), 0), axis=1)
    W = np.where(valid, np.maximum(upper - off, h - l + 1), 1).max(axis=1)
    static_window = np.all(lo == 0, axis=1) & np.all(hi == T2, axis=1)
    monotone = np.all(np.diff(lo, axis=1) >= 0, axis=1)
    rel = monotone & ~static_window
    W = np.where(rel, np.maximum((hi - lo).max(axis=1).astype(np.int64) + 2, 1), W)
    Wr = np.minimum(np.maximum(env[:, 0, 1], 0), T2).astype(np.int64) + 1
    return EnvPrepBatch(lo, hi, W, Wr, grows[:, 1:].any(axis=1),
                        (hi[:, 1:] > hi[:, :-1]).any(axis=1))


def _prep_envelope_fast(envelope: np.ndarray, T2: int) -> EnvPrep:
    """One envelope ``[T1, 2]`` through ``prep_envelopes``."""
    p = prep_envelopes(np.asarray(envelope)[None], T2)
    return EnvPrep(p.lo[0], p.hi[0], int(p.W[0]), int(p.Wr[0]), bool(p.needs_ext[0]))


def _log_rounded_once(x) -> np.ndarray:
    """float32 ``log`` of ``x`` [B, ...] taken in float64 and rounded once
    (the correctly rounded float32 log), a row of the batch at a time."""
    x = np.asarray(x, np.float32)
    out = np.empty(x.shape, np.float32)
    for b in range(x.shape[0]):
        out[b] = np.log(x[b].astype(np.float64))
    return out


def log_inputs(net1, net2, threshold, *, rounded_once=False):
    """f32 log of both networks and of the cut threshold, on the host:
    numpy's float32 ``log``, as the JAX package takes it, or with
    ``rounded_once`` the correctly rounded one (taken in float64 and rounded
    once to float32), as the CRF duplex inputs take it on every path."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if rounded_once:
            l1, l2 = _log_rounded_once(net1), _log_rounded_once(net2)
        else:
            l1 = np.log(np.asarray(net1, np.float32), dtype=np.float32)
            l2 = np.log(np.asarray(net2, np.float32), dtype=np.float32)
    return l1, l2, log_threshold(threshold, rounded_once=rounded_once)


def log_threshold(threshold, *, rounded_once=False):
    """f32 log of the cut threshold, as ``log_inputs`` takes it."""
    t = np.float32(threshold)
    with np.errstate(divide="ignore"):
        return np.float32(np.log(np.float64(t))) if rounded_once else np.float32(np.log(t))


def root_gap_host(l2: np.ndarray, wr_b, Wr: int) -> np.ndarray:
    """Root bands of a batch, [B, Wr] f32 on the host: the cumulative blank
    run over network_2 (duplex.rs:389-409), -inf past each pair's ``wr_b``."""
    B = l2.shape[0]
    root_gap = np.full((B, Wr), -np.inf, np.float32)
    for b in range(B):
        w = int(wr_b[b])
        root_gap[b, 0] = 0.0
        root_gap[b, 1:w] = np.cumsum(l2[b, : w - 1, 0], dtype=np.float32)
    return root_gap


def crf_root_states(start, S: int, A: int, Wr: int) -> np.ndarray:
    """The blank-state walk of the CRF root bands, ``[B, Wr - 1]`` int64:
    ``start`` [B] (argmax of init2) at cell 0, then ``state * A % S`` a cell
    (duplex.rs:411-441)."""
    states = np.empty((len(start), max(Wr - 1, 0)), np.int64)
    s = np.asarray(start, np.int64)
    for i in range(Wr - 1):
        states[:, i] = s
        s = (s * A) % S
    return states


def crf_root_gap_sum(blanks: np.ndarray, wr_b, Wr: int) -> np.ndarray:
    """CRF root bands, [B, Wr] f32, from the blank entries ``blanks``
    [B, Wr - 1] the walk reads: their running f32 sum in cell order, -inf
    past each pair's ``wr_b``."""
    B = blanks.shape[0]
    root_gap = np.full((B, Wr), -np.inf, np.float32)
    cur = np.zeros((B,), np.float32)
    wr_b = np.asarray(wr_b)
    root_gap[:, 0] = 0.0
    for i in range(Wr - 1):
        cur = (cur + blanks[:, i]).astype(np.float32)
        live = i + 1 < wr_b
        root_gap[live, i + 1] = cur[live]
    return root_gap


def crf_root_gap_host(l2: np.ndarray, init2: np.ndarray, wr_b, Wr: int) -> np.ndarray:
    """CRF root bands, [B, Wr] f32 on the host: the blank-state trajectory
    from argmax(init2) (duplex.rs:411-441), -inf past each pair's ``wr_b``."""
    B, _, S, A1 = l2.shape
    start = np.argmax(np.asarray(init2, np.float32), axis=1)
    states = crf_root_states(start, S, A1 - 1, Wr)
    blanks = l2[np.arange(B)[:, None], np.arange(Wr - 1)[None, :], states, 0]
    return crf_root_gap_sum(blanks, wr_b, Wr)
