"""Plain PyTorch duplex pair-consensus beam search over a suffix tree: the
band-reuse (exact) engine, plain and CRF.

Port of ``fast_ctc_decode_tpu/ops/duplex.py``, batched over read pairs with
a Python loop over network_1 time.  It is the CPU path of
``engine="exact"`` and the plain version that ``csrc/duplex_exact_kernel.cu``
(``ops/duplex_exact_cuda.py``) is checked against bit for bit.

Reference semantics: duplex.rs:443-650 (``beam_search``) and 652-834
(``crf_beam_search``).  Every tree node keeps the banded forward DP over
network_2 of its prefix (``SecondaryProbs``) for as long as the decode
runs, so a prefix pruned from the beam and later re-derived reuses its old
band, as the reference does:

 - **Tree and band tables** per pair: ``parent/label [B, N+1]``,
   ``child [B, N+2, A]`` (the allocator of ``ops/beam.py``, reference
   add_node order) and ``blab/bgap [B, N+1, W]`` with a per-node offset,
   length and max (column ``t2 - off``).  Row / column N takes the writes of
   candidates that allocate nothing.  Past ``max_nodes`` a pair stops with
   NODE_OVERFLOW.
 - **Band builds** for all K*A candidates of a step run cell by cell in the
   reference's order; only newly allocated nodes store theirs.
 - **Band extension** (when the envelope's upper bound grows) runs over the
   node-sorted beam, parents before children, and the node-sorted order
   carries into that step's expansion (the reference's in-place sort,
   duplex.rs:493).
 - **Merge and selection**: blank + stay + one arrival per node, then K
   rounds of (max score, tie -> min node id); a valid -inf score maps to a
   finite key below any real score (``_NEG_VALID``) so it stays selectable.
 - **CRF arithmetic**: the CRF engine's logsumexps take ``exp`` and
   ``log1p`` correctly rounded (``duplex_fast.ls_add_cr``), as the libm
   functions the reference calls nearly always give them; the plain engine
   keeps the float32 ones (``ls_add``).  On pairs of thousands of frames a
   float32 function an ulp off on a fraction of its arguments moves near
   ties of the beam, and the consensus with them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import errors
from .beam import _allocate_nodes, _traceback
from .duplex_fast import (
    NEG,
    _I32_MAX,
    _l2_rows,
    _nan_clean_max,
    _prep_envelope_fast,
    _root_read,
    check_pair_batch,
    ls_add,
    ls_add_cr,
    ls_max,
)

# valid candidates with a true -inf log score must stay selectable, so
# selection maps them to a finite key below any real log score
_NEG_VALID = float(np.float32(-3.0e38))


class DuplexCarry(NamedTuple):
    node: torch.Tensor  # [B, K] i32
    state: torch.Tensor  # [B, K] i64 (CRF)
    p1l: torch.Tensor  # [B, K] f32 log label prob
    p1g: torch.Tensor  # [B, K] f32 log gap prob
    p2m: torch.Tensor  # [B, K] f32 log max band prob
    valid: torch.Tensor  # [B, K] bool
    parent: torch.Tensor  # [B, N + 1] i32
    label: torch.Tensor  # [B, N + 1] i32
    time: Optional[torch.Tensor]  # always None: the duplex tree has no emit times
    child: torch.Tensor  # [B, N + 2, A] i32
    blab: torch.Tensor  # [B, N + 1, W] f32 band label probs
    bgap: torch.Tensor  # [B, N + 1, W] f32 band gap probs
    boff: torch.Tensor  # [B, N + 1] i64 band offset (t2 of column 0)
    blen: torch.Tensor  # [B, N + 1] i64 band valid length
    bmax: torch.Tensor  # [B, N + 1] f32 band max total
    n_nodes: torch.Tensor  # [B] i64
    last_upper: torch.Tensor  # [B] i64
    err: torch.Tensor  # [B] i32


def _init_carry(B, K, N, A, W, init_states, device):
    is0 = (torch.arange(K, device=device) == 0).expand(B, K)
    negk = torch.full((B, K), NEG, dtype=torch.float32, device=device)
    return DuplexCarry(
        node=torch.where(is0, -1, -2).to(torch.int32),
        state=torch.where(is0, init_states.long()[:, None], 0),
        p1l=negk.clone(),
        p1g=torch.where(is0, 0.0, negk),
        p2m=torch.where(is0, 0.0, negk),
        valid=is0.clone(),
        parent=torch.full((B, N + 1), -2, dtype=torch.int32, device=device),
        label=torch.full((B, N + 1), -1, dtype=torch.int32, device=device),
        time=None,
        child=torch.full((B, N + 2, A), -1, dtype=torch.int32, device=device),
        blab=torch.full((B, N + 1, W), NEG, dtype=torch.float32, device=device),
        bgap=torch.full((B, N + 1, W), NEG, dtype=torch.float32, device=device),
        boff=torch.zeros((B, N + 1), dtype=torch.int64, device=device),
        blen=torch.zeros((B, N + 1), dtype=torch.int64, device=device),
        bmax=torch.full((B, N + 1), NEG, dtype=torch.float32, device=device),
        n_nodes=torch.zeros((B,), dtype=torch.int64, device=device),
        last_upper=torch.zeros((B,), dtype=torch.int64, device=device),
        err=torch.zeros((B,), dtype=torch.int32, device=device),
    )


def _band_get(c, root_gap, nodes, t2):
    """(label, gap) band values of ``nodes [B, K]`` at cells ``t2 [B, K, J]``;
    the virtual root (node < 0) reads the root band (offset -1, gap only,
    duplex.rs:389-409); out-of-window reads are -inf (ProbPair::zero)."""
    B, _, W = c.blab.shape
    N = c.blab.shape[1] - 1
    is_root = (nodes < 0)[..., None]
    safe = nodes.long().clamp(0, N - 1)
    off = c.boff.gather(1, safe)[..., None]
    ln = c.blen.gather(1, safe)[..., None]
    idx = t2 - off
    ok = (idx >= 0) & (idx < ln)
    K, J = nodes.shape[1], t2.shape[2]
    rows = safe[..., None].expand(B, K, W)
    cols = idx.clamp(0, W - 1)
    lab = c.blab.gather(1, rows).gather(2, cols)
    gap = c.bgap.gather(1, rows).gather(2, cols)
    lab = torch.where(ok & ~is_root, lab, NEG)
    gap = torch.where(is_root, _root_read(root_gap, t2), torch.where(ok, gap, NEG))
    return lab, gap


def _extend_bands(c, l2, root_gap, lo, hi, ext_flag, *, A, crf):
    """Band extension for live beam nodes, parents before children
    (duplex.rs:490-522 + extend_secondary_probs 338-387 / 290-336).  The beam
    in ``c`` must already be node-sorted; each node appends every cell of
    [end, hi), as the reference does (the JAX engine's static ``Wext`` bound
    never binds with its own envelope prep)."""
    add = ls_add_cr if crf else ls_add
    B, K = c.node.shape
    W = c.blab.shape[2]
    N = c.blab.shape[1] - 1
    dev = c.blab.device
    bi = torch.arange(B, device=dev)
    jidx = torch.arange(W, device=dev)
    # the tables are updated in place, slot by slot: a child reads its
    # parent's band as extended earlier in this loop
    blab, bgap, boff, blen, bmax = c.blab, c.bgap, c.boff, c.blen, c.bmax
    for s in range(K):
        n = c.node[:, s].long()
        act = ext_flag & (n >= 0) & c.valid[:, s]
        n0 = n.clamp(0, N - 1)
        off, ln = boff[bi, n0], blen[bi, n0]
        row_lab, row_gap = blab[bi, n0], bgap[bi, n0]

        # discard_until(lo - 1) + update_max(lo, hi)  (duplex.rs:350-359)
        do_discard = act & (lo > off)
        shift = (lo - 1) - off
        rolled = ((jidx[None, :] + shift[:, None]) % W).expand(B, W)
        row_lab = torch.where(do_discard[:, None], row_lab.gather(1, rolled), row_lab)
        row_gap = torch.where(do_discard[:, None], row_gap.gather(1, rolled), row_gap)
        emptied = (ln - shift) <= 0
        off2 = torch.where(do_discard, torch.where(emptied, lo, lo - 1), off)
        L2 = torch.where(do_discard, torch.where(emptied, 0, ln - shift), ln)
        t2s = off2[:, None] + jidx
        win = (jidx < L2[:, None]) & (t2s >= lo[:, None]) & (t2s < hi[:, None])
        mx = torch.where(do_discard, _nan_clean_max(add(row_lab, row_gap), win), bmax[bi, n0])

        # append cells [end, hi) reading the parent's (updated) band
        par = c.parent[bi, n0].long()
        lbl = c.label[bi, n0].long()
        par_lbl = torch.where(par >= 0, c.label[bi, par.clamp(0, N - 1)].long(), -1)
        # the CRF extension recurrence has no repeat branch (duplex.rs:323-328)
        prep = (par_lbl == lbl) if not crf else torch.zeros_like(act)
        st = c.state[:, s]
        cur_end = off2 + L2
        n_new = torch.where(act, (hi - cur_end).clamp_min(0), 0)
        last_col = (L2 - 1).clamp(0, W - 1)[:, None]
        last_lab = torch.where(L2 > 0, row_lab.gather(1, last_col)[:, 0], NEG)
        last_gap = torch.where(L2 > 0, row_gap.gather(1, last_col)[:, 0], NEG)
        lab_idx = lbl.clamp(0, A - 1)[:, None] + 1
        for j in range(int(n_new.max()) if B else 0):  # the longest catch-up
            a = j < n_new
            t2 = cur_end + j
            r = _l2_rows(l2, t2, st, crf)
            gap_n = add(last_lab, last_gap) + r[:, 0]
            pvl, pvg = _band_get(c, root_gap, par[:, None], (t2 - 1)[:, None, None])
            pvl, pvg = pvl[:, 0, 0], pvg[:, 0, 0]
            base = torch.where(prep, pvg, add(pvl, pvg))
            lab_n = r.gather(1, lab_idx)[:, 0] + add(last_lab, base)
            widx = (t2 - off2).clamp(0, W - 1)[:, None]
            row_lab = row_lab.scatter(1, widx, torch.where(a, lab_n, row_lab.gather(1, widx)[:, 0])[:, None])
            row_gap = row_gap.scatter(1, widx, torch.where(a, gap_n, row_gap.gather(1, widx)[:, 0])[:, None])
            mx = torch.where(a, ls_max(mx, add(lab_n, gap_n)), mx)
            last_lab = torch.where(a, lab_n, last_lab)
            last_gap = torch.where(a, gap_n, last_gap)

        wrow = torch.where(act, n0, N)  # row N takes the dropped writes
        blab.index_put_((bi, wrow), row_lab)
        bgap.index_put_((bi, wrow), row_gap)
        boff.index_put_((bi, wrow), off2)
        blen.index_put_((bi, wrow), torch.maximum(L2, hi - off2))
        bmax.index_put_((bi, wrow), mx)
    return c


def _build_bands(c, l2, root_gap, lo, hi, wc, is_rep, crf):
    """build_secondary_probs (duplex.rs:212-249 / 251-288) for all [K, A]
    candidate children of a step, cell by cell over [lo, lo + wc).
    Returns (lab, gap [B, K, A, wc]; max [B, K, A] over [lo, hi))."""
    add = ls_add_cr if crf else ls_add
    B, K = c.node.shape
    A = is_rep.shape[2]
    dev = c.blab.device
    j = torch.arange(wc, device=dev)
    t2 = (lo[:, None] + j)[:, None, :].expand(B, K, wc)
    pv_lab, pv_gap = _band_get(c, root_gap, c.node, t2 - 1)
    pv_tot = add(pv_lab, pv_gap)
    base = torch.where(is_rep[..., None], pv_gap[:, :, None], pv_tot[:, :, None])  # [B, K, A, wc]
    if crf:
        rows = _l2_rows(l2, t2, c.state[..., None].expand(B, K, wc), True)
    else:
        rows = _l2_rows(l2, t2[:, :1], None, False)  # [B, 1, wc, A+1]
    cmask = (j < (hi - lo)[:, None])[:, None, None, :]
    lab = torch.full((B, K, A, wc), NEG, dtype=torch.float32, device=dev)
    gap = torch.full((B, K, A, wc), NEG, dtype=torch.float32, device=dev)
    tot = torch.full((B, K, A, wc), NEG, dtype=torch.float32, device=dev)
    last_lab = torch.full((B, K, A), NEG, dtype=torch.float32, device=dev)
    last_tot = last_lab
    for i in range(wc):
        r = rows[:, :, i]
        gap[..., i] = last_tot + r[..., :1]
        lab[..., i] = r[..., 1:] + add(last_lab, base[..., i])
        tot[..., i] = add(lab[..., i], gap[..., i])
        last_lab, last_tot = lab[..., i], tot[..., i]
    if wc == 0:
        return lab, gap, torch.full((B, K, A), NEG, dtype=torch.float32, device=dev)
    return lab, gap, _nan_clean_max(tot, cmask)


def _sort_beam_by_node(c):
    """Node-ascending beam order (invalid slots last), the reference's
    in-place sort before extension (duplex.rs:493)."""
    key = torch.where(c.valid, c.node, _I32_MAX)
    order = torch.argsort(key, dim=1, stable=True)
    g = lambda x: x.gather(1, order)  # noqa: E731
    return c._replace(node=g(c.node), state=g(c.state), p1l=g(c.p1l), p1g=g(c.p1g),
                      p2m=g(c.p2m), valid=g(c.valid))


def _merge_select(node, lv, gv, p2m, state, valid, bmax, K, add=ls_add):
    """Top-K selection over the merged, duplicate-free candidate plane
    [B, C]: prob_2_max refreshes from the tree for real nodes
    (duplex.rs:613-618), then K rounds of (max score, tie -> min node id);
    ``add`` is the engine's logsumexp."""
    N = bmax.shape[1] - 1
    is_node = node >= 0
    p2m_r = torch.where(valid & is_node, bmax.gather(1, node.long().clamp(0, N - 1)), p2m)
    score = add(lv, gv) + p2m_r
    cnt = valid.sum(1)
    nan_flag = (cnt >= 2) & (valid & score.isnan()).any(1)
    empty_flag = cnt == 0
    inf = torch.tensor(float("inf"), device=node.device)
    key = torch.where(
        valid,
        torch.where(score.isnan(), inf, torch.where(score == NEG, _NEG_VALID, score + 0.0)),
        NEG,
    )
    sel = {f: [] for f in ("node", "lab", "gap", "p2m", "state", "ok")}
    for _ in range(K):
        mx = key.amax(1, keepdim=True)
        ok = mx[:, 0] > NEG
        at = key == mx
        sid = torch.where(at, node, _I32_MAX).amin(1, keepdim=True)
        chosen = at & (node == sid)
        lane = chosen.to(torch.int32).argmax(1, keepdim=True)
        sel["node"].append(torch.where(ok, sid[:, 0], -2))
        sel["lab"].append(lv.gather(1, lane)[:, 0])
        sel["gap"].append(gv.gather(1, lane)[:, 0])
        sel["p2m"].append(p2m_r.gather(1, lane)[:, 0])
        sel["state"].append(state.gather(1, lane)[:, 0])
        sel["ok"].append(ok)
        key = key.masked_fill(chosen, NEG)
    out = [torch.stack(sel[f], 1) for f in ("node", "lab", "gap", "p2m", "state", "ok")]
    return (*out, nan_flag, empty_flag)


def _step(c, t, l1t, l2, root_gap, lo, hi, wc, lengths, thr, *, A, K, N, collapse, crf,
          needs_ext):
    """One network_1 step of the tree engine for every pair."""
    add = ls_add_cr if crf else ls_add
    B = c.node.shape[0]
    dev = l2.device
    in_range = t < lengths
    env_bad = in_range & ((lo >= hi) | (lo > c.last_upper))
    alive = c.err == errors.OK
    active = alive & in_range & ~env_bad
    c = c._replace(err=torch.where(alive & env_bad, errors.INVALID_ENVELOPE, c.err).to(torch.int32))

    ext_flag = active & (hi > c.last_upper)
    if needs_ext:
        # the reference node-sorts the beam in place before extension, so the
        # expansion order changes on exactly those steps (duplex.rs:493)
        srt = _sort_beam_by_node(c)
        f = ext_flag[:, None]
        c = c._replace(**{k: torch.where(f, getattr(srt, k), getattr(c, k))
                          for k in ("node", "state", "p1l", "p1g", "p2m", "valid")})
        c = _extend_bands(c, l2, root_gap, lo, hi, ext_flag, A=A, crf=crf)
    c = c._replace(last_upper=torch.where(active, hi, c.last_upper))

    # ---------------- expansion ----------------
    if crf:
        prow = l1t.gather(1, c.state.clamp(0, l1t.shape[1] - 1)[..., None].expand(B, K, A + 1))
    else:
        prow = l1t[:, None, :]
    p0, plab = prow[..., 0], prow[..., 1:]
    node64 = c.node.long()
    tip_label = torch.where(node64 >= 0, c.label.gather(1, node64.clamp_min(0)).long(), -1)
    ch = c.child.gather(1, (node64 + 1).clamp(0, N)[..., None].expand(B, K, A))
    lbl = torch.arange(A, device=dev)
    if collapse and not crf:
        is_rep = tip_label[..., None] == lbl
    else:
        is_rep = torch.zeros((B, K, A), dtype=torch.bool, device=dev)
    pushed_lab = c.valid[..., None] & ~(plab < thr)
    gap_pos = c.p1g > NEG
    needs_new = pushed_lab & (ch < 0) & (~is_rep | gap_pos[..., None])
    new_id, parent, label, _, child, n_nodes, overflow = _allocate_nodes(c, needs_new, t, active, N)
    nid = torch.where(ch >= 0, ch, new_id)

    # build bands for every candidate child; store only the allocated ones
    lab_c, gap_c, bmax_c = _build_bands(c, l2, root_gap, lo, hi, wc, is_rep, crf)
    W = c.blab.shape[2]
    flat = torch.where((new_id >= 0) & active[:, None, None], new_id.long(), N).reshape(B, K * A)
    bi = torch.arange(B, device=dev)[:, None]
    pad = W - wc
    # in place: a copy per step would move the band tables through memory T1 times
    c.blab.index_put_((bi, flat), torch.nn.functional.pad(lab_c, (0, pad), value=NEG).reshape(B, K * A, W))
    c.bgap.index_put_((bi, flat), torch.nn.functional.pad(gap_c, (0, pad), value=NEG).reshape(B, K * A, W))
    c.boff.index_put_((bi, flat), lo[:, None].expand(B, K * A))
    c.blen.index_put_((bi, flat), (hi - lo)[:, None].expand(B, K * A))
    c.bmax.index_put_((bi, flat), bmax_c.reshape(B, K * A))

    # ---- analytic merge (duplex.rs:530-618): a node receives at most its
    # blank, its stay (collapsed repeat) and ONE nid-targeted mass ----
    p1tot = add(c.p1l, c.p1g)
    push_b = c.valid & (p0 > thr)
    g_tip = torch.where(push_b, p1tot + p0, NEG)
    push_nid = pushed_lab & (nid >= 0)
    if crf:
        m_nid = p1tot[..., None] + plab
        stay_l = torch.full((B, K), NEG, device=dev)
        stay_any = torch.zeros((B, K), dtype=torch.bool, device=dev)
        state_f = ((c.state[..., None] * A) % l1t.shape[1] + lbl).reshape(B, K * A)
    else:
        m_nid = torch.where(is_rep, c.p1g[..., None] + plab, p1tot[..., None] + plab)
        push_stay = pushed_lab & is_rep
        stay_l = torch.where(push_stay, c.p1l[..., None] + plab, NEG).amax(2)
        stay_any = push_stay.any(2)
        state_f = torch.zeros((B, K * A), dtype=torch.int64, device=dev)
    tgt = torch.where(push_nid, nid, -9)
    eq = (tgt[:, None] == c.node[:, :, None, None]) & c.valid[:, :, None, None]  # [B, Kj, K, A]
    recv = torch.where(eq, m_nid[:, None], NEG).amax(3).amax(2)
    recv_any = eq.any(3).any(2)
    matched = eq.any(1)
    l_tip = add(stay_l, recv)
    tip_valid = push_b | stay_any | recv_any

    node_n, l_n, g_n, p2_n, st_n, valid_n, nan_flag, empty_flag = _merge_select(
        torch.cat([c.node, nid.reshape(B, K * A)], 1),
        torch.cat([l_tip, m_nid.reshape(B, K * A)], 1),
        torch.cat([g_tip, torch.full((B, K * A), NEG, device=dev)], 1),
        torch.cat([c.p2m, torch.full((B, K * A), NEG, device=dev)], 1),
        torch.cat([c.state, state_f], 1),
        torch.cat([tip_valid, (push_nid & ~matched).reshape(B, K * A)], 1),
        c.bmax, K, add,
    )
    step_err = torch.where(
        overflow, errors.NODE_OVERFLOW,
        torch.where(nan_flag, errors.INCOMPARABLE_VALUES,
                    torch.where(empty_flag, errors.RAN_OUT_OF_BEAM, errors.OK)),
    )
    err = torch.where(c.err > 0, c.err, torch.where(active, step_err, errors.OK)).to(torch.int32)
    a = active[:, None]
    return c._replace(
        node=torch.where(a, torch.where(valid_n, node_n, -2), c.node).to(torch.int32),
        state=torch.where(a, st_n, c.state),
        p1l=torch.where(a, torch.where(valid_n, l_n, NEG), c.p1l),
        p1g=torch.where(a, torch.where(valid_n, g_n, NEG), c.p1g),
        p2m=torch.where(a, torch.where(valid_n, p2_n, NEG), c.p2m),
        valid=torch.where(a, valid_n, c.valid),
        parent=parent, label=label, child=child, n_nodes=n_nodes, err=err,
    )


def duplex_exact_batch(
    l1, l2, root_gap, lo, hi, threshold_log, init_states, lengths, *,
    beam_size: int, collapse_repeats: bool, max_nodes: int, W: int, needs_ext: bool,
    crf: bool,
):
    """Band-reuse duplex decode of a batch of read pairs (one device).

    Inputs as ``duplex_fast.duplex_fast_batch``; ``max_nodes`` is the per-pair
    tree budget, ``W`` the band width and ``needs_ext`` enables extension
    (``_prep_envelope``).  Returns dict:
    labels_rev [B, T1], count [B], err [B]; all int32 — the JAX package's
    ``duplex_exact_batch`` contract, bit for bit.
    """
    B, T1, T2, S, A = check_pair_batch(
        l1, l2, root_gap, lo, hi, init_states, lengths, beam_size=beam_size, crf=crf
    )
    K, N, W = int(beam_size), int(max_nodes), int(W)
    if not 1 <= N < _I32_MAX:
        raise ValueError(f"max_nodes must be in [1, 2**31 - 1), got {N}")
    if W < 1:
        raise ValueError(f"W must be >= 1, got {W}")
    dev = l1.device
    thr = torch.tensor(float(np.float32(threshold_log)), dtype=torch.float32, device=dev)
    lo64, hi64 = lo.long(), hi.long()
    span = (hi64 - lo64).clamp(0, W)
    span = torch.where(torch.arange(T1, device=dev)[None, :] < lengths[:, None].long(), span, 0)
    wcs = span.amax(0).tolist() if B else [0] * T1
    c = _init_carry(B, K, N, A, W, init_states, dev)
    for t in range(T1):
        c = _step(
            c, t, l1[:, t], l2, root_gap, lo64[:, t], hi64[:, t], int(wcs[t]), lengths, thr,
            A=A, K=K, N=N, collapse=bool(collapse_repeats), crf=bool(crf),
            needs_ext=bool(needs_ext),
        )
    labels_rev, _, count = _traceback(c.node[:, 0], c.parent, c.label, c.label, T1)
    return {"labels_rev": labels_rev, "count": count, "err": c.err}


# ------------------------------------------------------------- host helpers


def _prep_envelope(envelope: np.ndarray, T2: int):
    """(lo, hi, W, Wr, needs_ext) of the tree engine, as the JAX package's
    ``_prep_envelope``: W from the slot engine's replay, extension whenever
    the upper bound grows at all."""
    ep = _prep_envelope_fast(envelope, T2)
    return ep.lo, ep.hi, ep.W, ep.Wr, bool(np.any(ep.hi[1:] > ep.hi[:-1]))


def _duplex_max_nodes(T1, K, A, W, cap_bytes=2_000_000_000):
    """Default tree budget: the worst case T1*K*A + 8, capped so one pair's
    band tables stay near ``cap_bytes`` (the JAX package's default)."""
    worst = T1 * K * A + 8
    by_mem = max(cap_bytes // max(W * 8, 1), 1024)
    return int(min(worst, by_mem))
