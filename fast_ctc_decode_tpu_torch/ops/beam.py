"""CTC prefix beam search with a flattened suffix tree: the exact engine.

Port of ``fast_ctc_decode_tpu/ops/beam.py``, batched over reads with a
Python loop over time.  It is the CPU path of ``engine="exact"`` and the
plain version that ``csrc/exact_beam_kernel.cu`` (``ops/beam_exact_cuda.py``)
is checked against bit for bit.

Reference semantics: src/search.rs:159-301 (``beam_search``) of the
reference.  Every read keeps a beam of K tips (node, state, label_prob,
gap_prob) over its own suffix tree, in linear f32 probability space with a
per-step division by the top score:

 - **Tree tables** per read: ``parent/label/time [B, N]`` and a dense child
   table ``child [B, N+1, A]`` (row ``node+1``, so the root -1 is row 0),
   each with one more column / row that takes the writes of candidates
   that allocate nothing, so every step is one scatter.
   Node ids come from a per-read counter in the reference's ``add_node``
   order (tip-major, labels ascending), so ids, emit times and tie-breaks
   match the reference.  A read that needs more than N nodes stops with
   NODE_OVERFLOW.
 - **Analytic merge**: a node receives at most its blank, its stay (on a
   collapsed repeat) and one arrival per step, so the candidate plane of
   K tips + K*A extensions is duplicate-free without a sort.
 - **Selection**: K rounds of (max total, tie -> min node id); the NaN key
   maps to +inf and every key adds +0.0; renormalisation is true division.

Padded frames (``t >= length``) and frames after an error leave a read
unchanged.  The tables are initialised here (this is the plain version);
the CUDA kernel leaves them uninitialised and validates child lookups.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import errors

ROOT = -1
EMPTY = -2
_I32_MAX = 2**31 - 1


class TreeCarry(NamedTuple):
    node: torch.Tensor  # [B, K] i32 tip node; -1 root, -2 empty slot
    state: torch.Tensor  # [B, K] i64 CRF transition state (0 for plain CTC)
    lab: torch.Tensor  # [B, K] f32 label_prob
    gap: torch.Tensor  # [B, K] f32 gap_prob
    valid: torch.Tensor  # [B, K] bool
    parent: torch.Tensor  # [B, N + 1] i32; column N takes dropped writes
    label: torch.Tensor  # [B, N + 1] i32
    time: torch.Tensor  # [B, N + 1] i32
    child: torch.Tensor  # [B, N + 2, A] i32, -1 = none; row N + 1 takes drops
    n_nodes: torch.Tensor  # [B] i64
    err: torch.Tensor  # [B] i32, first error code (0 = OK)


def default_max_nodes(T: int, beam_size: int, n_labels: int, cap: int = 4_000_000) -> int:
    """Worst-case node budget: every step can allocate at most beam*A nodes
    (one per (tip, label) miss, src/search.rs:229-239)."""
    return int(min(T * beam_size * n_labels + 8, cap))


def _init_carry(B, K, N, A, init_lab, init_gap, init_state, device):
    """Root alone in slot 0 of every read; ``init_*`` are [B] tensors."""
    is0 = (torch.arange(K, device=device) == 0).expand(B, K)
    return TreeCarry(
        node=torch.where(is0, ROOT, EMPTY).to(torch.int32),
        state=torch.where(is0, init_state.to(torch.int64)[:, None], 0),
        lab=torch.where(is0, init_lab[:, None], 0.0).to(torch.float32),
        gap=torch.where(is0, init_gap[:, None], 0.0).to(torch.float32),
        valid=is0.clone(),
        parent=torch.full((B, N + 1), -2, dtype=torch.int32, device=device),
        label=torch.full((B, N + 1), -1, dtype=torch.int32, device=device),
        time=torch.full((B, N + 1), -1, dtype=torch.int32, device=device),
        child=torch.full((B, N + 2, A), -1, dtype=torch.int32, device=device),
        n_nodes=torch.zeros((B,), dtype=torch.int64, device=device),
        err=torch.zeros((B,), dtype=torch.int32, device=device),
    )


def _child_lookup(carry, N):
    """Existing children of every tip: [B, K, A] i32 (-1 = none)."""
    B, K = carry.node.shape
    A = carry.child.shape[2]
    rows = (carry.node.long() + 1).clamp(0, N)
    return carry.child.gather(1, rows[:, :, None].expand(B, K, A))


def _allocate_nodes(carry, needs_new, t, active, N):
    """Allocate tree nodes for ``needs_new [B, K, A]`` (child-table misses)
    in reference add_node order (tip-major, labels ascending).

    Returns (new_id [B, K, A] i32, -1 where nothing was made; the updated
    parent/label/time/child/n_nodes; overflow [B]).  ``carry.time`` may be
    None (the duplex tree carries no emit times).  Writes that do not
    allocate go to the dump column N / dump row N + 1.  The tables are
    updated in place (a copy per step would move the whole tree through
    memory T times).
    """
    B, K, A = needs_new.shape
    dev = needs_new.device
    flat = (needs_new & active[:, None, None]).reshape(B, K * A)
    flat_i = flat.to(torch.int64)
    ranks = torch.cumsum(flat_i, 1) - flat_i
    total_new = flat_i.sum(1)
    new_id_flat = carry.n_nodes[:, None] + ranks  # [B, K*A] i64
    overflow = active & (carry.n_nodes + total_new > N)
    upd_ok = flat & (new_id_flat < N)
    new_id = torch.where(upd_ok, new_id_flat, -1).to(torch.int32).reshape(B, K, A)

    tip_flat = carry.node[:, :, None].expand(B, K, A).reshape(B, K * A)
    lbl_flat = torch.arange(A, dtype=torch.int32, device=dev).repeat(K).expand(B, K * A)
    idx = torch.where(upd_ok, new_id_flat, N)
    parent = carry.parent.scatter_(1, idx, tip_flat)
    label = carry.label.scatter_(1, idx, lbl_flat.contiguous())
    time = carry.time
    if time is not None:  # the duplex tree records no emit times
        time = time.scatter_(1, idx, torch.full_like(tip_flat, t))
    crow = torch.where(upd_ok, tip_flat.long() + 1, N + 1)
    carry.child.view(B, (N + 2) * A).scatter_(
        1, crow * A + lbl_flat.long(), new_id_flat.to(torch.int32)
    )
    child = carry.child
    n_nodes = torch.where(
        active, torch.clamp_max(carry.n_nodes + total_new, N), carry.n_nodes
    )
    return new_id, parent, label, time, child, n_nodes, overflow


def _merge_select(node, lab, gap, state, valid, K):
    """Top-K of an already-merged, duplicate-free candidate plane [B, C].

    K rounds of (max total, tie -> min node id), the reference's post-merge
    order (src/search.rs:261-273).  Returns (node, lab, gap, state, valid,
    nan_flag, empty_flag, top) with ``top`` the best raw total.  Picked
    values add +0.0, as the JAX engine's masked sums do.
    """
    total = lab + gap
    cnt = valid.sum(1)
    # IncomparableValues only when a NaN is compared: >= 2 merged entries
    nan_flag = (cnt >= 2) & (valid & total.isnan()).any(1)
    empty_flag = cnt == 0
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=node.device)
    key = torch.where(valid, torch.where(total.isnan(), inf, total + 0.0), -inf)

    sel = {f: [] for f in ("node", "lab", "gap", "state", "ok")}
    top = None
    for _ in range(K):
        mx = key.amax(1, keepdim=True)
        ok = mx[:, 0] > -inf
        at = key == mx
        sid = torch.where(at, node, _I32_MAX).amin(1, keepdim=True)
        chosen = at & (node == sid)
        lane = chosen.to(torch.int32).argmax(1, keepdim=True)

        def pick(x):
            return x.gather(1, lane)[:, 0]

        if top is None:
            top = pick(total) + 0.0
        sel["node"].append(torch.where(ok, sid[:, 0], EMPTY))
        sel["lab"].append(pick(lab) + 0.0)
        sel["gap"].append(pick(gap) + 0.0)
        sel["state"].append(pick(state))
        sel["ok"].append(ok)
        key = key.masked_fill(chosen, -inf)
    out = [torch.stack(sel[f], 1) for f in ("node", "lab", "gap", "state", "ok")]
    return (*out, nan_flag, empty_flag, top)


def _finish_step(carry, merged, overflow, active):
    """Renormalise, fold in the status code and gate on ``active``.

    Returns (node, state, lab, gap, valid, err)."""
    node_n, lab_n, gap_n, state_n, valid_n, nan_flag, empty_flag, top = merged
    top = top[:, None]
    # true division: a reciprocal-multiply rounds differently
    lab_n = torch.where(valid_n, lab_n / top, 0.0)
    gap_n = torch.where(valid_n, gap_n / top, 0.0)
    node_n = torch.where(valid_n, node_n, EMPTY).to(torch.int32)

    # error priority within a step: overflow > NaN > empty beam
    step_err = torch.where(
        overflow,
        errors.NODE_OVERFLOW,
        torch.where(
            nan_flag,
            errors.INCOMPARABLE_VALUES,
            torch.where(empty_flag, errors.RAN_OUT_OF_BEAM, errors.OK),
        ),
    )
    err = torch.where(
        carry.err > 0, carry.err, torch.where(active, step_err, errors.OK)
    ).to(torch.int32)
    act = active[:, None]
    return (
        torch.where(act, node_n, carry.node),
        torch.where(act, state_n, carry.state),
        torch.where(act, lab_n, carry.lab),
        torch.where(act, gap_n, carry.gap),
        torch.where(act, valid_n, carry.valid),
        err,
    )


def _tip_match(nid, push_nid, m_nid, node, valid):
    """Route extensions that land on a current tip into that tip's row.

    Returns (recv [B, K], recv_any [B, K], matched [B, K, A])."""
    tgt = torch.where(push_nid, nid, -9)  # nid >= 0, so -9 never matches
    eq = (tgt[:, None] == node[:, :, None, None]) & valid[:, :, None, None]
    recv = torch.where(eq, m_nid[:, None], 0.0).sum(dim=(2, 3))
    return recv, eq.flatten(2).any(2), eq.any(1)


def _beam_step(carry, p, t, *, N, collapse, lengths, threshold):
    """One step of plain-CTC prefix beam search (src/search.rs:178-283)."""
    B, K = carry.node.shape
    A = p.shape[1] - 1
    dev = p.device
    active = (t < lengths) & (carry.err == errors.OK)
    p0 = p[:, 0]
    plab = p[:, None, 1:]  # [B, 1, A]

    tip_label = torch.where(
        carry.node >= 0, carry.label.gather(1, carry.node.long().clamp_min(0)), -1
    )
    c = _child_lookup(carry, N)
    lbl = torch.arange(A, dtype=torch.int32, device=dev)
    if collapse:
        is_rep = tip_label[:, :, None] == lbl
    else:
        is_rep = torch.zeros((B, K, A), dtype=torch.bool, device=dev)
    # NaN passes the label check and fails the blank check (src/search.rs:
    # 191, 201-203)
    pushed_lab = carry.valid[:, :, None] & ~(plab < threshold)
    gap_pos = carry.gap > 0
    needs_new = pushed_lab & (c < 0) & (~is_rep | gap_pos[:, :, None])

    new_id, parent, label, time, child, n_nodes, overflow = _allocate_nodes(
        carry, needs_new, t, active, N
    )
    nid = torch.where(c >= 0, c, new_id)

    lg = carry.lab + carry.gap
    push_b = carry.valid & (p0[:, None] > threshold)
    gap_tip = torch.where(push_b, lg * p0[:, None], 0.0)
    # fork of a collapsed repeat keeps only the gap mass; arrivals take lg
    m_nid = torch.where(is_rep, carry.gap[:, :, None], lg[:, :, None]) * plab
    push_nid = pushed_lab & (nid >= 0)
    push_stay = pushed_lab & is_rep  # at most one label per tip
    stay_sum = torch.where(push_stay, carry.lab[:, :, None] * plab, 0.0).sum(2)

    recv, recv_any, matched = _tip_match(nid, push_nid, m_nid, carry.node, carry.valid)
    lab_tip = stay_sum + recv
    tip_valid = push_b | push_stay.any(2) | recv_any

    merged = _merge_select(
        torch.cat([carry.node, nid.flatten(1)], 1),
        torch.cat([lab_tip, m_nid.flatten(1)], 1),
        torch.cat([gap_tip, torch.zeros((B, K * A), dtype=torch.float32, device=dev)], 1),
        torch.zeros((B, K + K * A), dtype=torch.int64, device=dev),
        torch.cat([tip_valid, (push_nid & ~matched).flatten(1)], 1),
        K,
    )
    node_n, state_n, lab_n, gap_n, valid_n, err = _finish_step(
        carry, merged, overflow, active
    )
    return TreeCarry(
        node_n, state_n, lab_n, gap_n, valid_n, parent, label, time, child, n_nodes, err
    )


def _traceback(node0, parent, label, time, T):
    """Walk parent pointers root-ward from [B] final nodes.

    Returns (labels_rev [B, T], times_rev [B, T], count [B]), deepest first
    and -1 padded.  A chain never exceeds T nodes (a child is allocated at a
    later step than its parent), so T rounds are enough."""
    B = node0.shape[0]
    dev = node0.device
    labs = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    times = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    cur = node0.to(torch.int32)
    for i in range(T):
        ok = cur >= 0
        safe = cur.long().clamp_min(0)[:, None]
        labs[:, i] = torch.where(ok, label.gather(1, safe)[:, 0], -1)
        times[:, i] = torch.where(ok, time.gather(1, safe)[:, 0], -1)
        cur = torch.where(ok, parent.gather(1, safe)[:, 0], EMPTY)
    return labs, times, (labs >= 0).sum(1, dtype=torch.int32)


def check_batch(probs, lengths, beam_size, max_nodes, crf=False):
    """Validate a [B, T, A+1] (CRF: [B, T, S, A+1]) f32 batch and its
    configuration; returns the [B] i32 lengths on ``probs``' device."""
    want = 4 if crf else 3
    if not isinstance(probs, torch.Tensor) or probs.dtype != torch.float32:
        raise TypeError("probs must be a float32 torch.Tensor")
    if probs.dim() != want or probs.shape[-1] < 2:
        raise ValueError(
            f"probs must be {'[B, T, S, A+1]' if crf else '[B, T, A+1]'} with A >= 1, "
            f"got {tuple(probs.shape)}"
        )
    if int(beam_size) < 1:
        raise ValueError("beam_size must be >= 1")
    if not 1 <= int(max_nodes) < _I32_MAX:
        raise ValueError(f"max_nodes must be in [1, 2**31 - 1), got {max_nodes}")
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=probs.device)
    if lengths.shape != (probs.shape[0],):
        raise ValueError(f"lengths must be [B], got {tuple(lengths.shape)}")
    return lengths


def beam_search_device_batch(
    probs: torch.Tensor,
    lengths,
    beam_cut_threshold,
    *,
    beam_size: int,
    collapse_repeats: bool = True,
    max_nodes: int,
):
    """Exact-engine decode of a padded [B, T, A+1] f32 batch + [B] lengths.

    Returns dict: labels_rev [B, T] (0-based labels, deepest first),
    times_rev [B, T] (the frame each node was created at), count [B],
    err [B]; all int32 — ``fast_ctc_decode_tpu.ops.beam
    .beam_search_device_batch``'s contract.
    """
    lengths = check_batch(probs, lengths, beam_size, max_nodes)
    B, T, A1 = probs.shape
    K, N = int(beam_size), int(max_nodes)
    dev = probs.device
    thr = torch.tensor(float(np.float32(beam_cut_threshold)), dtype=torch.float32, device=dev)
    carry = _init_carry(
        B, K, N, A1 - 1,
        torch.zeros((B,), dtype=torch.float32, device=dev),
        torch.ones((B,), dtype=torch.float32, device=dev),
        torch.zeros((B,), dtype=torch.int64, device=dev),
        dev,
    )
    for t in range(T):
        carry = _beam_step(
            carry, probs[:, t], t, N=N, collapse=bool(collapse_repeats),
            lengths=lengths, threshold=thr,
        )
    labels_rev, times_rev, count = _traceback(
        carry.node[:, 0], carry.parent, carry.label, carry.time, T
    )
    return {"labels_rev": labels_rev, "times_rev": times_rev, "count": count, "err": carry.err}
