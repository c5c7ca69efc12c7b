"""CRF (conditional random field) decoders: greedy and exact prefix beam search.

Port of ``fast_ctc_decode_tpu/ops/crf.py``, batched over reads.  Reference
semantics: src/search.rs:385-423 (``crf_greedy_search``) and src/search.rs:
38-157 (``crf_beam_search``) of the reference.  Input is ``[B, T, S, A+1]``
(S transition states, blank first) plus ``init_states [B, Si]``.  Each
hypothesis carries a transition state; a blank keeps it, emitting label
``l`` (0-based) moves it to ``(state * A) % S + l`` (src/search.rs:97, 414).

The beam reuses the tree machinery of ``ops/beam.py``.  There is no
repeat-collapse branch, so a node receives at most two candidates per step
(blank + the unique arrival).  ``crf_beam_search_device_batch`` is the CPU
path of the exact CRF engine and the plain version of the CRF instance of
``csrc/exact_beam_kernel.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors
from .beam import (
    TreeCarry,
    _allocate_nodes,
    _child_lookup,
    _finish_step,
    _init_carry,
    _merge_select,
    _tip_match,
    _traceback,
    check_batch,
)
from .phred import phred_int


def init_beam(init_states: torch.Tensor):
    """The initial beam entry of every read (src/search.rs:54-59):
    ``(label_prob = max(init), gap_prob = init[0], state = argmax(init))``.
    A NaN counts as the maximum and the first maximum wins, as in
    ``jnp.max``/``jnp.argmax``."""
    return init_states.amax(1), init_states[:, 0], init_states.argmax(1)


def check_init(init_states, B, device):
    """Validate [B, Si] f32 init states on ``device``."""
    if not isinstance(init_states, torch.Tensor) or init_states.dtype != torch.float32:
        raise TypeError("init_states must be a float32 torch.Tensor")
    if init_states.dim() != 2 or init_states.shape[0] != B or init_states.shape[1] < 1:
        raise ValueError(f"init_states must be [B, Si] with Si >= 1, got {tuple(init_states.shape)}")
    if init_states.device != device:
        raise ValueError(f"init_states is on {init_states.device}, expected {device}")


def crf_greedy_batch(probs, init_states, lengths, qscale, qbias):
    """Greedy CRF decode of a padded [B, T, S, A+1] batch.

    Returns a dict of fixed-width tensors, each read's row as
    ``fast_ctc_decode_tpu.ops.crf.crf_greedy_device`` gives it:
    tokens [B, T] i32 (1-based label rows, front-packed; rows past ``n``
    repeat frame 0's label), path [B, T] i32, qints [B, T] i64, pvals
    [B, T] f32 and n [B] i32.
    """
    B, T, S, A1 = probs.shape
    dev = probs.device
    n_base = A1 - 1
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    state = init_states.argmax(1)
    labels = torch.empty((B, T), dtype=torch.int32, device=dev)
    pvals = torch.empty((B, T), dtype=torch.float32, device=dev)
    emit = torch.empty((B, T), dtype=torch.bool, device=dev)
    for t in range(T):
        inside = (state >= 0) & (state < S)
        row = probs[:, t].gather(
            1, state.clamp(0, S - 1)[:, None, None].expand(B, 1, A1)
        )[:, 0]
        # an out-of-range state reads a NaN row, as jnp.take's fill mode does
        row = torch.where(inside[:, None], row, float("nan"))
        lab = row.argmax(1)
        labels[:, t] = lab.to(torch.int32)
        pvals[:, t] = row.amax(1)
        e = (t < lengths) & (lab > 0)
        emit[:, t] = e
        state = torch.where(e, (state * n_base) % S + (lab - 1), state)

    n = emit.sum(1, dtype=torch.int32)
    frame = torch.arange(T, dtype=torch.int32, device=dev)
    slot = torch.where(emit, torch.cumsum(emit.to(torch.int32), 1) - 1, T).long()
    path = torch.zeros((B, T + 1), dtype=torch.int32, device=dev)
    path.scatter_(1, slot, frame.expand(B, T).contiguous())
    path = path[:, :T].contiguous()
    tokens = labels.gather(1, path.long())
    emit_pvals = pvals.gather(1, path.long())
    return {
        "tokens": tokens,
        "path": path,
        "qints": phred_int(emit_pvals, qscale, qbias),
        "pvals": emit_pvals,
        "n": n,
    }


def _crf_beam_step(carry, p, t, *, N, lengths, threshold):
    """One step of CRF prefix beam search (src/search.rs:62-142) for every
    read; ``p`` is the [B, S, A+1] frame."""
    B, K = carry.node.shape
    S, A1 = p.shape[1], p.shape[2]
    A = A1 - 1
    dev = p.device
    active = (t < lengths) & (carry.err == errors.OK)

    # each tip's row probs[b, t, state_k, :] (an indexed load, no +0.0)
    rows = carry.state.clamp(0, S - 1)[:, :, None].expand(B, K, A1)
    prow = p.gather(1, rows)  # [B, K, A+1]
    p0 = prow[:, :, 0]
    plab = prow[:, :, 1:]

    c = _child_lookup(carry, N)
    pushed_lab = carry.valid[:, :, None] & ~(plab < threshold)
    needs_new = pushed_lab & (c < 0)
    new_id, parent, label, time, child, n_nodes, overflow = _allocate_nodes(
        carry, needs_new, t, active, N
    )
    nid = torch.where(c >= 0, c, new_id)

    lg = carry.lab + carry.gap
    push_b = carry.valid & (p0 > threshold)
    gap_tip = torch.where(push_b, lg * p0, 0.0)
    m_arr = lg[:, :, None] * plab
    push_arr = pushed_lab & (nid >= 0)
    lbl = torch.arange(A, dtype=torch.int64, device=dev)
    state_l = (carry.state[:, :, None] * A) % S + lbl

    recv, recv_any, matched = _tip_match(nid, push_arr, m_arr, carry.node, carry.valid)
    tip_valid = push_b | recv_any

    merged = _merge_select(
        torch.cat([carry.node, nid.flatten(1)], 1),
        torch.cat([recv, m_arr.flatten(1)], 1),
        torch.cat([gap_tip, torch.zeros((B, K * A), dtype=torch.float32, device=dev)], 1),
        torch.cat([carry.state, state_l.flatten(1)], 1),
        torch.cat([tip_valid, (push_arr & ~matched).flatten(1)], 1),
        K,
    )
    node_n, state_n, lab_n, gap_n, valid_n, err = _finish_step(
        carry, merged, overflow, active
    )
    return TreeCarry(
        node_n, state_n, lab_n, gap_n, valid_n, parent, label, time, child, n_nodes, err
    )


def crf_beam_search_device_batch(
    probs: torch.Tensor,
    init_states: torch.Tensor,
    lengths,
    beam_cut_threshold,
    *,
    beam_size: int,
    max_nodes: int,
):
    """Exact CRF beam search of a padded [B, T, S, A+1] f32 batch with
    [B, Si] init states and [B] lengths.

    Returns the dict of ``ops.beam.beam_search_device_batch`` (labels_rev,
    times_rev, count, err; int32), each row equal to
    ``fast_ctc_decode_tpu.ops.crf.crf_beam_search_device`` on that read.
    """
    lengths = check_batch(probs, lengths, beam_size, max_nodes, crf=True)
    B, T, S, A1 = probs.shape
    check_init(init_states, B, probs.device)
    K, N = int(beam_size), int(max_nodes)
    dev = probs.device
    thr = torch.tensor(float(np.float32(beam_cut_threshold)), dtype=torch.float32, device=dev)
    lab0, gap0, state0 = init_beam(init_states)
    carry = _init_carry(B, K, N, A1 - 1, lab0, gap0, state0, dev)
    for t in range(T):
        carry = _crf_beam_step(carry, probs[:, t], t, N=N, lengths=lengths, threshold=thr)
    labels_rev, times_rev, count = _traceback(
        carry.node[:, 0], carry.parent, carry.label, carry.time, T
    )
    return {"labels_rev": labels_rev, "times_rev": times_rev, "count": count, "err": carry.err}
