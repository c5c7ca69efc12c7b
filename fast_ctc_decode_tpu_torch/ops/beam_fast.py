"""Plain PyTorch CTC prefix beam search: O(beam) carry, no suffix tree.

Port of ``fast_ctc_decode_tpu/ops/beam_fast.py`` (1D and CRF), batched
over reads with a Python loop over time.  It is at once ``engine="fast"``,
the CPU path, and the plain version that the CUDA kernels in
``ops/beam_cuda.py`` are checked against bit for bit.

The algorithm (see the JAX module's docstring for the full exactness
contract against the reference ``beam_search``, src/search.rs:159-301):

 - **Prefix identity by rolling hash.**  Each beam tip carries a 64-bit
   content hash of its prefix (two independent 32-bit lanes), with
   ``child_hash = mix(parent_hash, label)``, so "does extension (tip i,
   label l) target existing tip j?" is a K x (K*A) hash compare.
 - **Analytic merge.**  A tip receives at most its blank, its stay (on a
   collapsed repeat) and one arrival per step; top-K is K rounds of
   (max total, tie -> min id) over the K + K*A candidates.
 - **Position-coded node ids.**  A node created from tip slot k by label l
   at step t gets id ``t*K*A + k*A + l`` (root -1, empty -2), so the per-step
   log of entry-tip ids ``[T, K, B]`` is the whole traceback structure.

Torch has no uint32 arithmetic, so the hash lanes live in int64 tensors
holding values in [0, 2**32): products are split into 16-bit halves so no
int64 product overflows, and ``>> 16`` on a non-negative value is logical.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import errors
from .crf import check_init, init_beam

ROOT = -1
EMPTY = -2
_I32_MAX = 2**31 - 1
_MASK32 = 0xFFFFFFFF

# two independent 32-bit mix lanes (murmur3/splitmix-style avalanche)
_SEED1 = 0x9E3779B9
_SEED2 = 0x85EBCA6B
_MIX1 = (0xC2B2AE35, 0x165667B1)
_MIX2 = (0x27D4EB2F, 0x9E3779B1)


def _mulmod32(z, mult: int):
    """``(z * mult) mod 2**32`` for int64 ``z`` in [0, 2**32).

    ``z * mult`` itself can reach 2**64 and overflow int64, so the multiplier
    is split into 16-bit halves: every partial product stays below 2**49.
    """
    lo = mult & 0xFFFF
    hi = mult >> 16
    return (z * lo + (((z * hi) & 0xFFFF) << 16)) & _MASK32


def _mix(h, x, mult: int, add: int):
    """One avalanche round folding label ``x`` into hash lane ``h``.

    ``h`` holds uint32 values in int64; ``x`` is any integer tensor and is
    taken modulo 2**32, as the JAX lane's ``x.astype(uint32)`` does.
    """
    c = (_mulmod32(x.to(torch.int64) & _MASK32, mult) + add) & _MASK32
    z = _mulmod32(h ^ c, mult)
    return z ^ (z >> 16)


def _mix1(h, lbl):
    return _mix(h, lbl, *_MIX1)


def _mix2(h, lbl):
    return _mix(h, lbl, *_MIX2)


class FastCarry(NamedTuple):
    id: torch.Tensor  # [B, K] i32 position-coded node id; -1 root, -2 empty
    h1: torch.Tensor  # [B, K] i64 (uint32 values) prefix hash lane 1
    h2: torch.Tensor  # [B, K] i64 (uint32 values) prefix hash lane 2
    lastlab: torch.Tensor  # [B, K] i64 last label (0-based), -1 for root
    state: torch.Tensor  # [B, K] i64 CRF transition state (0 for plain CTC)
    lab: torch.Tensor  # [B, K] f32 label_prob
    gap: torch.Tensor  # [B, K] f32 gap_prob
    valid: torch.Tensor  # [B, K] bool
    err: torch.Tensor  # [B] i32


def _init_fast_carry(K: int, init_lab, init_gap, init_state) -> FastCarry:
    """Every read starts from the root alone in slot 0; ``init_*`` are [B]
    tensors (plain CTC: label_prob 0, gap_prob 1, state 0)."""
    B = init_lab.shape[0]
    device = init_lab.device
    is0 = (torch.arange(K, device=device) == 0).expand(B, K)
    zero_i64 = torch.zeros((B, K), dtype=torch.int64, device=device)
    return FastCarry(
        id=torch.where(is0, ROOT, EMPTY).to(torch.int32),
        h1=torch.where(is0, _SEED1, zero_i64),
        h2=torch.where(is0, _SEED2, zero_i64),
        lastlab=torch.full((B, K), -1, dtype=torch.int64, device=device),
        state=torch.where(is0, init_state.to(torch.int64)[:, None], zero_i64),
        lab=torch.where(is0, init_lab[:, None], 0.0).to(torch.float32),
        gap=torch.where(is0, init_gap[:, None], 0.0).to(torch.float32),
        valid=is0.clone(),
        err=torch.zeros((B,), dtype=torch.int32, device=device),
    )


def _expand_merge_select(
    carry, t, p0, plab, is_rep, new_state, threshold, *, A, K, crf=False
):
    """Step core: expand tips, merge analytically, select top-K.

    Args:
      p0: blank probabilities, [B] for plain CTC, [B, K] per tip for CRF.
      plab: label probabilities, [B, A] for plain CTC, [B, K, A] for CRF.
      is_rep: [B, K, A] collapsed-repeat mask (all-False disables collapse).
      new_state: [B, K, A] i64 state after emitting label a from tip k.
      threshold: 0-dim f32 tensor.
    Returns the next carry (err unchanged) and the [B] (nan, empty) flags.
    """
    B = p0.shape[0]
    dev = p0.device
    lbl = torch.arange(A, device=dev)
    if crf:
        plab_k, p0_k = plab, p0
    else:
        plab_k, p0_k = plab[:, None, :], p0[:, None]  # [B, 1, A], [B, 1]

    # NaN must pass the label threshold check and fail the blank check,
    # as in the reference (src/search.rs:191, 201-203)
    pushed_lab = carry.valid[:, :, None] & ~(plab_k < threshold)
    gap_pos = carry.gap > 0

    # target hashes of every (tip, label) extension: [B, K, A]
    th1 = _mix1(carry.h1[:, :, None], lbl)
    th2 = _mix2(carry.h2[:, :, None], lbl)

    # m[b, i, l, j]: extension (i, l) targets the prefix of current tip j
    m = (
        (th1[..., None] == carry.h1[:, None, None, :])
        & (th2[..., None] == carry.h2[:, None, None, :])
        & (lbl[None, None, :, None] == carry.lastlab[:, None, None, :])
        & carry.valid[:, None, None, :]
    )
    matched = m.any(-1)  # [B, K, A]

    # extension mass: collapsed repeat forks with gap only (src/search.rs:
    # 212-227), otherwise arrival with label+gap (src/search.rs:229-239)
    lg = carry.lab + carry.gap
    m_ext = torch.where(is_rep, carry.gap[:, :, None], lg[:, :, None]) * plab_k
    push_ext = pushed_lab & (~is_rep | matched | gap_pos[:, :, None])

    # ---- analytic merge: blank + stay + at most one arrival per tip ----
    arrive = m & push_ext[..., None]  # [B, K, A, K]
    recv = torch.where(arrive, m_ext[..., None], 0.0).sum(dim=(1, 2))
    recv_any = arrive.flatten(1, 2).any(1)  # [B, K]

    if crf:  # CRF has no repeat collapse, hence no stay
        stay_push = torch.zeros_like(carry.valid)
        stay_lab = torch.zeros_like(carry.lab)
    else:
        # stay: a collapsed repeat keeps the node via label_prob only; the
        # is_rep gate makes collapse_repeats=False disable stays
        safe_last = carry.lastlab.clamp(0, A - 1)
        p_stay = torch.gather(plab, 1, safe_last)  # [B, K]
        stay_push = (
            carry.valid
            & (carry.lastlab >= 0)
            & ~(p_stay < threshold)
            & is_rep.any(-1)
        )
        stay_lab = torch.where(stay_push, carry.lab * p_stay, 0.0)

    blank_push = carry.valid & (p0_k > threshold)
    blank_gap = torch.where(blank_push, lg * p0_k, 0.0)

    tip_lab = stay_lab + recv
    tip_gap = blank_gap
    tip_valid = blank_push | stay_push | recv_any

    # fresh candidates: extensions that target no current tip
    fresh_valid = (push_ext & ~matched).flatten(1)  # [B, K*A]
    fresh_id = (
        t * K * A + torch.arange(K * A, dtype=torch.int32, device=dev)
    ).expand(B, K * A)

    # ---- candidate table: K tip slots then K*A fresh slots ----
    c_valid = torch.cat([tip_valid, fresh_valid], 1)
    c_lab = torch.cat(
        [tip_lab, torch.where(fresh_valid, m_ext.flatten(1), 0.0)], 1
    )
    c_gap = torch.cat([tip_gap, torch.zeros_like(m_ext.flatten(1))], 1)
    c_id = torch.cat([carry.id, fresh_id], 1)
    c_h1 = torch.cat([carry.h1, th1.flatten(1)], 1)
    c_h2 = torch.cat([carry.h2, th2.flatten(1)], 1)
    c_lastlab = torch.cat([carry.lastlab, lbl.repeat(K).expand(B, K * A)], 1)
    c_state = torch.cat([carry.state, new_state.flatten(1)], 1)

    total = c_lab + c_gap
    cnt = c_valid.sum(1)
    # the reference only reports IncomparableValues when a NaN is actually
    # *compared* during its sort (>= 2 merged entries, src/search.rs:261-272)
    nan_flag = (cnt >= 2) & (c_valid & total.isnan()).any(1)
    empty_flag = cnt == 0

    # ---- top-K select: total desc (canonicalizing -0.0), id asc ----
    # K rounds of (max, min-id) extraction reproduce the reference's order
    # (src/search.rs:261-273); a NaN total maps to +inf so a lone NaN entry
    # still tops the beam as in Rust.
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    key = torch.where(
        c_valid, torch.where(total.isnan(), inf, total + 0.0), -inf
    )
    sel = {f: [] for f in ("id", "h1", "h2", "ll", "st", "lab", "gap", "v")}
    top = None
    for _ in range(K):
        mx = key.amax(1, keepdim=True)
        slot_valid = mx[:, 0] > -inf
        at_mx = key == mx
        sel_id = torch.where(at_mx, c_id, _I32_MAX).amin(1, keepdim=True)
        chosen = at_mx & (c_id == sel_id)  # one lane when the slot is valid
        lane = chosen.to(torch.int32).argmax(1, keepdim=True)

        def pick(x):
            return x.gather(1, lane)[:, 0]

        if top is None:
            # per-step renormalizer (src/search.rs:278-282): the raw total
            # (NaN included), +0.0 canonicalizing as the JAX masked sum does
            top = pick(total) + 0.0
        sel["id"].append(torch.where(slot_valid, pick(c_id), EMPTY))
        sel["h1"].append(pick(c_h1))
        sel["h2"].append(pick(c_h2))
        sel["ll"].append(pick(c_lastlab))
        sel["st"].append(pick(c_state))
        sel["lab"].append(pick(c_lab) + 0.0)
        sel["gap"].append(pick(c_gap) + 0.0)
        sel["v"].append(slot_valid)
        key = key.masked_fill(chosen, -inf)

    v_k = torch.stack(sel["v"], 1)
    top = top[:, None]
    next_c = FastCarry(
        id=torch.stack(sel["id"], 1).to(torch.int32),
        h1=torch.stack(sel["h1"], 1),
        h2=torch.stack(sel["h2"], 1),
        lastlab=torch.stack(sel["ll"], 1),
        state=torch.stack(sel["st"], 1),
        # true division: a reciprocal-multiply rounds differently
        lab=torch.where(v_k, torch.stack(sel["lab"], 1) / top, 0.0),
        gap=torch.where(v_k, torch.stack(sel["gap"], 1) / top, 0.0),
        valid=v_k,
        err=carry.err,
    )
    return next_c, nan_flag, empty_flag


def _apply_step(carry, next_c, nan_flag, empty_flag, active):
    """Gate the step result on ``active`` [B] and fold in the error code."""
    step_err = torch.where(
        nan_flag,
        errors.INCOMPARABLE_VALUES,
        torch.where(empty_flag, errors.RAN_OUT_OF_BEAM, errors.OK),
    )
    err = torch.where(
        carry.err > 0, carry.err, torch.where(active, step_err, errors.OK)
    ).to(torch.int32)
    act = active[:, None]
    return FastCarry(
        *(torch.where(act, new, old) for new, old in zip(next_c[:-1], carry[:-1])),
        err=err,
    )


def _beam_fast_step(carry, p, t, *, A, K, collapse, lengths, threshold):
    """One time step for every read; returns (next carry, entry-tip ids)."""
    active = (t < lengths) & (carry.err == errors.OK)
    p0 = p[:, 0]
    plab = p[:, 1:]
    if collapse:
        lbl = torch.arange(A, device=p.device)
        is_rep = carry.lastlab[:, :, None] == lbl
    else:
        is_rep = torch.zeros(
            (p.shape[0], K, A), dtype=torch.bool, device=p.device
        )
    next_c, nan_flag, empty_flag = _expand_merge_select(
        carry, t, p0, plab, is_rep, torch.zeros_like(is_rep, dtype=torch.int64),
        threshold, A=A, K=K,
    )
    return _apply_step(carry, next_c, nan_flag, empty_flag, active), carry.id


def _crf_fast_step(carry, p, t, *, A, S, K, lengths, threshold):
    """One CRF time step for every read; ``p`` is the [B, S, A+1] frame."""
    active = (t < lengths) & (carry.err == errors.OK)
    B = p.shape[0]
    # each tip's row probs[b, t, state_k, :]; the JAX engine selects it as a
    # one-hot masked sum, which turns a -0.0 entry into +0.0: so does +0.0
    rows = carry.state.clamp(0, S - 1)[:, :, None].expand(B, K, A + 1)
    prow = p.gather(1, rows) + 0.0  # [B, K, A+1]
    lbl = torch.arange(A, device=p.device)
    is_rep = torch.zeros((B, K, A), dtype=torch.bool, device=p.device)
    new_state = (carry.state[:, :, None] * A) % S + lbl
    next_c, nan_flag, empty_flag = _expand_merge_select(
        carry, t, prow[:, :, 0], prow[:, :, 1:], is_rep, new_state, threshold,
        A=A, K=K, crf=True,
    )
    return _apply_step(carry, next_c, nan_flag, empty_flag, active), carry.id


def _check_batch(probs, lengths, beam_size, crf=False):
    if not isinstance(probs, torch.Tensor) or probs.dtype != torch.float32:
        raise TypeError("probs must be a float32 torch.Tensor")
    layout = "[B, T, S, A+1]" if crf else "[B, T, A+1]"
    if probs.dim() != (4 if crf else 3) or probs.shape[-1] < 2:
        raise ValueError(f"probs must be {layout} with A >= 1, got {tuple(probs.shape)}")
    if int(beam_size) < 1:
        raise ValueError("beam_size must be >= 1")
    T, A1 = probs.shape[1], probs.shape[-1]
    if T * int(beam_size) * (A1 - 1) > _I32_MAX:
        raise ValueError("T * beam_size * A overflows the int32 node ids")
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=probs.device)
    if lengths.shape != (probs.shape[0],):
        raise ValueError(f"lengths must be [B], got {tuple(lengths.shape)}")
    return lengths


def beam_search_ids_batch(
    probs: torch.Tensor,
    lengths,
    beam_cut_threshold,
    *,
    beam_size: int,
    collapse_repeats: bool = True,
):
    """Forward beam over [B, T, A+1] posteriors + [B] lengths.

    Returns ``(ids_log [T, K, B] i32, fin [B] i32, err [B] i32)``: the
    entry-tip ids of every step (read-minor), the final best node id of
    every read, and its status code.  Frames at ``t >= length`` and frames
    after an error leave a read's beam frozen.
    """
    lengths = _check_batch(probs, lengths, beam_size)
    B, T, A1 = probs.shape
    A = A1 - 1
    K = int(beam_size)
    thr = torch.tensor(float(beam_cut_threshold), dtype=torch.float32, device=probs.device)

    dev = probs.device
    carry = _init_fast_carry(
        K,
        torch.zeros((B,), dtype=torch.float32, device=dev),
        torch.ones((B,), dtype=torch.float32, device=dev),
        torch.zeros((B,), dtype=torch.int64, device=dev),
    )
    ids_log = torch.empty((T, K, B), dtype=torch.int32, device=probs.device)
    for t in range(T):
        carry, ids = _beam_fast_step(
            carry, probs[:, t], t, A=A, K=K, collapse=bool(collapse_repeats),
            lengths=lengths, threshold=thr,
        )
        ids_log[t] = ids.T
    return ids_log, carry.id[:, 0].contiguous(), carry.err


def beam_search_fast_batch(
    probs: torch.Tensor,
    lengths,
    beam_cut_threshold,
    *,
    beam_size: int,
    collapse_repeats: bool = True,
):
    """Batched fast beam: forward beam plus the gather-free traceback.

    Returns dict: labels_rev [B, T], times_rev [B, T] (0-based labels and
    their frames, deepest first, -1 padded), count [B], err [B]; all int32.
    """
    ids_log, fin, err = beam_search_ids_batch(
        probs, lengths, beam_cut_threshold,
        beam_size=beam_size, collapse_repeats=collapse_repeats,
    )
    T, A = probs.shape[1], probs.shape[2] - 1
    labels_rev, times_rev, count = _traceback_scan_batch(
        fin, ids_log, T, int(beam_size), A
    )
    return {
        "labels_rev": labels_rev,
        "times_rev": times_rev,
        "count": count,
        "err": err,
    }


def crf_beam_search_ids_batch(
    probs: torch.Tensor,
    init_states: torch.Tensor,
    lengths,
    beam_cut_threshold,
    *,
    beam_size: int,
):
    """CRF forward beam over [B, T, S, A+1] posteriors, [B, Si] init states
    and [B] lengths (src/search.rs:38-157 of the reference).

    Returns ``(ids_log [T, K, B], fin [B], err [B])``, all int32, as
    ``beam_search_ids_batch`` does: node ids are coded the same way, so the
    1D traceback serves both.  The initial beam is (label_prob =
    max(init), gap_prob = init[0], state = argmax(init), first max wins).
    """
    lengths = _check_batch(probs, lengths, beam_size, crf=True)
    B, T, S, A1 = probs.shape
    check_init(init_states, B, probs.device)
    A = A1 - 1
    K = int(beam_size)
    dev = probs.device
    thr = torch.tensor(float(beam_cut_threshold), dtype=torch.float32, device=dev)
    carry = _init_fast_carry(K, *init_beam(init_states))
    ids_log = torch.empty((T, K, B), dtype=torch.int32, device=dev)
    for t in range(T):
        carry, ids = _crf_fast_step(
            carry, probs[:, t], t, A=A, S=S, K=K, lengths=lengths, threshold=thr
        )
        ids_log[t] = ids.T
    return ids_log, carry.id[:, 0].contiguous(), carry.err


def crf_beam_search_fast_batch(
    probs: torch.Tensor,
    init_states: torch.Tensor,
    lengths,
    beam_cut_threshold,
    *,
    beam_size: int,
):
    """Batched CRF fast beam: forward beam plus the traceback; the output
    dict of ``beam_search_fast_batch``."""
    ids_log, fin, err = crf_beam_search_ids_batch(
        probs, init_states, lengths, beam_cut_threshold, beam_size=beam_size
    )
    T, A = probs.shape[1], probs.shape[3] - 1
    labels_rev, times_rev, count = _traceback_scan_batch(
        fin, ids_log, T, int(beam_size), A
    )
    return {
        "labels_rev": labels_rev,
        "times_rev": times_rev,
        "count": count,
        "err": err,
    }


def _traceback_scan_batch(fin, ids_log, T, K, A):
    """Batched traceback over the [T, K, B] id log by one backward sweep.

    Parents have strictly smaller creation steps than their children, so
    one sweep over t descending visits every chain node leaf-first: at step
    t a read whose current node was created at t emits (label, t) and moves
    to its parent, the entry-tip id ``ids_log[t, k]`` of its source slot.

    Emits are then compacted leaf-first, padding last (the JAX module's
    packed-key sort; a stable 3-operand sort where the key does not fit).

    Returns (labels_rev [B, T], times_rev [B, T], count [B]), all int32.
    """
    B = fin.shape[0]
    dev = fin.device
    KA = K * A
    cur = fin.to(torch.int32).clone()
    lab1 = torch.zeros((T, B), dtype=torch.int32, device=dev)
    for i, t in enumerate(range(T - 1, -1, -1)):
        safe = cur.clamp_min(0)
        tt = safe // KA
        r = safe % KA
        k = r // A
        a = r % A
        hit = (cur >= 0) & (tt == t)
        par = ids_log[t].gather(0, k[None].long())[0]
        cur = torch.where(hit, par, cur)
        lab1[i] = torch.where(hit, a + 1, 0)  # 0 = no emit

    lab_bits, t_bits = _key_bits(T, A)
    if lab_bits + t_bits <= 30:
        labels_rev, times_rev = _compact_packed(lab1, T, lab_bits, t_bits)
    else:
        labels_rev, times_rev = _compact_stable(lab1, T)
    count = (labels_rev >= 0).sum(-1, dtype=torch.int32)
    return labels_rev, times_rev, count


def _compact_packed(lab1, T, lab_bits, t_bits):
    """Pack (no-emit, backward step i, label+1) into one i32 key per cell."""
    i_col = torch.arange(T, dtype=torch.int32, device=lab1.device)[:, None]
    key = ((lab1 == 0).to(torch.int32) << (lab_bits + t_bits)) | (i_col << lab_bits) | lab1
    return _sort_unpack_keys(key.T, T, lab_bits, t_bits)


def _compact_stable(lab1, T):
    """Wide-key form: stable sort on the no-emit flag carrying label/time."""
    i_col = torch.arange(T, dtype=torch.int32, device=lab1.device)[:, None]
    labs = torch.where(lab1 == 0, -1, lab1 - 1).T
    tvs = torch.where(lab1 == 0, -1, (T - 1) - i_col).T
    order = torch.sort((labs < 0).to(torch.int32), dim=-1, stable=True).indices
    return labs.gather(-1, order), tvs.gather(-1, order)


def _key_bits(T, A):
    """(lab_bits, t_bits) of the packed compaction key."""
    lab_bits = max(int(A).bit_length(), 1)  # holds lab+1 in [0, A]
    t_bits = max(int(max(T, 1) - 1).bit_length(), 1)
    return lab_bits, t_bits


def _sort_unpack_keys(key_bt, T, lab_bits, t_bits):
    """Sort [B, T] packed keys and unpack (labels_rev, times_rev).

    Key layout: ``no_emit_gap | (i << lab_bits) | (label + 1)`` with i the
    backward sweep step (t = T - 1 - i), so ascending order is emits
    leaf-first, padding last.  Keys are unique per row (i is).
    """
    gap = 1 << (lab_bits + t_bits)
    key = torch.sort(key_bt, dim=-1).values
    valid = key < gap
    labels_rev = torch.where(valid, (key & ((1 << lab_bits) - 1)) - 1, -1)
    i_of = (key >> lab_bits) & ((1 << t_bits) - 1)
    times_rev = torch.where(valid, (T - 1) - i_of, -1)
    return labels_rev, times_rev
