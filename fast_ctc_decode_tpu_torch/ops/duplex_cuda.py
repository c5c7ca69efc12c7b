"""Hand-written CUDA kernel of the slot-band duplex beam, with its plain version.

``csrc/duplex_kernel.cu``, built by ``ops/_build.py`` and launched through
ctypes on PyTorch's current stream, replaces
``fast_ctc_decode_tpu/ops/duplex_pallas.py::_duplex_kernel`` (behind
``duplex_pallas_batch``): the slot-band decode over the whole network_1
loop, one block of four warps per read pair.  Plain version:
``duplex_fast.duplex_fast_ids`` (crf=False).  The id log it writes is coded
as the 1D beam's, so the 1D beam's traceback kernel
(``beam_cuda.traceback_kernel``) turns it into labels.

Bounds, from the kernel's own arithmetic:
  - ``beam_size * A <= 32``: one lane per fresh candidate (k, a);
  - the bands of one pair, ``8 * K * Wk`` floats with
    ``Wk = max(hi - lo) + 2``, fit the dynamic shared memory of one block
    (``SMEM_LIMIT`` bytes);
  - ``T1 * K * A < 2**31``: int32 node ids;
  - every pair's lower bounds are non-decreasing (the full range included):
    the envelope class of the TPU kernel, where a band row can be a ring
    over network_2 cells.

Every fresh candidate's band is built once, into a scratch slab in device
memory (``slab_words`` f32 words per pair, allocated here with
``torch.empty`` and never initialised; an allocation that fails raises), and
the chosen candidates' rows are copied from it.  The rows of hoisted bases
("stage" rows) sit beside the bands in shared memory when ``10 * K * Wk``
floats fit (``stage_in_shared_memory``) and in the slab otherwise; that
choice changes no bound.

The wrapper checks its inputs and these bounds and raises beyond them,
whatever the device.  A tensor on the CPU then goes to the plain version; a
CUDA tensor launches the kernel or raises, with no fallback.  ``launches``
counts kernel launches (the plain version counts nothing).
"""

from __future__ import annotations

import torch

from . import _build
from . import duplex_fast
from .beam_cuda import _raise_for, traceback_kernel

#: kernel launches since the last reset (plain integers)
launches = {"duplex": 0}

MAX_LANES = 32  # K * A fresh candidates, one per lane of the pair's warp
SMEM_LIMIT = 224 * 1024  # dynamic bytes per block (H100 opts in to 227 KB)

duplex_ids_plain = duplex_fast.duplex_fast_ids


def reset_launches():
    for name in launches:
        launches[name] = 0


def band_width(lo: torch.Tensor, hi: torch.Tensor) -> int:
    """Ring width of the kernel's band rows: max(hi - lo) + 2."""
    return max(int((hi.long() - lo.long()).max()) if lo.numel() else 0, 0) + 2


def fits_shared_memory(K: int, Wk: int) -> bool:
    """True when one pair's bands, 8 rings of Wk floats per slot, fit a
    block's dynamic shared memory."""
    return 8 * K * Wk * 4 <= SMEM_LIMIT


def stage_in_shared_memory(K: int, Wk: int) -> bool:
    """True when the stage rows, 2 more rings of Wk floats per slot, fit
    beside the bands; otherwise the kernel keeps them in the slab."""
    return 10 * K * Wk * 4 <= SMEM_LIMIT


def slab_words(K: int, A: int, Wk: int) -> int:
    """f32 words of one pair's scratch slab: the fresh candidates' cells
    [Wk][2][K*A] and room for the stage rows [2][K][Wk]."""
    return 2 * K * A * Wk + 2 * K * Wk


def _new_slab(B: int, words: int, device) -> torch.Tensor:
    """The uninitialised scratch slab of a launch, [B, words] f32."""
    return torch.empty((B, words), dtype=torch.float32, device=device)


def launch_shape(K: int, Wk: int) -> dict:
    """How the kernel launches at (K, Wk) on the current card: threads of a
    block, its dynamic shared memory in bytes, and blocks per SM by the CUDA
    runtime's occupancy calculation (needs the built library and a card)."""
    lib = _build.load_library()
    blocks = lib.ctc_duplex_slot_blocks_per_sm(K, Wk)
    if blocks < 0:
        _raise_for(-blocks, "duplex slot kernel occupancy")
    smem = (10 if stage_in_shared_memory(K, Wk) else 8) * K * Wk * 4
    return {"block": lib.ctc_duplex_block_threads(), "smem": smem, "blocks_per_sm": blocks}


def math_check(device) -> tuple:
    """Run ``csrc/duplex_math_check.cu`` on a CUDA device: how many of the 2^32
    float arguments give a result of the kernels' straight-line ``exp_f32`` /
    ``log1p_f32`` that differs from the CUDA math library's ``expf`` /
    ``log1pf`` (which PyTorch's ``exp`` / ``log1p`` call).  (0, 0) is the
    condition of the kernels' bit parity with the plain engines."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the math check compares device functions: it needs a CUDA device")
    with torch.cuda.device(dev):
        out = torch.zeros((2,), dtype=torch.int64, device=dev)
        rc = _build.load_library().ctc_duplex_math_check_launch(
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _raise_for(rc, "duplex math check")
        bad_exp, bad_log1p = out.tolist()
    return bad_exp, bad_log1p


def in_envelope_class(lo: torch.Tensor) -> bool:
    """True when every pair's lower bounds are non-decreasing."""
    return lo.shape[1] < 2 or bool((lo[:, 1:] >= lo[:, :-1]).all())


def check_bounds(lo, hi, *, K: int, A: int):
    """Raise ValueError outside the kernel's bounds; returns Wk."""
    if not 1 <= K * A <= MAX_LANES:
        raise ValueError(
            f"beam_size * (len(alphabet) - 1) must be in [1, {MAX_LANES}] for the duplex "
            f"CUDA kernel, got {K} * {A}"
        )
    if not in_envelope_class(lo):
        raise ValueError(
            "the duplex CUDA kernel needs non-decreasing envelope lower bounds "
            "(the full range included); use engine 'exact' or 'fast'"
        )
    Wk = band_width(lo, hi)
    if not fits_shared_memory(K, Wk):
        raise ValueError(
            f"duplex band width {Wk} x beam {K} exceeds the kernel's shared memory "
            f"({8 * K * Wk * 4} > {SMEM_LIMIT} bytes)"
        )
    return Wk


def _launch(l1, l2, root_gap, lo, hi, thr, lengths, *, K, Wk, collapse, needs_ext):
    B, T1, A1 = l1.shape
    dev = l1.device
    ids_log = torch.empty((T1, K, B), dtype=torch.int32, device=dev)
    fin = torch.empty((B,), dtype=torch.int32, device=dev)
    err = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return ids_log, fin, err
    words = slab_words(K, A1 - 1, Wk)
    slab = _new_slab(B, words, dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    rc = lib.ctc_duplex_slot_launch(
        l1.data_ptr(), l2.data_ptr(), root_gap.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        lengths.data_ptr(), float(thr), B, T1, l2.shape[1], A1 - 1, K, root_gap.shape[1],
        Wk, int(bool(needs_ext)), int(bool(collapse)), slab.data_ptr(), words,
        ids_log.data_ptr(), fin.data_ptr(), err.data_ptr(), stream,
    )
    _raise_for(rc, "duplex slot kernel")
    launches["duplex"] += 1
    return ids_log, fin, err


def duplex_ids_kernel(
    l1, l2, root_gap, lo, hi, thr, lengths, *, beam_size, collapse_repeats, needs_ext
):
    """Slot-band forward beam: ``(ids_log [T1, K, B], fin [B], err [B])``.

    l1 [B, T1, A+1], l2 [B, T2, A+1], root_gap [B, Wr] f32 log probs; lo, hi
    [B, T1] and lengths [B] i32; all contiguous on one device."""
    K = int(beam_size)
    zeros = torch.zeros(lengths.shape, dtype=torch.int32, device=lengths.device)
    B, T1, T2, _, A = duplex_fast.check_pair_batch(
        l1, l2, root_gap, lo, hi, zeros, lengths, beam_size=K, crf=False
    )
    dev = l1.device
    for name, x in (("l2", l2), ("root_gap", root_gap), ("lo", lo), ("hi", hi),
                    ("lengths", lengths)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    for name, x in (("l1", l1), ("l2", l2), ("root_gap", root_gap), ("lo", lo), ("hi", hi)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Wk = check_bounds(lo, hi, K=K, A=A)
    if dev.type == "cpu":
        return duplex_ids_plain(
            l1, l2, root_gap, lo, hi, thr, zeros, lengths, beam_size=K,
            collapse_repeats=collapse_repeats, needs_ext=needs_ext, crf=False,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    with torch.cuda.device(dev):
        return _launch(l1, l2, root_gap, lo, hi, thr, lengths, K=K, Wk=Wk,
                       collapse=collapse_repeats, needs_ext=needs_ext)


def duplex_kernel_batch(
    l1, l2, root_gap, lo, hi, thr, lengths, *, beam_size, collapse_repeats, needs_ext
):
    """The slot kernel then the 1D beam's traceback kernel: the output dict of
    ``duplex_fast.duplex_fast_batch`` (labels_rev [B, T1], count, err)."""
    ids_log, fin, err = duplex_ids_kernel(
        l1, l2, root_gap, lo, hi, thr, lengths, beam_size=beam_size,
        collapse_repeats=collapse_repeats, needs_ext=needs_ext,
    )
    labels_rev, _, count = traceback_kernel(
        fin, ids_log, T=l1.shape[1], K=int(beam_size), A=l1.shape[2] - 1
    )
    return {"labels_rev": labels_rev, "count": count, "err": err}
