"""Hand-written CUDA kernel of the exact (band-reuse) duplex tree beam, plain
and CRF, with its plain version.

``csrc/duplex_exact_kernel.cu``, built by ``ops/_build.py`` and launched
through ctypes on PyTorch's current stream, replaces
``fast_ctc_decode_tpu/ops/duplex_exact_pallas.py::_exact_duplex_kernel``
(behind ``duplex_exact_pallas_batch``) in both forms.  Plain version:
``duplex.duplex_exact_batch``; both return its dict (labels_rev [B, T1],
count, err; int32), bit for bit.

Each pair's tree, node bands and stage rows live in a scratch buffer of
``6*N + (N+1)*A + 2*N*W + 2*K*W`` int32 words (``scratch_stride``), N =
``max_nodes`` (by default ``duplex._duplex_max_nodes``, the JAX package's
budget), which the kernel never initialises.  The stage rows (hoisted
bases of the band chains, ``2*K*W`` floats) live in shared memory when they
fit ``STAGE_SMEM_LIMIT`` bytes (``stage_in_shared_memory``) and in the
buffer otherwise; the kernel takes every width either way.  A pair that
needs more than N nodes stops with NODE_OVERFLOW, exactly where the plain
engine does.

Bounds, from the kernel's own arithmetic: ``beam_size * A <= 32`` (one lane
per candidate), ``max_nodes < 2**31`` (int32 node ids), ``max(S, Si) * A``
within int32 (CRF states), B * stride within int64 offsets.  The wrapper
checks its inputs and these bounds and raises beyond them, whatever the
device.  A tensor on the CPU then goes to the plain version; a CUDA tensor
launches the kernel or raises, with no fallback.  ``launches`` counts kernel
launches (the plain version counts nothing).
"""

from __future__ import annotations

import torch

from . import _build
from . import duplex as duplex_ops
from . import duplex_fast
from .beam_cuda import _raise_for
from .duplex_cuda import MAX_LANES

#: kernel launches per form since the last reset (plain integers)
launches = {"duplex_exact": 0, "duplex_exact_crf": 0}

_I64_MAX = 2**63 - 1
STAGE_SMEM_LIMIT = 64 * 1024  # bytes of stage rows a block keeps in shared memory

duplex_exact_plain = duplex_ops.duplex_exact_batch


def reset_launches():
    for name in launches:
        launches[name] = 0


def scratch_stride(N: int, K: int, A: int, W: int) -> int:
    """int32 words of one pair's slab: parent, label, boff, blen, borg, bmax
    [N], child [(N+1)*A], the bands blab, bgap [N*W] and the stage rows
    [2*K*W]."""
    return 6 * N + (N + 1) * A + 2 * N * W + 2 * K * W


def stage_in_shared_memory(K: int, W: int) -> bool:
    """True when the stage rows (2*K*W floats) fit the shared memory the
    kernel gives them; otherwise it keeps them in the scratch buffer."""
    return 2 * K * W * 4 <= STAGE_SMEM_LIMIT


def _new_scratch(B: int, stride: int, device) -> torch.Tensor:
    """The uninitialised scratch buffer of a launch, [B, stride] int32."""
    return torch.empty((B, stride), dtype=torch.int32, device=device)


def launch_shape(K: int, W: int, *, crf: bool) -> dict:
    """How the kernel launches at (K, W) on the current card: threads of a
    block, its dynamic shared memory in bytes, and blocks per SM by the CUDA
    runtime's occupancy calculation (needs the built library and a card)."""
    lib = _build.load_library()
    blocks = lib.ctc_duplex_exact_blocks_per_sm(K, W, int(bool(crf)))
    if blocks < 0:
        _raise_for(-blocks, "exact duplex kernel occupancy")
    smem = 2 * K * W * 4 if stage_in_shared_memory(K, W) else 0
    return {"block": lib.ctc_duplex_block_threads(), "smem": smem, "blocks_per_sm": blocks}


def _bounds(B, K, A, N, W, S, crf):
    if not 1 <= K * A <= MAX_LANES:
        raise ValueError(
            f"beam_size * (len(alphabet) - 1) must be in [1, {MAX_LANES}] for the exact "
            f"duplex CUDA kernel, got {K} * {A}"
        )
    if not 1 <= N < duplex_fast._I32_MAX:
        raise ValueError(f"max_nodes must be in [1, 2**31 - 1), got {N}")
    if B * scratch_stride(N, K, A, W) > _I64_MAX:
        raise ValueError("B * max_nodes * W overflows the int64 scratch offsets")
    if crf and S * A + A > duplex_fast._I32_MAX:
        raise ValueError("S * A overflows the int32 transition states")


def duplex_exact_kernel_batch(
    l1, l2, root_gap, lo, hi, thr, init_states, lengths, *,
    beam_size, collapse_repeats, max_nodes, W, needs_ext, crf,
):
    """Exact duplex decode of a batch of pairs on one device; arguments as
    ``duplex.duplex_exact_batch``."""
    K, N, W = int(beam_size), int(max_nodes), int(W)
    B, T1, T2, S, A = duplex_fast.check_pair_batch(
        l1, l2, root_gap, lo, hi, init_states, lengths, beam_size=K, crf=crf
    )
    dev = l1.device
    for name, x in (("l2", l2), ("root_gap", root_gap), ("lo", lo), ("hi", hi),
                    ("init_states", init_states), ("lengths", lengths)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not l1.is_contiguous():
        raise ValueError("l1 must be contiguous")
    if W < 1:
        raise ValueError(f"W must be >= 1, got {W}")
    _bounds(B, K, A, N, W, S, crf)
    if dev.type == "cpu":
        return duplex_exact_plain(
            l1, l2, root_gap, lo, hi, thr, init_states, lengths, beam_size=K,
            collapse_repeats=collapse_repeats, max_nodes=N, W=W, needs_ext=needs_ext, crf=crf,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    with torch.cuda.device(dev):
        return _launch(l1, l2, root_gap, lo, hi, thr, init_states, lengths, K=K, N=N, W=W,
                       collapse=collapse_repeats, needs_ext=needs_ext, crf=crf)


def _launch(l1, l2, root_gap, lo, hi, thr, init_states, lengths, *, K, N, W, collapse,
            needs_ext, crf):
    B, T1 = l1.shape[0], l1.shape[1]
    T2, A = l2.shape[1], l1.shape[-1] - 1
    S = l1.shape[2] if crf else 1
    dev = l1.device
    stride = scratch_stride(N, K, A, W)
    labels_rev = torch.empty((B, T1), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    err = torch.empty((B,), dtype=torch.int32, device=dev)
    out = {"labels_rev": labels_rev, "count": count, "err": err}
    if B == 0:
        return out
    scratch = _new_scratch(B, stride, dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    rc = lib.ctc_duplex_exact_launch(
        l1.data_ptr(), l2.data_ptr(), root_gap.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        init_states.data_ptr(), lengths.data_ptr(), float(thr), B, T1, T2, S, A, K, N, W,
        root_gap.shape[1], int(bool(needs_ext)), int(bool(collapse)), int(bool(crf)),
        scratch.data_ptr(), stride, labels_rev.data_ptr(), count.data_ptr(), err.data_ptr(),
        stream,
    )
    _raise_for(rc, "exact duplex CRF kernel" if crf else "exact duplex kernel")
    launches["duplex_exact_crf" if crf else "duplex_exact"] += 1
    return out
