"""Hand-written CUDA kernel of the exact tree beam (1D and CRF), with its plain versions.

One kernel template, ``csrc/exact_beam_kernel.cu``, built by
``ops/_build.py`` and launched through ctypes on PyTorch's current stream.
It replaces ``fast_ctc_decode_tpu/ops/beam_exact_pallas.py::_exact_beam_kernel``
in both forms:

 - ``beam_search_exact_kernel_batch`` (crf=False): plain version
   ``beam.beam_search_device_batch``;
 - ``crf_beam_search_exact_kernel_batch`` (crf=True): plain version
   ``crf.crf_beam_search_device_batch``.

Both return the exact engine's dict (labels_rev, times_rev, count, err;
int32), bit for bit.  The kernel runs one warp per read and
``reads_per_block`` reads (1..8, default 4) a block.  The tree of every read
lives in a scratch buffer of ``scratch_stride(N, A)`` int32 words per read
(node records ``(parent, label, time, 0)`` as ``[N]`` int4, then the child
table ``[(N+1)*A]``, rounded up to whole int4), N = ``max_nodes`` (by default
the worst case ``beam.default_max_nodes``), which the kernel never
initialises; ``_new_scratch`` is the one place it is allocated.

Each wrapper checks its inputs and the kernel's bounds and raises beyond
them, whatever the device.  A tensor on the CPU then goes to the plain
version; a CUDA tensor launches the kernel or raises, with no fallback.
``launches`` counts kernel launches (the plain versions count nothing).
"""

from __future__ import annotations

import torch

from . import _build
from . import beam as beam_ops
from . import crf as crf_ops
from .beam_cuda import MAX_A1, MAX_BEAM, _check, _crf_bounds, _raise_for

#: kernel launches per wrapper since the last reset (plain integers)
launches = {"exact": 0, "exact_crf": 0}

_I64_MAX = 2**63 - 1
REC_WORDS = 4  # int32 words of one node record (csrc: kRecWords)
MAX_READS_PER_BLOCK = 8  # csrc: kMaxReadsPerBlock
READS_PER_BLOCK = 4  # the default launch: one warp per read, four reads a block

beam_search_exact_plain = beam_ops.beam_search_device_batch
crf_beam_search_exact_plain = crf_ops.crf_beam_search_device_batch


def reset_launches():
    for name in launches:
        launches[name] = 0


def scratch_stride(N: int, A: int) -> int:
    """int32 words of one read's tree: the node records [N] (int4: parent,
    label, time, 0) and the child table [(N+1)*A], rounded up to a whole
    record so that every read's records stay 16-byte aligned."""
    words = REC_WORDS * N + (N + 1) * A
    return -(-words // REC_WORDS) * REC_WORDS


def _new_scratch(B: int, stride: int, device) -> torch.Tensor:
    """The uninitialised scratch buffer of a launch, [B, stride] int32."""
    return torch.empty((B, stride), dtype=torch.int32, device=device)


def _check_reads_per_block(rpb) -> int:
    if isinstance(rpb, bool) or not isinstance(rpb, int) or not 1 <= rpb <= MAX_READS_PER_BLOCK:
        raise ValueError(
            f"reads_per_block must be an int in [1, {MAX_READS_PER_BLOCK}], got {rpb!r}"
        )
    return rpb


def blocks_per_sm(K: int, A: int, *, crf: bool, reads_per_block: int = READS_PER_BLOCK) -> int:
    """Blocks of ``reads_per_block`` warps one SM holds at once for the
    instance that (K, A) launches, by the CUDA runtime's occupancy
    calculation (needs the built library and a card)."""
    rpb = _check_reads_per_block(reads_per_block)
    blocks = _build.load_library().ctc_exact_beam_blocks_per_sm(K, A, int(bool(crf)), rpb)
    if blocks < 0:
        _raise_for(-blocks, "exact beam kernel occupancy")
    return blocks


def _bounds(B, T, K, A, N):
    if not 1 <= K <= MAX_BEAM:
        raise ValueError(f"beam_size must be in [1, {MAX_BEAM}] for the CUDA kernel, got {K}")
    if not 2 <= A + 1 <= MAX_A1:
        raise ValueError(f"A+1 must be in [2, {MAX_A1}] for the CUDA kernel, got {A + 1}")
    if not 1 <= N < beam_ops._I32_MAX:
        raise ValueError(f"max_nodes must be in [1, 2**31 - 1), got {N}")
    if 4 * B * scratch_stride(N, A) > _I64_MAX:
        raise ValueError("B * max_nodes overflows the int64 byte offsets of the trees")


def _launch(probs, init_states, lengths, thr, *, B, T, S, Si, A, K, N, collapse, crf, rpb):
    dev = probs.device
    stride = scratch_stride(N, A)
    scratch = _new_scratch(B, stride, dev)
    labels_rev = torch.empty((B, T), dtype=torch.int32, device=dev)
    times_rev = torch.empty((B, T), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    err = torch.empty((B,), dtype=torch.int32, device=dev)
    out = {"labels_rev": labels_rev, "times_rev": times_rev, "count": count, "err": err}
    if B == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.ctc_exact_beam_launch(
            probs.data_ptr(), init_states.data_ptr() if crf else None,
            lengths.data_ptr(), float(thr), B, T, S, Si, A, K, N,
            int(bool(collapse)), int(crf), scratch.data_ptr(), stride,
            labels_rev.data_ptr(), times_rev.data_ptr(), count.data_ptr(),
            err.data_ptr(), rpb, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_for(rc, "exact CRF beam kernel" if crf else "exact beam kernel")
    launches["exact_crf" if crf else "exact"] += 1
    return out


def beam_search_exact_kernel_batch(
    probs, lengths, thr, *, beam_size, collapse_repeats=True, max_nodes=None,
    reads_per_block=READS_PER_BLOCK,
):
    """Exact 1D beam over [B, T, A+1] f32 + [B] i32 lengths (one device)."""
    if not isinstance(probs, torch.Tensor) or probs.dim() != 3:
        raise ValueError("probs must be a [B, T, A+1] torch.Tensor")
    B, T, A1 = probs.shape
    K = int(beam_size)
    N = int(beam_ops.default_max_nodes(T, K, A1 - 1) if max_nodes is None else max_nodes)
    _check(probs, "probs", torch.float32, (B, T, A1), probs.device)
    _check(lengths, "lengths", torch.int32, (B,), probs.device)
    _bounds(B, T, K, A1 - 1, N)
    rpb = _check_reads_per_block(reads_per_block)
    if probs.device.type == "cpu":
        return beam_search_exact_plain(
            probs, lengths, thr, beam_size=K, collapse_repeats=collapse_repeats,
            max_nodes=N,
        )
    return _launch(
        probs, None, lengths, thr, B=B, T=T, S=1, Si=1, A=A1 - 1, K=K, N=N,
        collapse=collapse_repeats, crf=False, rpb=rpb,
    )


def crf_beam_search_exact_kernel_batch(
    probs, init_states, lengths, thr, *, beam_size, max_nodes=None,
    reads_per_block=READS_PER_BLOCK,
):
    """Exact CRF beam over [B, T, S, A+1] f32, [B, Si] f32 init states and
    [B] i32 lengths (one device)."""
    if not isinstance(probs, torch.Tensor) or probs.dim() != 4:
        raise ValueError("probs must be a [B, T, S, A+1] torch.Tensor")
    B, T, S, A1 = probs.shape
    K = int(beam_size)
    N = int(beam_ops.default_max_nodes(T, K, A1 - 1) if max_nodes is None else max_nodes)
    _check(probs, "probs", torch.float32, (B, T, S, A1), probs.device)
    if not isinstance(init_states, torch.Tensor) or init_states.dim() != 2:
        raise ValueError("init_states must be a [B, Si] torch.Tensor")
    Si = init_states.shape[1]
    _check(init_states, "init_states", torch.float32, (B, Si), probs.device)
    _check(lengths, "lengths", torch.int32, (B,), probs.device)
    _bounds(B, T, K, A1 - 1, N)
    _crf_bounds(S, Si, A1 - 1)
    rpb = _check_reads_per_block(reads_per_block)
    if probs.device.type == "cpu":
        return crf_beam_search_exact_plain(
            probs, init_states, lengths, thr, beam_size=K, max_nodes=N
        )
    return _launch(
        probs, init_states, lengths, thr, B=B, T=T, S=S, Si=Si, A=A1 - 1, K=K,
        N=N, collapse=False, crf=True, rpb=rpb,
    )
