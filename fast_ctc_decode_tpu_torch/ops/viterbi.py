"""Viterbi (greedy argmax) CTC decoding.

Port of ``fast_ctc_decode_tpu/ops/viterbi.py``.  Reference semantics
(src/search.rs:320-383 of the reference): per-frame argmax (first occurrence
of the max wins); a frame emits when its label is non-blank and (collapse is
off or the label differs from the previous frame's label); the path records
the emitting frame; a per-run mean label probability becomes one phred char
per emitted label.  The run accumulator keeps counting over collapsed
repeats and is not reset by blanks.

Two assembly paths, as in the JAX package:
 - ``viterbi_device_batch``: everything on the device for a [B, T, A+1]
   batch, fixed-width outputs (tokens, path, phred ints, count).  Run means
   add each run in frame order, as the JAX ``segment_sum`` does
   (``viterbi_cuda.run_means``: the plain scatter-add on the CPU, the
   hand-written kernel ``csrc/viterbi_runs_kernel.cu`` on a CUDA device,
   where a scatter-add's atomics would add in no fixed order).  The card and
   the CPU give the same bits.
 - ``assemble_host``: host assembly of one read, used by the single-read
   API.  Its run means come from the batch path's own ``run_means`` at
   B=1 (the kernel on a CUDA tensor, the plain version on a CPU tensor),
   so they add in frame order and equal the batch path's bits.  The JAX
   package sums these runs with ``np.add.reduceat``, which does not add an
   f32 run of 3 or more terms left to right; where a run mean sits on a
   phred rounding edge, the port's phred character differs from the JAX
   API's by one.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import viterbi_cuda
from .phred import phred_int, phred_int_np


def viterbi_core(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame (argmax label, max prob) over the label axis.

    ``torch.argmax`` returns the first maximal index (a NaN counts as the
    maximum), as ``jnp.argmax`` and the reference fold do.
    """
    return probs.argmax(-1).to(torch.int32), probs.amax(-1)


def frame_runs(probs: torch.Tensor, lengths: torch.Tensor, *, collapse_repeats: bool = True):
    """Per-frame (label, max prob) of a padded [B, T, A+1] batch, masked to
    label 0, probability 0 past each read's length, with each frame's emit
    flag and segment (the index of the most recent emitting frame, -1 before
    the first): (labels [B, T] i32, pmax [B, T] f32, emit [B, T] bool,
    seg [B, T] i32), all contiguous."""
    B, T = probs.shape[0], probs.shape[1]
    dev = probs.device
    frame = torch.arange(T, dtype=torch.int32, device=dev)
    in_range = frame[None, :] < lengths.to(torch.int32)[:, None]

    labels, pmax = viterbi_core(probs)
    labels = torch.where(in_range, labels, 0).contiguous()
    pmax = torch.where(in_range, pmax, 0.0).contiguous()
    return (labels, pmax, *emit_segments(labels, collapse_repeats=collapse_repeats))


def emit_segments(labels: torch.Tensor, *, collapse_repeats: bool = True):
    """Each frame's emit flag and segment (the index of the most recent
    emitting frame, -1 before the first) from [B, T] labels: (emit [B, T]
    bool, seg [B, T] i32)."""
    B = labels.shape[0]
    nonzero = labels != 0
    prev = torch.cat(
        [torch.full((B, 1), -1, dtype=labels.dtype, device=labels.device), labels[:, :-1]], 1
    )
    emit = nonzero & (labels != prev) if collapse_repeats else nonzero
    seg = torch.cumsum(emit.to(torch.int32), 1, dtype=torch.int32) - 1
    return emit, seg.contiguous()


def viterbi_device_batch(
    probs: torch.Tensor,
    lengths: torch.Tensor,
    qscale,
    qbias,
    *,
    collapse_repeats: bool = True,
):
    """Viterbi decode of a padded [B, T, A+1] f32 batch with [B] lengths.

    Returns a dict of fixed-width tensors on ``probs``' device, each read's
    row as ``fast_ctc_decode_tpu.ops.viterbi.viterbi_device`` gives it:
      tokens [B, T] i32: 1-based alphabet rows of the emitted labels,
        front-packed; rows past ``n`` repeat the (masked) label of frame 0;
      path [B, T] i32: emitting frame per token, front-packed, 0 past ``n``;
      qints [B, T] i64: rounded phred integer of each run's mean;
      n [B] i32: number of emitted tokens.
    """
    labels, pmax, emit, seg = frame_runs(probs, lengths, collapse_repeats=collapse_repeats)
    path, n = emit_path(emit, seg)
    tokens = labels.gather(1, path.long())
    qints = phred_int(viterbi_cuda.run_means(labels, pmax, path, n), qscale, qbias)
    return {"tokens": tokens, "path": path, "qints": qints, "n": n}


def emit_path(emit: torch.Tensor, seg: torch.Tensor):
    """The emitting frames front-packed, 0 past the count (a dump column
    takes the rest): (path [B, T] i32, n [B] i32)."""
    B, T = emit.shape
    frame = torch.arange(T, dtype=torch.int32, device=emit.device)
    slot = torch.where(emit, seg, T).long()
    path = torch.zeros((B, T + 1), dtype=torch.int32, device=emit.device)
    path.scatter_(1, slot, frame.expand(B, T).contiguous())
    return path[:, :T].contiguous(), emit.sum(1, dtype=torch.int32)


def assemble_host(
    labels: torch.Tensor,
    pmax: torch.Tensor,
    alphabet: List[str],
    qstring: bool,
    qscale: float,
    qbias: float,
    collapse_repeats: bool,
) -> Tuple[str, List[int]]:
    """One read's (sequence [+ quality], path) from its per-frame [T] labels
    (i32) and max probabilities (f32), both on one device.

    The run means are ``viterbi_cuda.run_means`` at B=1 on that device: each
    run's f32 sum added in frame order, as the reference accumulates it
    (src/search.rs:341-380) and as the batch path does, bit for bit.  This
    departs from the JAX package's ``assemble_host``, whose
    ``np.add.reduceat`` does not add runs of 3 or more terms left to right:
    on a read whose run mean sits on a phred rounding edge, one quality
    character differs from the JAX API's.
    """
    lab = labels.to(torch.int32).reshape(1, -1).contiguous()
    emit, seg = emit_segments(lab, collapse_repeats=collapse_repeats)
    path_t, n_t = emit_path(emit, seg)
    n = int(n_t[0])
    path = path_t[0, :n].cpu().numpy()
    lab_host = lab[0].cpu().numpy()
    seq = "".join(alphabet[int(l)] for l in lab_host[path])
    if not qstring or n == 0:
        return seq, [int(i) for i in path]
    pm = pmax.to(torch.float32).reshape(1, -1).contiguous()
    means = viterbi_cuda.run_means(lab, pm, path_t, n_t)[0, :n].cpu().numpy()
    qints = phred_int_np(means, qscale, qbias)
    quality = "".join(chr(int(q) + 33) for q in qints)
    return seq + quality, [int(i) for i in path]
