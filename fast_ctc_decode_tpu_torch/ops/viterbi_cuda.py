"""Hand-written CUDA kernel of the viterbi run means, with its plain version.

``csrc/viterbi_runs_kernel.cu``, built by ``ops/_build.py`` and launched
through ctypes on PyTorch's current stream, sums each run of frames in frame
order, one thread per (read, run).  It has no Pallas counterpart: the JAX package
leaves this sum to XLA (``jax.ops.segment_sum``), which adds in frame order.
The plain version, ``run_means_plain``, is a scatter-add: in frame order on
the CPU, but with atomics in no fixed order on the card, where the last bits
of a mean (and so a phred character) could change from one call to the
next.  So on a CUDA tensor ``run_means`` launches the kernel, which gives the
CPU's bits; on a CPU tensor it runs the plain version.  There is no
fallback.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .beam_cuda import _raise_for

#: kernel launches since the last reset (a plain integer)
launches = {"viterbi_runs": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


def run_means_plain(labels, pmax, path, n):
    """Per-run mean of the non-blank frames' max probabilities.

    ``labels`` [B, T] i32 and ``pmax`` [B, T] f32 (masked past each read's
    length), ``path`` [B, T] i32 the emitting frames, front-packed, and
    ``n`` [B] i32 their count.  Run j of a read is its frames from
    ``path[j]`` up to ``path[j+1]`` (the frames before the first emit count
    with run 0).  Returns mean [B, T] f32: sum / max(count, 1) per run, 0
    past ``n``."""
    B, T = labels.shape
    dev = labels.device
    # each frame's run: the number of emits at or before it, minus one
    j = torch.arange(T, device=dev)
    starts = torch.where(j[None, :] < n[:, None], path.long(), T)
    marks = torch.zeros((B, T + 1), dtype=torch.int32, device=dev).scatter_(
        1, starts, torch.ones_like(starts, dtype=torch.int32))
    seg = torch.cumsum(marks[:, :T], 1) - 1
    nonzero = labels != 0
    contrib = torch.where(nonzero, pmax, 0.0)
    seg_safe = seg.clamp_min(0).long()
    sums = torch.zeros((B, T), dtype=torch.float32, device=dev).scatter_add_(
        1, seg_safe, contrib
    )
    counts = torch.zeros((B, T), dtype=torch.float32, device=dev).scatter_add_(
        1, seg_safe, nonzero.to(torch.float32)
    )
    return sums / counts.clamp_min(1.0)


def _check(x, name, dtype, shape, device):
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be a {dtype} tensor of shape {shape}")
    if x.device != device or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def run_means(labels, pmax, path, n):
    """``run_means_plain``'s result: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not isinstance(labels, torch.Tensor) or labels.dim() != 2:
        raise ValueError("labels must be a [B, T] torch.Tensor")
    B, T = labels.shape
    dev = labels.device
    _check(labels, "labels", torch.int32, (B, T), dev)
    _check(pmax, "pmax", torch.float32, (B, T), dev)
    _check(path, "path", torch.int32, (B, T), dev)
    _check(n, "n", torch.int32, (B,), dev)
    if dev.type == "cpu":
        return run_means_plain(labels, pmax, path, n)
    mean = torch.empty((B, T), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return mean
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.ctc_viterbi_run_means_launch(
            labels.data_ptr(), pmax.data_ptr(), path.data_ptr(), n.data_ptr(), B, T,
            mean.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_for(rc, "viterbi run-means kernel")
    launches["viterbi_runs"] += 1
    return mean
