"""Batched beam decode pipeline on one device.

Reads arrive as padded posterior batches ``[B, T, A+1]`` with per-read
lengths, are decoded on the caller's ``device``, and only fixed-width
arrays plus counters come back to the host, where ragged strings are
assembled.  Port of the 1D beam part of
``fast_ctc_decode_tpu/parallel/pipeline.py``: the JAX package's data mesh
is replaced by an explicit ``device`` (so B need not divide a device
count); running on several cards is later work.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import errors
from ..alphabet import normalize_alphabet
from ..ops import beam_cuda
from ..ops import beam_fast as beam_fast_ops

ENGINES = ("cuda", "fast", "exact")


def _resolve(engine: Optional[str], device: torch.device) -> str:
    if engine is None:
        engine = "cuda" if device.type == "cuda" else "fast"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "exact":
        raise ValueError(
            "engine 'exact' is not ported yet (ROADMAP.md queue 1 item 6, "
            "queue 2 item 3)"
        )
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine 'cuda' needs a CUDA device, got {device}")
    return engine


def _decode_arrays(engine, device, probs, lengths, threshold, beam_size, collapse):
    """Move a batch to ``device`` and run ``engine`` on it: the raw dict."""
    fn = (
        beam_cuda.beam_search_kernel_batch
        if engine == "cuda"
        else beam_fast_ops.beam_search_fast_batch
    )
    probs = torch.as_tensor(probs, dtype=torch.float32, device=device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return fn(
        probs.contiguous(), lengths.contiguous(), np.float32(threshold),
        beam_size=int(beam_size), collapse_repeats=bool(collapse),
    )


class BatchBeamDecoder:
    """Batched CTC prefix beam search decoder on one device.

    Static configuration: T, alphabet, beam size, cut threshold, collapse
    flag.  ``decode`` accepts [B, T, A+1] f32 posteriors + [B] lengths
    (numpy arrays or tensors) and moves them to ``device``.

    ``engine`` selects the device code:
      - "cuda": the hand-written kernels (ops/beam_cuda.py); CUDA devices only.
      - "fast": the plain PyTorch hash-identity engine (ops/beam_fast.py),
        on any device; bit-identical to "cuda".
      - "exact": not ported yet, raises ValueError.
      - None (default): "cuda" on a CUDA device, "fast" on the CPU.
    Both engines are sequence-exact against the reference; ``path`` entries
    of pruned-and-re-derived prefixes report their latest creation time.
    """

    def __init__(
        self,
        alphabet,
        T: int,
        beam_size: int = 5,
        beam_cut_threshold: float = 0.0,
        collapse_repeats: bool = True,
        engine: Optional[str] = None,
        device="cpu",
    ):
        self.alphabet = normalize_alphabet(alphabet)
        self.T = int(T)
        self.beam_size = int(beam_size)
        self.threshold = np.float32(beam_cut_threshold)
        self.collapse = bool(collapse_repeats)
        self.device = torch.device(device)
        self.engine = _resolve(engine, self.device)

    def decode_arrays(self, probs, lengths):
        """Device decode only: the fixed-width result dict (labels_rev,
        times_rev, count, err; int32 tensors on ``device``)."""
        return _decode_arrays(
            self.engine, self.device, probs, lengths, self.threshold,
            self.beam_size, self.collapse,
        )

    def decode(self, probs, lengths) -> List[Tuple[str, List[int], int]]:
        """Full decode: returns [(sequence, path, err_code)] per read.
        Reads that fail keep their status code instead of raising, so one
        bad read cannot abort a batch.  String assembly uses the native C++
        detokenizer when available.  Per-stage wall times land in
        ``utils.profiling.METRICS``."""
        from ..native import detokenize_batch
        from ..utils import profiling

        B = int(probs.shape[0])
        with profiling.stage("beam.device", reads=B):
            out = {k: v.cpu().numpy() for k, v in self.decode_arrays(probs, lengths).items()}
        with profiling.stage("beam.detok"):
            counts = np.where(out["err"] == errors.OK, out["count"], 0).astype(np.int32)
            seqs = detokenize_batch(
                out["labels_rev"], counts, self.alphabet[1:], reverse=True
            )
            res = []
            for seq, times_rev, n, err in zip(seqs, out["times_rev"], counts, out["err"]):
                err = int(err)
                if err != errors.OK:
                    res.append(("", [], err))
                    continue
                res.append((seq, times_rev[: int(n)][::-1].tolist(), errors.OK))
        return res


def decode_and_count(
    probs, lengths, *, beam_size, threshold, collapse, engine=None, device="cpu"
):
    """Decode one batch and count its reads: ``(out, totals)`` with
    ``totals = [decoded OK, errored]`` (int32 tensor on ``device``).

    The JAX package merges these counters across its mesh with a psum; here
    the sum is local to the one device."""
    dev = torch.device(device)
    out = _decode_arrays(
        _resolve(engine, dev), dev, probs, lengths, threshold, beam_size,
        collapse,
    )
    ok = (out["err"] == errors.OK).sum(dtype=torch.int32)
    bad = (out["err"] != errors.OK).sum(dtype=torch.int32)
    return out, torch.stack([ok, bad])


def _bucket_edge_for(T: int, min_edge: int = 128) -> int:
    """Smallest power-of-two edge >= T (and >= min_edge): requests with
    nearby read lengths share one decoder at <= 2x padding waste."""
    e = int(min_edge)
    while e < T:
        e *= 2
    return e


def _auto_bucket_edges(lengths: Sequence[int], min_edge: int = 128) -> List[int]:
    """Power-of-two length-bucket edges covering ``lengths``: padding waste
    is bounded at 2x per read while the number of buckets stays
    logarithmic in the length range."""
    mx = max(lengths)
    edges = []
    e = min_edge
    while e < mx:
        edges.append(e)
        e *= 2
    edges.append(mx)
    return edges


def decode_many(
    reads: Sequence[np.ndarray],
    alphabet,
    *,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    collapse_repeats: bool = True,
    batch_size: int = 256,
    T: Optional[int] = None,
    bucket_edges: Optional[Sequence[int]] = None,
    engine: Optional[str] = None,
    device="cpu",
    checkpoint_path: Optional[str] = None,
) -> List[Tuple[str, List[int], int]]:
    """Decode a long list of variable-length reads with checkpoint/resume.

    Reads are grouped into length buckets (``bucket_edges``; auto power-of-2
    edges unless ``T`` pins a single bucket), so mixed-length read sets pay
    bounded (<= 2x) padding waste.  Each bucket is decoded in ``batch_size``
    batches on ``device`` (final partial batches are padded with length-0
    dummy reads, not duplicate decodes) and results are appended to the
    JSONL checkpoint per batch: a preempted run restarted with the same
    ``checkpoint_path`` resumes at exactly the undecoded reads.  The
    checkpoint format and its ``meta`` keys are the JAX package's, so a run
    resumes across the two packages.  Results are returned in input order.
    """
    from ..utils import profiling
    from ..utils.checkpoint import DecodeCheckpoint
    from ..utils.padding import bucket_reads

    if not reads:
        return []
    dev = torch.device(device)
    engine = _resolve(engine, dev)
    if T is not None:
        edges = [int(T)]
    elif bucket_edges is not None:
        edges = sorted(int(e) for e in bucket_edges)
    else:
        edges = _auto_bucket_edges([r.shape[0] for r in reads])
    meta = {
        "bucket_edges": edges,
        "beam_size": int(beam_size),
        "beam_cut_threshold": float(beam_cut_threshold),
        "collapse_repeats": bool(collapse_repeats),
        "engine": engine,
    }

    ckpt = DecodeCheckpoint.load_or_create(checkpoint_path, meta)
    try:
        if ckpt.cursor >= len(reads):
            profiling.log.info(
                "decode_many: all %d reads already in checkpoint", len(reads)
            )
            return ckpt.results_in_order(len(reads))

        buckets = bucket_reads(reads, edges)
        A1 = reads[0].shape[1]
        bs = max(int(batch_size), 1)
        for edge, idxs in sorted(buckets.items()):
            todo = [i for i in idxs if i not in ckpt.done]
            if not todo:
                continue
            dec = BatchBeamDecoder(
                alphabet,
                T=edge,
                beam_size=beam_size,
                beam_cut_threshold=beam_cut_threshold,
                collapse_repeats=collapse_repeats,
                engine=engine,
                device=dev,
            )
            profiling.log.info(
                "decode_many: bucket T<=%d, %d reads, batch=%d", edge,
                len(todo), bs,
            )
            for s in range(0, len(todo), bs):
                chunk = todo[s : s + bs]
                n = len(chunk)
                # partial batches ride length-0 padding rows (decoded as
                # empty in O(1) work), never duplicate decodes
                with profiling.stage("decode_many.pad"):
                    probs = np.zeros((bs, edge, A1), np.float32)
                    lengths = np.zeros((bs,), np.int32)
                    for j, i in enumerate(chunk):
                        r = reads[i]
                        probs[j, : r.shape[0]] = r
                        lengths[j] = r.shape[0]
                res = dec.decode(probs, lengths)[:n]
                with profiling.stage("decode_many.checkpoint"):
                    ckpt.record(chunk, res)
                bad = sum(1 for r in res if r[2] != errors.OK)
                if bad:
                    profiling.log.warning(
                        "decode_many: %d/%d reads errored in batch", bad, n
                    )
        profiling.log.info(
            "decode_many: %d reads done; stage seconds: %s",
            len(reads),
            {k: round(v, 3) for k, v in profiling.METRICS.stages.items()},
        )
        return ckpt.results_in_order(len(reads))
    finally:
        ckpt.close()
