"""Batched decode pipelines on one device: 1D beam, viterbi, CRF beam and
duplex pair consensus (plain and CRF).

Reads arrive as padded posterior batches (``[B, T, A+1]``; CRF
``[B, T, S, A+1]`` plus ``[B, Si]`` init states) with per-read lengths,
are decoded on ``device`` (None, the default, is the CUDA card and raises
without one; ``device="cpu"`` asks for the plain engines on the CPU), and
only fixed-width arrays plus counters come back to the host, where ragged
strings are assembled.  Port of ``fast_ctc_decode_tpu/parallel/pipeline.py``:
the JAX package's data mesh is replaced by an explicit ``device`` (so B need
not divide a device count); several cards run one process each
(``parallel/mesh.py``), and ``decode_and_count`` sums their counters.

Engines of the beam decoders:
  - "cuda": the hand-written hash-identity kernels (``ops/beam_cuda.py``);
    CUDA devices only.
  - "fast": the plain PyTorch hash-identity engine (``ops/beam_fast.py``)
    on any device; bit-identical to "cuda".
  - "exact": the suffix-tree engine, bit-exact path and tie parity with
    the reference: the hand-written kernel (``ops/beam_exact_cuda.py``) on a
    CUDA device, the plain engine (``ops/beam.py`` / ``ops/crf.py``) on the
    CPU.  Its tree budget is ``max_nodes`` (default: the worst case), and a
    read that needs more stops with NODE_OVERFLOW; nothing re-runs it.
  - None (default): "cuda" on a CUDA device, "fast" on the CPU.
A CUDA tensor outside a kernel's bounds (beam_size <= 16, A+1 <= 8) raises.
The duplex decoders' engines are described at ``BatchDuplexDecoder``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import errors
from ..alphabet import normalize_alphabet
from ..device import resolve_device
from ..ops import beam as beam_ops
from ..ops import beam_cuda
from ..ops import beam_exact_cuda
from ..ops import beam_fast as beam_fast_ops
from ..ops import crf as crf_ops
from ..ops import duplex as duplex_ops
from ..ops import duplex_cuda
from ..ops import duplex_exact_cuda
from ..ops import duplex_fast as duplex_fast_ops
from ..ops import viterbi as viterbi_ops

ENGINES = ("cuda", "fast", "exact")


def _resolve(engine: Optional[str], device: torch.device) -> str:
    if engine is None:
        engine = "cuda" if device.type == "cuda" else "fast"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine 'cuda' needs a CUDA device, got {device}")
    return engine


def _decode_arrays(
    engine, device, probs, lengths, threshold, beam_size, collapse, max_nodes=None
):
    """Move a batch to ``device`` and run ``engine`` on it: the raw dict."""
    probs = torch.as_tensor(probs, dtype=torch.float32, device=device).contiguous()
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device).contiguous()
    kw = dict(beam_size=int(beam_size), collapse_repeats=bool(collapse))
    if engine == "exact":
        if max_nodes is None:
            max_nodes = beam_ops.default_max_nodes(probs.shape[1], beam_size, probs.shape[2] - 1)
        fn = (
            beam_exact_cuda.beam_search_exact_kernel_batch
            if device.type == "cuda"
            else beam_ops.beam_search_device_batch
        )
        return fn(probs, lengths, np.float32(threshold), max_nodes=int(max_nodes), **kw)
    fn = (
        beam_cuda.beam_search_kernel_batch
        if engine == "cuda"
        else beam_fast_ops.beam_search_fast_batch
    )
    return fn(probs, lengths, np.float32(threshold), **kw)


def _assemble(out, alphabet) -> List[Tuple[str, List[int], int]]:
    """A beam result dict (host numpy arrays) -> [(sequence, path, err)].
    Reads that failed keep their status code and an empty result."""
    from ..native import detokenize_batch

    counts = np.where(out["err"] == errors.OK, out["count"], 0).astype(np.int32)
    seqs = detokenize_batch(out["labels_rev"], counts, alphabet[1:], reverse=True)
    res = []
    for seq, times_rev, n, err in zip(seqs, out["times_rev"], counts, out["err"]):
        err = int(err)
        if err != errors.OK:
            res.append(("", [], err))
            continue
        res.append((seq, times_rev[: int(n)][::-1].tolist(), errors.OK))
    return res


class BatchBeamDecoder:
    """Batched CTC prefix beam search decoder on one device.

    Static configuration: T, alphabet, beam size, cut threshold, collapse
    flag.  ``decode`` accepts [B, T, A+1] f32 posteriors + [B] lengths
    (numpy arrays or tensors) and moves them to ``device``.

    ``engine`` selects the device code (see the module docstring):
    "cuda", "fast", "exact" or None.  All are sequence-exact against the
    reference; with "cuda"/"fast", ``path`` entries of pruned-and-re-derived
    prefixes report their latest creation time, "exact" their first.
    ``max_nodes`` is the exact engine's per-read tree budget (default: the
    worst case for T); the other engines ignore it, as in the JAX package.
    """

    def __init__(
        self,
        alphabet,
        T: int,
        beam_size: int = 5,
        beam_cut_threshold: float = 0.0,
        collapse_repeats: bool = True,
        max_nodes: Optional[int] = None,
        engine: Optional[str] = None,
        device=None,
    ):
        self.alphabet = normalize_alphabet(alphabet)
        self.T = int(T)
        self.beam_size = int(beam_size)
        self.threshold = np.float32(beam_cut_threshold)
        self.collapse = bool(collapse_repeats)
        self.device = resolve_device(device)
        self.engine = _resolve(engine, self.device)
        self.max_nodes = None
        if self.engine == "exact":
            self.max_nodes = int(
                max_nodes
                if max_nodes is not None
                else beam_ops.default_max_nodes(self.T, self.beam_size, len(self.alphabet) - 1)
            )

    def decode_arrays(self, probs, lengths):
        """Device decode only: the fixed-width result dict (labels_rev,
        times_rev, count, err; int32 tensors on ``device``)."""
        return _decode_arrays(
            self.engine, self.device, probs, lengths, self.threshold,
            self.beam_size, self.collapse, self.max_nodes,
        )

    def decode(self, probs, lengths) -> List[Tuple[str, List[int], int]]:
        """Full decode: returns [(sequence, path, err_code)] per read.
        Reads that fail keep their status code instead of raising, so one
        bad read cannot abort a batch.  String assembly uses the native C++
        detokenizer when available.  Per-stage wall times land in
        ``utils.profiling.METRICS``."""
        from ..utils import profiling

        B = int(probs.shape[0])
        with profiling.stage("beam.device", reads=B):
            out = {k: v.cpu().numpy() for k, v in self.decode_arrays(probs, lengths).items()}
        with profiling.stage("beam.detok"):
            return _assemble(out, self.alphabet)


class BatchViterbiDecoder:
    """Batched viterbi decoder on one device (argmax, emission and run-mean
    qualities on the device; strings on the host).

    Run means add each run in frame order on every device (the plain
    scatter-add on the CPU, the run-means kernel on CUDA;
    ``ops/viterbi_cuda.py``), equal to the JAX package's ``segment_sum`` and
    to ``api.viterbi_search``.  Tokens, paths and counts are exact
    everywhere.
    """

    def __init__(
        self,
        alphabet,
        T: int,
        collapse_repeats: bool = True,
        qscale: float = 1.0,
        qbias: float = 0.0,
        device=None,
    ):
        self.alphabet = normalize_alphabet(alphabet)
        self.T = int(T)
        self.collapse = bool(collapse_repeats)
        self.qscale = np.float32(qscale)
        self.qbias = np.float32(qbias)
        self.device = resolve_device(device)

    def decode_arrays(self, probs, lengths):
        """Device decode only: tokens, path, qints, n (tensors on ``device``)."""
        probs = torch.as_tensor(probs, dtype=torch.float32, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        return viterbi_ops.viterbi_device_batch(
            probs, lengths, self.qscale, self.qbias, collapse_repeats=self.collapse
        )

    def decode(self, probs, lengths, qstring: bool = False):
        """Returns [(sequence, path)] per read (sequence + quality string
        when ``qstring``)."""
        from ..native import detokenize_batch, qstrings_batch

        out = {k: v.cpu().numpy() for k, v in self.decode_arrays(probs, lengths).items()}
        counts = out["n"].astype(np.int32)
        # viterbi tokens are 1-based alphabet rows: index the full alphabet
        seqs = detokenize_batch(out["tokens"], counts, self.alphabet, reverse=False)
        if qstring:
            qstrs = qstrings_batch(out["qints"].astype(np.uint32), counts)
            seqs = [s + q for s, q in zip(seqs, qstrs)]
        return [
            (seq, path[: int(n)].tolist()) for seq, path, n in zip(seqs, out["path"], counts)
        ]


class BatchCrfBeamDecoder:
    """Batched CRF prefix beam search on one device.

    Accepts [B, T, S, A+1] f32 posteriors, [B, Si] init states and [B]
    lengths; sequence-exact against the reference crf_beam_search.
    ``engine``: "cuda" (the hand-written CRF kernel; CUDA only), "fast"
    (plain torch, any device), "exact" (bit-exact path/tie parity: the
    exact kernel on CUDA, the plain tree engine on the CPU, with the worst
    case tree budget) or None ("cuda" on a CUDA device, "fast" on the CPU).
    The JAX package's TPU-memory rule for picking its kernel (n_state <=
    256) has no counterpart here: the kernels take any S, and raise only
    beyond beam_size 16 or A+1 = 8.
    """

    def __init__(
        self,
        alphabet,
        T: int,
        n_state: int,
        beam_size: int = 5,
        beam_cut_threshold: float = 0.0,
        engine: Optional[str] = None,
        device=None,
    ):
        self.alphabet = normalize_alphabet(alphabet)
        self.T = int(T)
        self.n_state = int(n_state)
        self.beam_size = int(beam_size)
        self.threshold = np.float32(beam_cut_threshold)
        self.device = resolve_device(device)
        self.engine = _resolve(engine, self.device)
        self.max_nodes = None
        if self.engine == "exact":
            self.max_nodes = beam_ops.default_max_nodes(
                self.T, self.beam_size, len(self.alphabet) - 1
            )

    def decode_arrays(self, probs, init_states, lengths):
        """Device decode only: the fixed-width result dict (labels_rev,
        times_rev, count, err; int32 tensors on ``device``)."""
        dev = self.device
        probs = torch.as_tensor(probs, dtype=torch.float32, device=dev).contiguous()
        init = torch.as_tensor(init_states, dtype=torch.float32, device=dev).contiguous()
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev).contiguous()
        if self.engine == "exact":
            fn = (
                beam_exact_cuda.crf_beam_search_exact_kernel_batch
                if dev.type == "cuda"
                else crf_ops.crf_beam_search_device_batch
            )
            return fn(
                probs, init, lengths, self.threshold, beam_size=self.beam_size,
                max_nodes=self.max_nodes,
            )
        fn = (
            beam_cuda.crf_beam_search_kernel_batch
            if self.engine == "cuda"
            else beam_fast_ops.crf_beam_search_fast_batch
        )
        return fn(probs, init, lengths, self.threshold, beam_size=self.beam_size)

    def decode(self, probs, init_states, lengths) -> List[Tuple[str, List[int], int]]:
        """Returns [(sequence, path, err_code)] per read; per-stage wall
        times land in ``utils.profiling.METRICS``."""
        from ..utils import profiling

        B = int(probs.shape[0])
        with profiling.stage("crf.device", reads=B):
            out = self.decode_arrays(probs, init_states, lengths)
            out = {k: v.cpu().numpy() for k, v in out.items()}
        with profiling.stage("crf.detok"):
            return _assemble(out, self.alphabet)


def decode_and_count(
    probs, lengths, *, beam_size, threshold, collapse, engine=None, device=None
):
    """Decode one batch and count its reads: ``(out, totals)`` with
    ``totals = [decoded OK, errored]`` (int32 tensor on ``device``).

    When the default process group exists (``parallel.mesh.distributed_init``),
    each process passes its own shard of the reads and ``totals`` is summed
    over every process with ``all_reduce``, as the JAX package's ``psum``
    over its data axis: all processes agree on the global counters."""
    dev = resolve_device(device)
    out = _decode_arrays(
        _resolve(engine, dev), dev, probs, lengths, threshold, beam_size,
        collapse,
    )
    ok = (out["err"] == errors.OK).sum(dtype=torch.int32)
    bad = (out["err"] != errors.OK).sum(dtype=torch.int32)
    totals = torch.stack([ok, bad])
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.all_reduce(totals)
    return out, totals


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
    device=None,
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
    resumes across the two packages: the engine may differ in name within
    its class (``utils.checkpoint.ENGINE_CLASSES["beam"]``: the JAX package's
    "pallas" and "fast" resume under the port's "cuda" and "fast").  Results
    are returned in input order.
    """
    from ..utils import profiling
    from ..utils.checkpoint import DecodeCheckpoint
    from ..utils.padding import bucket_reads

    if not reads:
        return []
    dev = resolve_device(device)
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

    ckpt = DecodeCheckpoint.load_or_create(checkpoint_path, meta, kind="beam")
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


def decode_many_crf(
    reads: Sequence,
    alphabet,
    *,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    batch_size: int = 256,
    engine: Optional[str] = None,
    device=None,
    checkpoint_path: Optional[str] = None,
) -> List[Tuple[str, List[int], int]]:
    """Checkpointable streaming CRF decode: ``decode_many`` for the CRF
    family.  ``reads`` entries are ``(posteriors [T, S, A+1], init_state
    [S])``; variable T rides power-of-two buckets (padded frames are masked
    by per-read lengths, padding rows decode empty).  The checkpoint's
    ``meta`` keys are the JAX package's, with the engine resolved for
    ``device``; a JAX-written checkpoint resumes here under any engine of
    its class (``utils.checkpoint.ENGINE_CLASSES["beam"]``: JAX's None for
    auto, "pallas" and "fast" under the port's "cuda" and "fast").
    Returns ``[(sequence, path, err_code)]`` in input order."""
    from ..utils import profiling
    from ..utils.checkpoint import DecodeCheckpoint

    if not reads:
        return []
    dev = resolve_device(device)
    engine = _resolve(engine, dev)
    edges = _auto_bucket_edges([r[0].shape[0] for r in reads])
    S = reads[0][0].shape[1]
    meta = {
        "crf": True,
        "bucket_edges": edges,
        "n_state": int(S),
        "beam_size": int(beam_size),
        "beam_cut_threshold": float(beam_cut_threshold),
        "engine": engine,
    }
    ckpt = DecodeCheckpoint.load_or_create(checkpoint_path, meta, kind="beam")
    try:
        if ckpt.cursor >= len(reads):
            return ckpt.results_in_order(len(reads))

        buckets: Dict[int, List[int]] = {}
        for i, r in enumerate(reads):
            e = next(e for e in edges if e >= r[0].shape[0])
            buckets.setdefault(e, []).append(i)

        A1 = reads[0][0].shape[2]
        bs = max(int(batch_size), 1)
        for edge, idxs in sorted(buckets.items()):
            todo = [i for i in idxs if i not in ckpt.done]
            if not todo:
                continue
            dec = BatchCrfBeamDecoder(
                alphabet, T=edge, n_state=S, beam_size=beam_size,
                beam_cut_threshold=beam_cut_threshold, engine=engine, device=dev,
            )
            profiling.log.info(
                "decode_many_crf: bucket T<=%d, %d reads, batch=%d",
                edge, len(todo), bs,
            )
            for s in range(0, len(todo), bs):
                chunk = todo[s : s + bs]
                n = len(chunk)
                with profiling.stage("decode_many_crf.pad"):
                    probs = np.zeros((bs, edge, S, A1), np.float32)
                    inits = np.zeros((bs, S), np.float32)
                    inits[:, 0] = 1.0  # padding rows decode empty (length 0)
                    lengths = np.zeros((bs,), np.int32)
                    for j, i in enumerate(chunk):
                        p, st = reads[i][0], reads[i][1]
                        probs[j, : p.shape[0]] = p
                        inits[j] = st
                        lengths[j] = p.shape[0]
                res = dec.decode(probs, inits, lengths)[:n]
                with profiling.stage("decode_many_crf.checkpoint"):
                    ckpt.record(chunk, res)
        return ckpt.results_in_order(len(reads))
    finally:
        ckpt.close()


# ---------------------------------------------------------------- duplex

DUPLEX_ENGINES = ("cuda", "fast", "exact")
#: bytes of exact-engine tree and band tables per call (one chunk of pairs)
EXACT_CHUNK_BYTES = 2_000_000_000


class DuplexBatch(NamedTuple):
    """A padded duplex batch prepared on the host, as the JAX package
    prepares it, with the static arguments of the engines."""

    l1: np.ndarray  # [B, T1, (S,) A+1] f32 log probabilities
    l2: np.ndarray  # [B, T2, (S,) A+1]
    root_gap: np.ndarray  # [B, Wr] f32 root bands
    lo: np.ndarray  # [B, T1] i32 clamped envelope
    hi: np.ndarray
    thr: np.float32  # log of the cut threshold
    init_states: np.ndarray  # [B] i32 (zeros for plain duplex)
    lengths: np.ndarray  # [B] i32
    needs_ext: bool  # slot engines: the upper bound grows after step 0
    W: int  # tree engines' band width
    tree_needs_ext: bool  # tree engines: the upper bound grows at all

    def tensors(self, device, s: slice = slice(None)):
        """(l1, l2, root_gap, lo, hi, thr, init_states, lengths) of pairs
        ``s`` with the arrays on ``device``."""
        dev = torch.device(device)
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x[s])).to(dev)  # noqa: E731
        return (put(self.l1), put(self.l2), put(self.root_gap), put(self.lo), put(self.hi),
                self.thr, put(self.init_states), put(self.lengths))

    def max_nodes(self, beam_size: int) -> int:
        """The tree engines' default per-pair budget (the JAX package's)."""
        return duplex_ops._duplex_max_nodes(
            self.lo.shape[1], int(beam_size), self.l1.shape[-1] - 1, self.W
        )


def prep_duplex_batch(net1, net2, envelopes, lengths, threshold, *, T1, T2, init1=None,
                      init2=None) -> DuplexBatch:
    """Host preparation of a duplex batch, shared by every duplex entry point.

    net1 [B, T1, (S,) A+1], net2 [B, T2, (S,) A+1] linear probabilities
    (numpy or tensors); ``envelopes`` None (the full range of read 2),
    ``[T1, 2]`` (one envelope shared by the batch) or ``[B, T1, 2]``;
    ``lengths`` [B] (None = T1); ``init1``/``init2`` [B, S] for CRF.  The
    log conversion and the root bands (cumsum, or the CRF blank-state walk)
    run on the host in numpy f32, as in the JAX package, so both packages
    see the same inputs bit for bit."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    net1, net2 = host(net1), host(net2)
    B = net1.shape[0]
    shared_env = envelopes is None or host(envelopes).ndim == 2
    if envelopes is None:
        envelopes = np.zeros((T1, 2), np.int64)
        envelopes[:, 1] = T2
    envelopes = host(envelopes).astype(np.int64)
    if shared_env:
        envelopes = np.broadcast_to(envelopes, (B, T1, 2))
    lengths = np.full((B,), T1, np.int32) if lengths is None else host(lengths).astype(np.int32)
    l1, l2, thr = duplex_fast_ops.log_inputs(net1, net2, threshold)
    lo = np.zeros((B, T1), np.int32)
    hi = np.zeros((B, T1), np.int32)
    eps = [duplex_fast_ops._prep_envelope_fast(envelopes[b], T2)
           for b in range(1 if shared_env else B)]
    for b, ep in enumerate(eps):
        lo[b], hi[b] = ep.lo, ep.hi
    if shared_env:
        lo[:], hi[:] = lo[0], hi[0]
    wr_b = np.minimum(np.maximum(envelopes[:, 0, 1], 0), T2) + 1 if T1 else np.ones(B, np.int64)
    Wr = int(max(wr_b.max(), 1)) if B else 1
    if init1 is None:
        root_gap = duplex_fast_ops.root_gap_host(l2, wr_b, Wr)
        init_states = np.zeros((B,), np.int32)
    else:
        root_gap = duplex_fast_ops.crf_root_gap_host(l2, host(init2), wr_b, Wr)
        init_states = np.argmax(host(init1).astype(np.float32), axis=1).astype(np.int32)
    return DuplexBatch(
        l1, l2, root_gap, lo, hi, thr, init_states, lengths,
        needs_ext=any(ep.needs_ext for ep in eps),
        W=max((ep.W for ep in eps), default=1),
        tree_needs_ext=any(bool(np.any(ep.hi[1:] > ep.hi[:-1])) for ep in eps),
    )


def auto_duplex_engine(lo, hi, device, beam_size: int, *, crf: bool = False) -> str:
    """Parity-first engine choice of the duplex decoders and the API, from the
    clamped ``[B, T1]`` bounds (numpy).

    A moving window goes to "exact": only band reuse is bit-exact there.  A
    constant window goes to "fast" on the CPU; on a CUDA device to the slot
    kernel ("cuda") when its shared memory holds the band, and otherwise to
    "exact": the tree kernel gives the same sequences and keeps its bands in
    global memory.  A CRF constant window on a CUDA device goes to "exact"
    too (there is no CRF slot kernel, and the CRF tree kernel gives the CRF
    slot engine's sequences and statuses on constant windows).  Past the
    lane bound both kernels share (beam_size * A > 32) the chosen kernel
    raises ValueError."""
    constant = lo.size == 0 or bool(np.all(lo == lo[0, 0]) and np.all(hi == hi[0, 0]))
    if not constant:
        return "exact"
    if torch.device(device).type != "cuda":
        return "fast"
    if crf:
        return "exact"
    Wk = duplex_cuda.band_width(torch.from_numpy(lo), torch.from_numpy(hi))
    return "cuda" if duplex_cuda.fits_shared_memory(int(beam_size), Wk) else "exact"


def run_duplex_engine(engine, batch: DuplexBatch, device, *, beam_size, collapse, crf,
                      max_nodes=None):
    """Decode a prepared batch with ``engine`` on ``device``: the result dict
    (labels_rev [B, T1], count [B], err [B]; int32 tensors on ``device``).

      - "cuda": the slot kernel, then the 1D traceback kernel (plain only);
      - "fast": the plain slot engine;
      - "exact": the tree kernel on CUDA, the plain tree engine on the CPU,
        in chunks whose tables (bytes per pair: N*W*8 for the bands plus the
        tree) stay within ``EXACT_CHUNK_BYTES``.  ``max_nodes`` defaults to
        the JAX package's budget, so a pair overflows (NODE_OVERFLOW) exactly
        where it does there."""
    K = int(beam_size)
    if engine != "exact":
        l1, l2, rg, lo, hi, thr, init, ln = batch.tensors(device)
        if engine == "cuda":
            return duplex_cuda.duplex_kernel_batch(
                l1, l2, rg, lo, hi, thr, ln, beam_size=K, collapse_repeats=collapse,
                needs_ext=batch.needs_ext,
            )
        return duplex_fast_ops.duplex_fast_batch(
            l1, l2, rg, lo, hi, thr, init, ln, beam_size=K, collapse_repeats=collapse,
            needs_ext=batch.needs_ext, crf=crf,
        )
    dev = torch.device(device)
    N = batch.max_nodes(K) if max_nodes is None else int(max_nodes)
    A = batch.l1.shape[-1] - 1
    B = batch.lo.shape[0]
    per_pair = 4 * duplex_exact_cuda.scratch_stride(N, K, A, batch.W)
    chunk = max(int(EXACT_CHUNK_BYTES // per_pair), 1)
    fn = (
        duplex_exact_cuda.duplex_exact_kernel_batch
        if dev.type == "cuda"
        else duplex_ops.duplex_exact_batch
    )
    outs = [
        fn(*batch.tensors(dev, slice(s, s + chunk)), beam_size=K, collapse_repeats=collapse,
           max_nodes=N, W=batch.W, needs_ext=batch.tree_needs_ext, crf=crf)
        for s in range(0, max(B, 1), chunk)
    ]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _assemble_duplex(out, B0, alphabet):
    """Duplex result assembly: [(sequence, err_code)] per pair (duplex
    returns no path, matching the reference — src/duplex.rs:638-649)."""
    from ..native import detokenize_batch

    out = {k: v.cpu().numpy() for k, v in out.items()}
    counts = np.where(out["err"] == errors.OK, out["count"], 0).astype(np.int32)
    seqs = detokenize_batch(out["labels_rev"], counts, alphabet[1:], reverse=True)
    return [
        (s if int(e) == errors.OK else "", int(e))
        for s, e in zip(seqs[:B0], out["err"][:B0])
    ]


class BatchDuplexDecoder:
    """Batched 2-D duplex pair-consensus decoder on one device.

    Static shapes per batch: T1, T2 (bucket upstream).  Envelopes: None
    (full range), a shared ``[T1, 2]`` array, or per-pair ``[B, T1, 2]``.

    ``engine``:
      - None (auto, parity-first; ``auto_duplex_engine``): constant-window
        envelopes run the slot kernel ("cuda") on a CUDA device, or the tree
        kernel where the slot kernel's shared memory cannot hold the band,
        and the plain slot engine ("fast") on the CPU; moving windows run
        the exact tree engine.
      - "cuda": the hand-written slot kernel (``ops/duplex_cuda.py``); CUDA
        only, and ValueError outside its envelope class (non-decreasing lower
        bounds) or bounds, as the JAX package's "pallas" engine.
      - "fast": the plain slot engine (``ops/duplex_fast.py``) on any device.
        Both slot engines rebuild a re-derived prefix's band over the current
        window, measurably different from the reference on moving windows.
      - "exact": the band-reuse tree engine, bit-exact against the reference:
        the tree kernel (``ops/duplex_exact_cuda.py``) on CUDA, the plain
        engine (``ops/duplex.py``) on the CPU.
    """

    def __init__(
        self,
        alphabet,
        T1: int,
        T2: int,
        beam_size: int = 5,
        beam_cut_threshold: float = 0.0,
        collapse_repeats: bool = True,
        engine: Optional[str] = None,
        device=None,
    ):
        self.alphabet = normalize_alphabet(alphabet)
        self.T1, self.T2 = int(T1), int(T2)
        self.beam_size = int(beam_size)
        self.threshold = float(beam_cut_threshold)
        self.collapse = bool(collapse_repeats)
        self.device = resolve_device(device)
        if engine not in (None, *DUPLEX_ENGINES):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "cuda" and self.device.type != "cuda":
            raise ValueError(f"engine 'cuda' needs a CUDA device, got {self.device}")
        self.engine = engine

    def decode_arrays(self, net1, net2, envelopes=None, lengths=None):
        """Device decode only: the fixed-width result dict (labels_rev
        [B, T1], count, err; int32 tensors on ``device``)."""
        return self._decode(net1, net2, envelopes, lengths)[0]

    def decode(self, net1, net2, envelopes=None, lengths=None) -> List[Tuple[str, int]]:
        """net1 [B, T1, A+1], net2 [B, T2, A+1] linear probabilities (numpy
        or tensors).  Returns [(sequence, err_code)] per pair; a pair that
        fails keeps its status code and an empty sequence."""
        from ..utils import profiling

        with profiling.stage("duplex.device", reads=int(net1.shape[0])):
            out, B0 = self._decode(net1, net2, envelopes, lengths)
            out = {k: v.cpu() for k, v in out.items()}
        with profiling.stage("duplex.detok"):
            return _assemble_duplex(out, B0, self.alphabet)

    def _decode(self, net1, net2, envelopes, lengths):
        batch = prep_duplex_batch(net1, net2, envelopes, lengths, self.threshold,
                                  T1=self.T1, T2=self.T2)
        engine = self.engine or auto_duplex_engine(batch.lo, batch.hi, self.device,
                                                   self.beam_size)
        out = run_duplex_engine(engine, batch, self.device, beam_size=self.beam_size,
                                collapse=self.collapse, crf=False)
        return out, batch.lo.shape[0]


class BatchCrfDuplexDecoder:
    """Batched 2-D CRF duplex pair-consensus decoder on one device
    (reference duplex.rs:652-834).

    Inputs per batch: ``net1 [B, T1, S, A+1]``, ``init1 [B, S]``,
    ``net2 [B, T2, S, A+1]``, ``init2 [B, S]`` linear probabilities, plus
    optional envelopes (None = full range, ``[T1, 2]`` shared, or
    ``[B, T1, 2]`` per-pair) and ``lengths [B]``.

    ``engine`` mirrors ``BatchDuplexDecoder``'s parity-first policy:
      - None (auto): on a CUDA device, every envelope runs the CRF tree
        kernel (there is no CRF slot kernel, nor has the JAX package one; on
        constant windows the tree gives the CRF slot engine's sequences and
        statuses); on the CPU, constant-window envelopes run the plain CRF
        slot engine (sequence-exact there) and moving windows the plain tree
        engine.
      - "fast": the plain CRF slot engine everywhere.
      - "exact": the tree engine: the CRF tree kernel on CUDA, the plain
        engine on the CPU.
    """

    def __init__(
        self,
        alphabet,
        T1: int,
        T2: int,
        n_state: int,
        beam_size: int = 5,
        beam_cut_threshold: float = 0.0,
        engine: Optional[str] = None,
        device=None,
    ):
        self.alphabet = normalize_alphabet(alphabet)
        self.T1, self.T2 = int(T1), int(T2)
        self.S = int(n_state)
        self.beam_size = int(beam_size)
        self.threshold = float(beam_cut_threshold)
        self.device = resolve_device(device)
        if engine not in (None, "fast", "exact"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine

    def decode_arrays(self, net1, init1, net2, init2, envelopes=None, lengths=None):
        """Device decode only: the fixed-width result dict on ``device``."""
        return self._decode(net1, init1, net2, init2, envelopes, lengths)[0]

    def decode(self, net1, init1, net2, init2, envelopes=None, lengths=None):
        """Returns [(sequence, err_code)] per pair."""
        from ..utils import profiling

        with profiling.stage("crf_duplex.device", reads=int(net1.shape[0])):
            out, B0 = self._decode(net1, init1, net2, init2, envelopes, lengths)
            out = {k: v.cpu() for k, v in out.items()}
        with profiling.stage("crf_duplex.detok"):
            return _assemble_duplex(out, B0, self.alphabet)

    def _decode(self, net1, init1, net2, init2, envelopes, lengths):
        batch = prep_duplex_batch(net1, net2, envelopes, lengths, self.threshold,
                                  T1=self.T1, T2=self.T2, init1=init1, init2=init2)
        engine = self.engine or auto_duplex_engine(batch.lo, batch.hi, self.device,
                                                   self.beam_size, crf=True)
        out = run_duplex_engine(engine, batch, self.device, beam_size=self.beam_size,
                                collapse=False, crf=True)
        return out, batch.lo.shape[0]


def _constant_window(envelope) -> bool:
    """True for no envelope (the full range) or one whose rows are all equal."""
    if envelope is None:
        return True
    env = np.asarray(envelope)
    return bool(np.all(env == env[:1]))


def decode_many_duplex(
    pairs: Sequence,
    alphabet,
    *,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    collapse_repeats: bool = True,
    batch_size: int = 64,
    engine: Optional[str] = None,
    device=None,
    checkpoint_path: Optional[str] = None,
) -> List[Tuple[str, int]]:
    """Decode a long list of read pairs with checkpoint/resume — the duplex
    analog of ``decode_many``.

    ``pairs`` entries are ``(net1, net2)`` or ``(net1, net2, envelope)``
    with per-pair ``[T1, 2]`` envelopes (None/omitted = full range).  Pairs
    are grouped into (T1, T2) power-of-two buckets, one decoder per bucket.
    Padding frames never leak into a decode: read 1 rides per-pair
    ``lengths``, read 2 rides the per-pair envelope (capped at the true T2).
    Results ``[(sequence, err_code)]`` return in input order; the JSONL
    checkpoint's ``meta`` keys and values are the JAX package's (``engine``
    as given, None for auto), so a JAX-written checkpoint resumes here, under
    any engine of its class (``utils.checkpoint.ENGINE_CLASSES``: JAX's
    "exact-pallas" as "exact"; the slot engines "pallas", "cuda" and "fast"
    as one another when every pair's window is constant).
    """
    from ..utils import profiling
    from ..utils.checkpoint import DecodeCheckpoint

    if not pairs:
        return []
    device = resolve_device(device)
    e1s = _auto_bucket_edges([p[0].shape[0] for p in pairs])
    e2s = _auto_bucket_edges([p[1].shape[0] for p in pairs])

    def edge_for(T, edges):
        return next(e for e in edges if e >= T)

    meta = {
        "duplex": True,
        "bucket_edges": [e1s, e2s],
        "beam_size": int(beam_size),
        "beam_cut_threshold": float(beam_cut_threshold),
        "collapse_repeats": bool(collapse_repeats),
        "engine": engine,
    }
    constant = all(_constant_window(p[2] if len(p) > 2 else None) for p in pairs)
    ckpt = DecodeCheckpoint.load_or_create(
        checkpoint_path, meta, kind="duplex" if constant else "duplex_moving")
    try:
        if ckpt.cursor >= len(pairs):
            return [(s, e) for s, _, e in ckpt.results_in_order(len(pairs))]

        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, p in enumerate(pairs):
            key = (edge_for(p[0].shape[0], e1s), edge_for(p[1].shape[0], e2s))
            buckets.setdefault(key, []).append(i)

        A1 = pairs[0][0].shape[1]
        bs = max(int(batch_size), 1)
        for (edge1, edge2), idxs in sorted(buckets.items()):
            todo = [i for i in idxs if i not in ckpt.done]
            if not todo:
                continue
            dec = BatchDuplexDecoder(
                alphabet, T1=edge1, T2=edge2, beam_size=beam_size,
                beam_cut_threshold=beam_cut_threshold, collapse_repeats=collapse_repeats,
                engine=engine, device=device,
            )
            profiling.log.info(
                "decode_many_duplex: bucket T1<=%d T2<=%d, %d pairs, batch=%d",
                edge1, edge2, len(todo), bs,
            )
            for s in range(0, len(todo), bs):
                chunk = todo[s : s + bs]
                n = len(chunk)
                with profiling.stage("decode_many_duplex.pad"):
                    n1 = np.zeros((n, edge1, A1), np.float32)
                    n2 = np.zeros((n, edge2, A1), np.float32)
                    envs = np.zeros((n, edge1, 2), np.int64)
                    lengths = np.zeros((n,), np.int32)
                    for j, i in enumerate(chunk):
                        p = pairs[i]
                        len1, len2 = p[0].shape[0], p[1].shape[0]
                        n1[j, :len1] = p[0]
                        n2[j, :len2] = p[1]
                        lengths[j] = len1
                        env = p[2] if len(p) > 2 else None
                        if env is None:
                            envs[j, :, 1] = len2  # full range of read 2
                        else:
                            env = np.asarray(env)
                            envs[j, :len1] = env
                            # rows past len1 are masked by `lengths`, but
                            # must stay monotone-valid: repeat the last row
                            envs[j, len1:] = env[len1 - 1 : len1]
                res = dec.decode(n1, n2, envelopes=envs, lengths=lengths)[:n]
                with profiling.stage("decode_many_duplex.checkpoint"):
                    # checkpoint rows are (seq, path, err); duplex has no
                    # path (reference contract), stored as []
                    ckpt.record(chunk, [(sq, [], er) for sq, er in res])
        return [(s, e) for s, _, e in ckpt.results_in_order(len(pairs))]
    finally:
        ckpt.close()
