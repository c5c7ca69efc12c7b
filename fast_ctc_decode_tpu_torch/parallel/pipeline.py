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
from ..device import resolve_device, with_index
from ..ops import duplex as duplex_ops
from ..ops import duplex_cuda
from ..ops import duplex_exact_cuda
from ..ops import duplex_fast as duplex_fast_ops
from ..ops import engines
from ..ops import viterbi as viterbi_ops
from ..utils import profiling
from ..utils.checkpoint import DecodeCheckpoint
from ..utils.padding import edge_holding, pad_batch

ENGINES = ("cuda", "fast", "exact")


def _resolve(engine: Optional[str], device: torch.device) -> str:
    if engine is None:
        engine = "cuda" if device.type == "cuda" else "fast"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "cuda" and device.type != "cuda":
        raise ValueError(f"engine 'cuda' needs a CUDA device, got {device}")
    return engine


def _decode_arrays(engine, device, probs, lengths, threshold, beam_size, *, collapse=True,
                   max_nodes=None, init_states=None):
    """Move a batch to ``device`` and run ``engine`` on it (the CRF engine
    with ``init_states``): the raw dict, without waiting for the device.
    Stages ``<path>.upload`` and ``<path>.launch``, ``<path>`` "crf" with
    init states and "beam" without.  "cuda" is the hash kernel, "fast" the
    plain hash engine on every device, "exact" the tree kernel on a CUDA
    device and the plain tree engine elsewhere (``ops/engines.py``)."""
    path = "beam" if init_states is None else "crf"
    with profiling.stage(f"{path}.upload"):
        probs = torch.as_tensor(probs, dtype=torch.float32, device=device).contiguous()
        if init_states is not None:
            init_states = torch.as_tensor(init_states, dtype=torch.float32,
                                          device=device).contiguous()
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device).contiguous()
    tree = engine == "exact"
    with profiling.stage(f"{path}.launch"):
        return engines.beam_batch(
            probs, lengths, np.float32(threshold), beam_size=beam_size, tree=tree,
            kernel=(device.type == "cuda") if tree else (engine == "cuda"),
            init_states=init_states, collapse_repeats=collapse, max_nodes=max_nodes,
        )


def _fetch(out, path):
    """A device decode's result dict brought home as numpy arrays: stage
    ``<path>.wait`` holds the kernels' remaining time (a sync of the current
    stream of each CUDA device holding a result, empty elsewhere),
    ``<path>.fetch`` the copies."""
    with profiling.stage(f"{path}.wait"):
        for dev in {v.device for v in out.values() if v.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
    with profiling.stage(f"{path}.fetch"):
        return {k: v.cpu().numpy() for k, v in out.items()}


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
    ``max_nodes`` is the exact engine's per-read tree budget (None, the
    default: the worst case for each batch's T, ``beam.default_max_nodes``);
    the other engines ignore it, as in the JAX package.
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
        self.max_nodes = None if max_nodes is None else int(max_nodes)

    def decode_arrays(self, probs, lengths):
        """Device decode only: the fixed-width result dict (labels_rev,
        times_rev, count, err; int32 tensors on ``device``)."""
        return _decode_arrays(self.engine, self.device, probs, lengths, self.threshold,
                              self.beam_size, collapse=self.collapse, max_nodes=self.max_nodes)

    def decode(self, probs, lengths) -> List[Tuple[str, List[int], int]]:
        """Full decode: returns [(sequence, path, err_code)] per read.
        Reads that fail keep their status code instead of raising, so one
        bad read cannot abort a batch.  String assembly uses the native C++
        detokenizer when available.  Per-stage wall times land in
        ``utils.profiling.METRICS``."""
        with profiling.stage("beam.device"):
            out = _fetch(self.decode_arrays(probs, lengths), "beam")
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

    def decode_arrays(self, probs, init_states, lengths):
        """Device decode only: the fixed-width result dict (labels_rev,
        times_rev, count, err; int32 tensors on ``device``)."""
        return _decode_arrays(self.engine, self.device, probs, lengths, self.threshold,
                              self.beam_size, init_states=init_states)

    def decode(self, probs, init_states, lengths) -> List[Tuple[str, List[int], int]]:
        """Returns [(sequence, path, err_code)] per read; per-stage wall
        times land in ``utils.profiling.METRICS``."""
        with profiling.stage("crf.device"):
            out = _fetch(self.decode_arrays(probs, init_states, lengths), "crf")
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
    out = _decode_arrays(_resolve(engine, dev), dev, probs, lengths, threshold, beam_size,
                         collapse=collapse)
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


def _stream(call, items, batch_size, checkpoint_path, meta, kind, *, key, decoder, pad,
            noun="reads", to_rows=None):
    """The per-batch loop of the ``decode_many*`` streams: ``items``' rows
    ``(sequence, path, err_code)`` in input order, with those the JSONL
    checkpoint at ``checkpoint_path`` (``meta``, ``kind``) already holds
    decoded no more.  Items are grouped by ``key(i)`` (stage
    ``<call>.bucket``), each group decoded in sorted key order by one
    ``decoder(key)``, ``batch_size`` items at a time: ``pad(key, chunk,
    batch_size)`` makes the decoder's arguments (stage ``<call>.pad``), the
    decoder's rows (through ``to_rows`` where given) go to the checkpoint
    (stage ``<call>.checkpoint``)."""
    bs = max(int(batch_size), 1)
    ckpt = DecodeCheckpoint.load_or_create(checkpoint_path, meta, kind=kind)
    try:
        if ckpt.cursor >= len(items):
            profiling.log.info("%s: all %d %s already in checkpoint", call, len(items), noun)
            return ckpt.results_in_order(len(items))

        buckets: Dict = {}
        with profiling.stage(f"{call}.bucket"):
            for i in range(len(items)):
                buckets.setdefault(key(i), []).append(i)
        for k, idxs in sorted(buckets.items()):
            todo = [i for i in idxs if i not in ckpt.done]
            if not todo:
                continue
            dec = decoder(k)
            where = "T1<=%d T2<=%d" % k if isinstance(k, tuple) else f"T<={k}"
            profiling.log.info("%s: bucket %s, %d %s, batch=%d", call, where, len(todo), noun, bs)
            for s in range(0, len(todo), bs):
                chunk = todo[s : s + bs]
                with profiling.stage(f"{call}.pad"):
                    args = pad(k, chunk, bs)
                res = dec.decode(*args)[: len(chunk)]
                with profiling.stage(f"{call}.checkpoint"):
                    rows = res if to_rows is None else to_rows(res)
                    ckpt.record(chunk, rows)
                bad = sum(1 for r in rows if r[2] != errors.OK)
                if bad:
                    profiling.log.warning(
                        "%s: %d/%d %s errored in batch", call, bad, len(chunk), noun
                    )
        profiling.log.info(
            "%s: %d %s done; stage seconds: %s", call, len(items), noun,
            {k: round(v, 3) for k, v in profiling.METRICS.stages.items()},
        )
        return ckpt.results_in_order(len(items))
    finally:
        ckpt.close()


@profiling.stage("decode_many")
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
    bounded (<= 2x) padding waste.  Each bucket is decoded in batches of at
    most ``batch_size`` reads on ``device`` (a bucket's last batch holds only
    its own reads, no padding rows) and results are appended to the
    JSONL checkpoint per batch: a preempted run restarted with the same
    ``checkpoint_path`` resumes at exactly the undecoded reads.  The
    checkpoint format and its ``meta`` keys are the JAX package's, so a run
    resumes across the two packages: the engine may differ in name within
    its class (``utils.checkpoint.ENGINE_CLASSES["beam"]``: the JAX package's
    "pallas" and "fast" resume under the port's "cuda" and "fast").  Results
    are returned in input order.
    """
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

    def pad(edge, chunk, bs):
        # one row a read of the chunk, zeros past its end: a bucket's last
        # batch carries no padding rows to upload, decode and fetch (a read
        # decodes the same in a batch of any size)
        return pad_batch([reads[i] for i in chunk], T=edge)

    return _stream(
        "decode_many", reads, batch_size, checkpoint_path, meta, "beam",
        key=lambda i: edge_holding(reads[i].shape[0], edges),
        decoder=lambda edge: BatchBeamDecoder(
            alphabet, T=edge, beam_size=beam_size, beam_cut_threshold=beam_cut_threshold,
            collapse_repeats=collapse_repeats, engine=engine, device=dev,
        ),
        pad=pad,
    )


def _on(x, device: torch.device) -> bool:
    """Whether ``x`` is a tensor on ``device`` (an index-less ``cuda`` is the
    current card)."""
    return isinstance(x, torch.Tensor) and with_index(x.device) == with_index(device)


#: the most elements one ``torch.cat`` writes in one batched kernel: PyTorch
#: indexes a concatenation's output in 32 bits, and past that copies input by
#: input
_CAT_ELEMENTS = 2**31 - 1


def _copy_rows(dst, srcs):
    """Copy each of ``srcs`` into the leading entries of its row of ``dst``.
    Runs of sources that fill their row whole (float32 tensors on ``dst``'s
    device) are written by one ``torch.cat`` a run of at most
    ``_CAT_ELEMENTS``, so a batch of whole chunks costs a few device
    operations, not one a read; any other source gets a copy of its own."""
    row = dst[0].numel()
    group = max(1, _CAT_ELEMENTS // max(row, 1))
    whole = [isinstance(x, torch.Tensor) and x.shape == dst.shape[1:]
             and x.dtype == dst.dtype and x.device == dst.device for x in srcs]
    j = 0
    while j < len(srcs):
        k = j
        while k < len(srcs) and whole[k] and k - j < group:
            k += 1
        if k > j:
            torch.cat(srcs[j:k], out=dst[j:k].view(-1, *dst.shape[2:]))
            j = k
        else:
            x = torch.as_tensor(srcs[j])
            dst[j, : x.shape[0]].copy_(x)
            j += 1


def _rows_of_one_tensor(xs, shape, device):
    """``xs`` as one ``[len(xs), *shape]`` view of the tensor whose
    consecutive rows they are, or None.  It is a view where every entry is a
    contiguous float32 tensor on ``device`` of exactly ``shape``, all share
    one storage, and entry j starts j rows after the first: the view's
    elements are then the entries' own, in order.  (``data_ptr()`` stands in
    for ``storage_offset()``: in one storage and dtype they step together,
    and it is the cheaper call.)"""
    first = xs[0]
    if not _on(first, device) or first.numel() == 0:
        return None
    row = first.numel()
    ptr, step = first.data_ptr(), row * first.element_size()
    storage = first.untyped_storage().data_ptr()
    for j, x in enumerate(xs):
        if not (isinstance(x, torch.Tensor) and x.data_ptr() == ptr + j * step
                and x.shape == shape and x.is_contiguous() and x.dtype is torch.float32
                and x.untyped_storage().data_ptr() == storage):
            return None
    return torch.as_strided(first, (len(xs), *shape), (row, *first.stride()),
                            first.storage_offset())


def _crf_in_place(device, reads, chunk, edge: int):
    """``decode_many_crf``'s batch of ``chunk`` read where it lies, or None:
    where the reads' posteriors are consecutive whole rows of one tensor on
    ``device`` (each ``[edge, S, A+1]``, as a network's output batch unbound
    holds them), ``(probs [n, edge, S, A+1], inits [n, S], lengths [n],
    written bytes)``.  ``probs`` is a view of the caller's tensor, the init
    states one of theirs where they are consecutive rows too, else stacked
    on ``device`` (the only bytes written), and every length is ``edge``.
    The batch has no padding rows: each read decodes as in a padded batch."""
    first = reads[chunk[0]][0]
    if not isinstance(first, torch.Tensor) or first.dim() != 3:
        return None
    S, A1 = first.shape[1:]
    probs = _rows_of_one_tensor([reads[i][0] for i in chunk], (edge, S, A1), device)
    if probs is None:
        return None
    n = len(chunk)
    inits = _rows_of_one_tensor([reads[i][1] for i in chunk], (S,), device)
    written = 0
    if inits is None:
        rows = [torch.as_tensor(reads[i][1], dtype=torch.float32, device=device) for i in chunk]
        if any(r.shape != (S,) for r in rows):
            return None
        inits = torch.stack(rows)
        written = inits.numel() * inits.element_size()
    lengths = torch.full((n,), edge, dtype=torch.int32, device=device)
    return probs, inits, lengths, written


def _pad_crf(device, reads, chunk, bs: int, edge: int):
    """``decode_many_crf``'s pad of ``chunk``: ``[bs, edge, S, A+1]`` float32
    posteriors, ``[bs, S]`` float32 init states and ``[bs]`` int32 lengths in
    torch buffers (zeros past each read's end; padding rows of length 0 with
    init state ``e_0``).  The buffers lie where the reads lie: on ``device``
    when every posterior of the batch is a tensor there, so that none goes
    through the host, else on the host, for the decoder to upload.  A batch
    of consecutive whole rows of one tensor never comes here:
    ``_crf_in_place`` decodes it in place."""
    on = device if all(_on(reads[i][0], device) for i in chunk) else torch.device("cpu")
    S, A1 = reads[chunk[0]][0].shape[1:]
    Ts = [int(reads[i][0].shape[0]) for i in chunk]
    lengths = torch.tensor(Ts + [0] * (bs - len(chunk)), dtype=torch.int32, device=on)
    probs = torch.zeros((bs, edge, S, A1), dtype=torch.float32, device=on)
    inits = torch.zeros((bs, S), dtype=torch.float32, device=on)
    inits[:, 0] = 1.0  # padding rows decode empty (length 0)
    _copy_rows(probs, [reads[i][0] for i in chunk])
    _copy_rows(inits, [reads[i][1] for i in chunk])
    return probs, inits, lengths


@profiling.stage("decode_many_crf")
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
    by per-read lengths, padding rows decode empty).  A batch whose reads'
    posteriors are consecutive whole rows of one float32 tensor on
    ``device``, each of its bucket's length (a network's output batch,
    unbound in order), is decoded in place: the decoder reads the caller's
    tensor through a view and nothing is copied (the init states are stacked
    unless they are consecutive rows too); the caller's tensors are only
    read.  Any other batch is padded where its reads lie
    (``_pad_crf``): on ``device`` when every posterior is a tensor there,
    with no copy through the host, else on the host.  Both give the same
    results for the same values.  The counters
    ``decode_many_crf.frames``, ``decode_many_crf.moved_bytes`` and
    ``decode_many_crf.in_place_frames`` (``utils.profiling``) add what each
    batch decodes, what it copies into buffers, and what it decodes in
    place.  The checkpoint's ``meta`` keys are the JAX package's, with the
    engine resolved for ``device``; a JAX-written checkpoint resumes here
    under any engine of its class
    (``utils.checkpoint.ENGINE_CLASSES["beam"]``: JAX's None for auto,
    "pallas" and "fast" under the port's "cuda" and "fast").
    Returns ``[(sequence, path, err_code)]`` in input order."""
    if not reads:
        return []
    dev = resolve_device(device)
    engine = _resolve(engine, dev)
    edges = _auto_bucket_edges([r[0].shape[0] for r in reads])
    S, A1 = reads[0][0].shape[1:]
    meta = {
        "crf": True,
        "bucket_edges": edges,
        "n_state": int(S),
        "beam_size": int(beam_size),
        "beam_cut_threshold": float(beam_cut_threshold),
        "engine": engine,
    }

    def pad(edge, chunk, bs):
        batch = _crf_in_place(dev, reads, chunk, edge)
        if batch is not None:
            probs, inits, lengths, moved = batch
            frames = len(chunk) * edge
            profiling.count("decode_many_crf.in_place_frames", frames)
        else:
            probs, inits, lengths = _pad_crf(dev, reads, chunk, bs, edge)
            frames = sum(int(reads[i][0].shape[0]) for i in chunk)
            moved = 4 * (frames * S * A1 + len(chunk) * S)
        profiling.count("decode_many_crf.frames", frames)
        profiling.count("decode_many_crf.moved_bytes", moved)
        return probs, inits, lengths

    return _stream(
        "decode_many_crf", reads, batch_size, checkpoint_path, meta, "beam",
        key=lambda i: edge_holding(reads[i][0].shape[0], edges),
        decoder=lambda edge: BatchCrfBeamDecoder(
            alphabet, T=edge, n_state=S, beam_size=beam_size,
            beam_cut_threshold=beam_cut_threshold, engine=engine, device=dev,
        ),
        pad=pad,
    )


# ---------------------------------------------------------------- duplex

DUPLEX_ENGINES = ("cuda", "fast", "exact")
#: bytes of exact-engine tree and band tables per call (one chunk of pairs)
#: of the plain engine on the CPU (the JAX package's sizing for TPU HBM)
EXACT_CHUNK_BYTES = 2_000_000_000
#: share of the card's free memory that the tree kernel's scratch may take
#: in one launch (the rest is left to fragmentation and other streams)
EXACT_FREE_SHARE = 0.9


class DuplexBatch(NamedTuple):
    """A padded duplex batch prepared as the JAX package prepares it, with
    the static arguments of the engines.  Its arrays are host numpy arrays,
    except where ``prep_duplex_batch`` prepared a batch on its device: there
    ``l1``, ``l2`` and ``init_states`` are tensors on that device."""

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
        ``s`` with the arrays on ``device``; a tensor already there is
        sliced, not copied."""
        dev = torch.device(device)

        def put(x):
            if isinstance(x, torch.Tensor):
                return x[s].to(dev).contiguous()
            return torch.from_numpy(np.ascontiguousarray(x[s])).to(dev)

        return (put(self.l1), put(self.l2), put(self.root_gap), put(self.lo), put(self.hi),
                self.thr, put(self.init_states), put(self.lengths))

    def max_nodes(self, beam_size: int) -> int:
        """The tree engines' default per-pair budget (the JAX package's)."""
        return duplex_ops._duplex_max_nodes(
            self.lo.shape[1], int(beam_size), self.l1.shape[-1] - 1, self.W
        )

    def nbytes(self, device=None) -> int:
        """Bytes the batch still adds on ``device``: its arrays (those not
        already there; every one for None), with the engines' outputs
        (labels_rev [B, T1], count, err; int32) twice: the chunks' and their
        concatenation."""
        B, T1 = self.lo.shape
        arrays = (self.l1, self.l2, self.root_gap, self.lo, self.hi, self.init_states,
                  self.lengths)
        on = (lambda x: False) if device is None else (lambda x: _on(x, torch.device(device)))
        return sum(x.nbytes for x in arrays if not on(x)) + 2 * 4 * B * (T1 + 2)


class LogScores(NamedTuple):
    """A CRF duplex batch's scores already in log space, on the device that
    decodes them: ``[B, T, S, A+1]`` float32, ``log(0) = -inf`` past each
    read's end (``decode_many_crf_duplex``'s pad on the card makes them)."""

    logs: torch.Tensor


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def prep_duplex_batch(net1, net2, envelopes, lengths, threshold, *, T1, T2, init1=None,
                      init2=None) -> DuplexBatch:
    """Preparation of a duplex batch, shared by every duplex entry point.

    net1 [B, T1, (S,) A+1], net2 [B, T2, (S,) A+1] linear probabilities
    (numpy or tensors); ``envelopes`` None (the full range of read 2),
    ``[T1, 2]`` (one envelope shared by the batch) or ``[B, T1, 2]``;
    ``lengths`` [B] (None = T1); ``init1``/``init2`` [B, S] for CRF.  The
    log conversion and the root bands (cumsum, or the CRF blank-state walk)
    run on the host in numpy f32, as in the JAX package, so both packages
    see the same inputs bit for bit; except that CRF logs (of both reads and
    of the threshold) are the correctly rounded float32 ones, taken in
    float64 and rounded once, on every path, so that a CRF pair decodes
    alike wherever its scores lie (numpy's float32 ``log``, the JAX
    package's, is a few ulps off it on about a fifth of arguments).

    CRF scores given as ``LogScores`` (both reads, with ``init1``/``init2``
    tensors on their device) are prepared where they lie: ``l1``, ``l2``
    are those tensors, the init states' argmax (the first maximum, as
    ``np.argmax``) is taken there, and of the root bands only the blank
    entries the walk reads (``B x (Wr - 1)`` floats) come home, to be summed
    in order as ``crf_root_gap_host`` sums them.  The envelopes are clamped
    on the host in both cases."""
    if isinstance(net1, LogScores):
        l1, l2 = net1.logs, net2.logs
        thr = duplex_fast_ops.log_threshold(threshold, rounded_once=True)
    else:
        l1, l2, thr = duplex_fast_ops.log_inputs(_host(net1), _host(net2), threshold,
                                                 rounded_once=init1 is not None)
    B = l1.shape[0]
    shared_env = envelopes is None or _host(envelopes).ndim == 2
    if envelopes is None:
        envelopes = np.zeros((T1, 2), np.int64)
        envelopes[:, 1] = T2
    envelopes = _host(envelopes).astype(np.int64)
    lengths = np.full((B,), T1, np.int32) if lengths is None else _host(lengths).astype(np.int32)
    ep = duplex_fast_ops.prep_envelopes(envelopes[None] if shared_env else envelopes, T2)
    lo, hi, wr_b = ep.lo, ep.hi, ep.Wr
    if shared_env:
        lo, hi, wr_b = np.repeat(lo, B, 0), np.repeat(hi, B, 0), np.repeat(wr_b, B)
    Wr = int(max(wr_b.max(), 1)) if B else 1
    if init1 is None:
        root_gap = duplex_fast_ops.root_gap_host(l2, wr_b, Wr)
        init_states = np.zeros((B,), np.int32)
    elif isinstance(l2, torch.Tensor):
        init_states = init1.float().argmax(1).to(torch.int32)
        S, A = l2.shape[2], l2.shape[3] - 1
        states = duplex_fast_ops.crf_root_states(_host(init2.float().argmax(1)), S, A, Wr)
        dev = l2.device
        blanks = l2[torch.arange(B, device=dev)[:, None], torch.arange(Wr - 1, device=dev),
                    torch.from_numpy(states).to(dev), 0]
        root_gap = duplex_fast_ops.crf_root_gap_sum(_host(blanks), wr_b, Wr)
    else:
        root_gap = duplex_fast_ops.crf_root_gap_host(l2, _host(init2), wr_b, Wr)
        init_states = np.argmax(_host(init1).astype(np.float32), axis=1).astype(np.int32)
    return DuplexBatch(
        l1, l2, root_gap, lo, hi, thr, init_states, lengths,
        needs_ext=bool(ep.needs_ext.any()),
        W=int(ep.W.max()) if ep.W.size else 1,
        tree_needs_ext=bool(ep.tree_needs_ext.any()),
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


def exact_chunk_pairs(B: int, per_pair: int, budget: int, wave: int = 0) -> int:
    """Pairs of one exact-engine launch: as many as ``budget`` bytes hold at
    ``per_pair`` bytes a pair, at most B (1 for an empty batch).  Where the
    budget holds at least one ``wave`` (the pairs the card runs at once) but
    not all B, a whole number of waves, so that no launch ends on a partial
    wave.  Raises MemoryError when not even one pair fits."""
    fit = budget // per_pair
    if fit < 1:
        raise MemoryError(
            f"one pair's exact-engine scratch ({per_pair} bytes) exceeds the budget of "
            f"{budget} bytes"
        )
    if fit >= B:
        return max(B, 1)
    if wave and fit >= wave:
        fit -= fit % wave
    return fit


def exact_launch_pairs(batch: DuplexBatch, device, *, beam_size, crf, max_nodes=None,
                       budget_bytes=None) -> int:
    """Pairs of ``batch`` that one exact-engine call on ``device`` takes
    (``exact_chunk_pairs``), at ``4 * scratch_stride`` bytes a pair.

    ``budget_bytes`` None: on a CUDA device ``EXACT_FREE_SHARE`` of the
    card's free memory (what ``cudaMemGetInfo`` reports free plus what PyTorch's
    caching allocator holds unused), taken now, before the scratch exists,
    less ``batch.nbytes(device)`` (the bytes not on the card yet), in whole
    waves of SMs x the tree kernel's blocks per SM; on the CPU
    ``EXACT_CHUNK_BYTES``, at least one pair a chunk."""
    dev = torch.device(device)
    K = int(beam_size)
    N = batch.max_nodes(K) if max_nodes is None else int(max_nodes)
    per_pair = 4 * duplex_exact_cuda.scratch_stride(N, K, batch.l1.shape[-1] - 1, batch.W)
    B, wave = batch.lo.shape[0], 0
    if budget_bytes is not None:
        budget = int(budget_bytes)
    elif dev.type == "cuda":
        with torch.cuda.device(dev):
            free = torch.cuda.mem_get_info(dev)[0]
            free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
            budget = int(EXACT_FREE_SHARE * free) - batch.nbytes(dev)
            wave = (torch.cuda.get_device_properties(dev).multi_processor_count
                    * duplex_exact_cuda.launch_shape(K, batch.W, crf=crf)["blocks_per_sm"])
    else:
        budget = max(EXACT_CHUNK_BYTES, per_pair)
    return exact_chunk_pairs(B, per_pair, budget, wave)


def run_duplex_engine(engine, batch: DuplexBatch, device, *, beam_size, collapse, crf,
                      max_nodes=None, budget_bytes=None):
    """Decode a prepared batch with ``engine`` on ``device``: the result dict
    (labels_rev [B, T1], count [B], err [B]; int32 tensors on ``device``),
    without waiting for the device.  Stages ``<path>.upload``,
    ``<path>.launch`` and, on "exact", ``<path>.size``, where ``<path>`` is
    "crf_duplex" with ``crf`` and "duplex" without.

      - "cuda": the slot kernel, then the 1D traceback kernel (plain only);
      - "fast": the plain slot engine;
      - "exact": the tree kernel on CUDA, the plain tree engine on the CPU,
        in chunks of ``exact_launch_pairs`` pairs (``budget_bytes`` as
        there): on the card as many as its free memory holds, on the CPU as
        many as ``EXACT_CHUNK_BYTES`` of tables hold.  A pair's result does
        not depend on its chunk.  ``max_nodes`` defaults to the JAX
        package's budget, so a pair overflows (NODE_OVERFLOW) exactly where
        it does there."""
    K = int(beam_size)
    path = "crf_duplex" if crf else "duplex"
    if engine != "exact":
        with profiling.stage(f"{path}.upload"):
            l1, l2, rg, lo, hi, thr, init, ln = batch.tensors(device)
        with profiling.stage(f"{path}.launch"):
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
    B = batch.lo.shape[0]
    with profiling.stage(f"{path}.size"):
        chunk = exact_launch_pairs(batch, dev, beam_size=K, crf=crf, max_nodes=N,
                                   budget_bytes=budget_bytes)
    fn = (
        duplex_exact_cuda.duplex_exact_kernel_batch
        if dev.type == "cuda"
        else duplex_ops.duplex_exact_batch
    )
    outs = []
    for s in range(0, max(B, 1), chunk):
        # past the first chunk, a pageable upload waits in stream order
        # behind the previous chunk's kernel
        with profiling.stage(f"{path}.upload"):
            args = batch.tensors(dev, slice(s, s + chunk))
        with profiling.stage(f"{path}.launch"):
            outs.append(fn(*args, beam_size=K, collapse_repeats=collapse, max_nodes=N,
                           W=batch.W, needs_ext=batch.tree_needs_ext, crf=crf))
    with profiling.stage(f"{path}.launch"):
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _assemble_duplex(out, B0, alphabet):
    """Duplex result assembly (a result dict of host numpy arrays):
    [(sequence, err_code)] per pair (duplex returns no path, matching the
    reference — src/duplex.rs:638-649)."""
    from ..native import detokenize_batch

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
        with profiling.stage("duplex.device"):
            out, B0 = self._decode(net1, net2, envelopes, lengths)
            out = _fetch(out, "duplex")
        with profiling.stage("duplex.detok"):
            return _assemble_duplex(out, B0, self.alphabet)

    def _decode(self, net1, net2, envelopes, lengths):
        with profiling.stage("duplex.prep"):
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
    The tree engines' logsumexps take ``exp`` and ``log1p`` correctly rounded
    (``ops/duplex_fast.ls_add_cr``), as upstream's libm calls nearly always
    give them; the slot engine keeps the float32 library functions.  The
    inputs' logs are the correctly rounded float32 ones on every path
    (``prep_duplex_batch``).
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
        with profiling.stage("crf_duplex.device"):
            out, B0 = self._decode(net1, init1, net2, init2, envelopes, lengths)
            out = _fetch(out, "crf_duplex")
        with profiling.stage("crf_duplex.detok"):
            return _assemble_duplex(out, B0, self.alphabet)

    def _decode(self, net1, init1, net2, init2, envelopes, lengths):
        with profiling.stage("crf_duplex.prep"):
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
    env = _host(envelope)
    return bool(np.all(env == env[:1]))


def _pad_envelopes(rows, edge1: int) -> np.ndarray:
    """``[len(rows), edge1, 2]`` int64 envelopes of a duplex batch from
    ``(len1, len2, envelope)`` a pair: the envelope (None: the full range of
    read 2), its last row repeated past read 1's end."""
    envs = np.zeros((len(rows), edge1, 2), np.int64)
    for j, (len1, len2, env) in enumerate(rows):
        if env is None:
            envs[j, :, 1] = len2  # full range of read 2
        else:
            env = _host(env)
            envs[j, :len1] = env
            # rows past len1 are masked by `lengths`, but must stay
            # monotone-valid: repeat the last row
            envs[j, len1:] = env[len1 - 1 : len1]
    return envs


@profiling.stage("decode_many_duplex")
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
    if not pairs:
        return []
    device = resolve_device(device)
    e1s = _auto_bucket_edges([p[0].shape[0] for p in pairs])
    e2s = _auto_bucket_edges([p[1].shape[0] for p in pairs])
    meta = {
        "duplex": True,
        "bucket_edges": [e1s, e2s],
        "beam_size": int(beam_size),
        "beam_cut_threshold": float(beam_cut_threshold),
        "collapse_repeats": bool(collapse_repeats),
        "engine": engine,
    }
    constant = all(_constant_window(p[2] if len(p) > 2 else None) for p in pairs)

    def pad(edges, chunk, bs):  # a partial batch keeps its own row count
        n1, lengths = pad_batch([pairs[i][0] for i in chunk], T=edges[0])
        n2 = pad_batch([pairs[i][1] for i in chunk], T=edges[1])[0]
        envs = _pad_envelopes([(pairs[i][0].shape[0], pairs[i][1].shape[0],
                                pairs[i][2] if len(pairs[i]) > 2 else None) for i in chunk],
                              edges[0])
        return n1, n2, envs, lengths

    rows = _stream(
        "decode_many_duplex", pairs, batch_size, checkpoint_path, meta,
        "duplex" if constant else "duplex_moving",
        key=lambda i: (edge_holding(pairs[i][0].shape[0], e1s),
                       edge_holding(pairs[i][1].shape[0], e2s)),
        decoder=lambda edges: BatchDuplexDecoder(
            alphabet, T1=edges[0], T2=edges[1], beam_size=beam_size,
            beam_cut_threshold=beam_cut_threshold, collapse_repeats=collapse_repeats,
            engine=engine, device=device,
        ),
        pad=pad, noun="pairs",
        # checkpoint rows are (seq, path, err); duplex has no path
        # (reference contract), stored as []
        to_rows=lambda res: [(sq, [], er) for sq, er in res],
    )
    return [(sq, er) for sq, _, er in rows]


def _pad_crf_duplex(device, pairs, chunk, edges):
    """``decode_many_crf_duplex``'s pad of ``chunk``: ``(net1, init1, net2,
    init2, envelopes, lengths)`` for ``BatchCrfDuplexDecoder.decode``, one
    row a pair, each read padded to its bucket's edge.

    Where every posterior and init state of the batch is a float32 tensor
    on ``device``, nothing goes through the host: each read's ``log``,
    computed in float64 and rounded once (the correctly rounded float32
    log), is written into ``[n, edge, S, A+1]`` buffers there (``-inf``, the
    log of 0, past its end), handed on as ``LogScores``, and the init states
    are stacked there.  Any other batch is padded with zeros on the host, as
    ``decode_many_duplex`` pads, for ``prep_duplex_batch`` to take its
    logs.  The envelopes and lengths are small host arrays either way."""
    ps = [pairs[i] for i in chunk]
    e1, e2 = edges
    S, A1 = ps[0][0].shape[1:]
    lengths = np.array([p[0].shape[0] for p in ps], np.int32)
    envs = _pad_envelopes([(p[0].shape[0], p[2].shape[0], p[4] if len(p) > 4 else None)
                           for p in ps], e1)
    if all(_on(x, device) and x.dtype is torch.float32 for p in ps for x in p[:4]):
        nets = []
        for k, edge in ((0, e1), (2, e2)):
            logs = torch.empty((len(ps), edge, S, A1), dtype=torch.float32, device=device)
            for j, p in enumerate(ps):
                T = p[k].shape[0]
                logs[j, :T] = p[k].double().log_()  # rounded once to float32
                logs[j, T:] = float("-inf")
            nets.append(LogScores(logs))
        inits = [torch.stack([p[k] for p in ps]) for k in (1, 3)]
        return nets[0], inits[0], nets[1], inits[1], envs, lengths
    nets = []
    for k, edge in ((0, e1), (2, e2)):
        buf = np.zeros((len(ps), edge, S, A1), np.float32)
        for j, p in enumerate(ps):
            x = _host(p[k])
            buf[j, : x.shape[0]] = x
        nets.append(buf)
    inits = [np.stack([_host(p[k]).astype(np.float32) for p in ps]) for k in (1, 3)]
    return nets[0], inits[0], nets[1], inits[1], envs, lengths


@profiling.stage("decode_many_crf_duplex")
def decode_many_crf_duplex(
    pairs: Sequence,
    alphabet,
    *,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    batch_size: int = 64,
    engine: Optional[str] = None,
    device=None,
    checkpoint_path: Optional[str] = None,
) -> List[Tuple[str, int]]:
    """Decode a long list of CRF read pairs with checkpoint/resume: the CRF
    duplex analog of ``decode_many_duplex`` (reference duplex.rs:652-834).

    ``pairs`` entries are ``(net1 [T1, S, A+1], init1 [S], net2 [T2, S,
    A+1], init2 [S])`` or the same with a ``[T1, 2]`` envelope last (None or
    omitted = the full range of read 2); linear probabilities, numpy arrays
    or tensors.  Pairs are grouped into (T1, T2) power-of-two buckets, one
    ``BatchCrfDuplexDecoder`` a bucket (``engine`` as there), at most
    ``batch_size`` pairs a batch; read 1 rides per-pair ``lengths``, read 2
    the per-pair envelope.

    A batch whose posteriors and init states are all float32 tensors on
    ``device`` (scores a network left on the card) is padded and prepared
    there (``_pad_crf_duplex``, ``prep_duplex_batch``): the logs are taken
    on the device and no posterior goes through the host.  Any other batch
    takes the host path of ``decode_many_duplex``: a zero pad, then the logs
    in numpy.  Both paths take the correctly rounded float32 log (in
    float64, rounded once), so they hand the decoder the same logs, and a
    pair decodes to the same sequence and status code on either path,
    whatever its length (two float64 logs may differ in their last bit,
    which moves the rounding to float32 on about one argument in 2^28).

    The counters ``decode_many_crf_duplex.frames`` (the real frames of both
    reads) and ``decode_many_crf_duplex.batch_frames`` (the frames of both
    reads in the batches handed to the decoder, bucket padding included)
    add what each batch decodes.  The checkpoint's ``meta`` holds
    ``decode_many_duplex``'s keys (``collapse_repeats`` False: CRF duplex
    never collapses) with ``"crf": True`` and ``"n_state"``.  Returns
    ``[(sequence, err_code)]`` in input order."""
    if not pairs:
        return []
    device = resolve_device(device)
    e1s = _auto_bucket_edges([p[0].shape[0] for p in pairs])
    e2s = _auto_bucket_edges([p[2].shape[0] for p in pairs])
    S = int(pairs[0][0].shape[1])
    meta = {
        "duplex": True,
        "crf": True,
        "n_state": S,
        "bucket_edges": [e1s, e2s],
        "beam_size": int(beam_size),
        "beam_cut_threshold": float(beam_cut_threshold),
        "collapse_repeats": False,
        "engine": engine,
    }
    constant = all(_constant_window(p[4] if len(p) > 4 else None) for p in pairs)

    def pad(edges, chunk, bs):
        frames = sum(int(pairs[i][0].shape[0]) + int(pairs[i][2].shape[0]) for i in chunk)
        profiling.count("decode_many_crf_duplex.frames", frames)
        profiling.count("decode_many_crf_duplex.batch_frames", len(chunk) * sum(edges))
        return _pad_crf_duplex(device, pairs, chunk, edges)

    rows = _stream(
        "decode_many_crf_duplex", pairs, batch_size, checkpoint_path, meta,
        "duplex" if constant else "duplex_moving",
        key=lambda i: (edge_holding(pairs[i][0].shape[0], e1s),
                       edge_holding(pairs[i][2].shape[0], e2s)),
        decoder=lambda edges: BatchCrfDuplexDecoder(
            alphabet, T1=edges[0], T2=edges[1], n_state=S, beam_size=beam_size,
            beam_cut_threshold=beam_cut_threshold, engine=engine, device=device,
        ),
        pad=pad, noun="pairs",
        to_rows=lambda res: [(sq, [], er) for sq, er in res],
    )
    return [(sq, er) for sq, _, er in rows]
