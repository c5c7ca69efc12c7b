"""Reference-parity single-read API: viterbi, beam, CRF greedy, CRF beam and
the two duplex pair-consensus searches.

Port of the six entry points of ``fast_ctc_decode_tpu/api.py`` (the
reference's PyO3 bindings, src/lib.rs:170-578): the same signatures,
defaults, argument checks, messages and exception types (ValueError for
precondition failures before any decode, RuntimeError (``SearchError``)
for search failures, TypeError for a non-f32 or wrong-rank array).  Each
function adds one keyword-only ``device``: the decode runs there, on the
hand-written kernels for a CUDA device and on the plain torch engines for
the CPU.  None (the default) is the CUDA card and raises RuntimeError
without one; ``device="cpu"`` asks for the CPU.

Engines of the two beam functions:
  - "exact" (default): the flattened-suffix-tree engine, bit-exact
    sequence, path and tie-break parity with the reference; ``max_nodes``
    is the per-read tree budget (default: the worst case for the input);
    too small a budget raises NODE_OVERFLOW.
  - "fast": the hash-identity engine (the batch path with B=1), identical
    sequences; ``path`` entries of pruned-and-re-derived prefixes report
    their latest creation time.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import errors
from .alphabet import normalize_alphabet
from .device import resolve_device
from .ops import beam as beam_ops
from .ops import beam_cuda
from .ops import beam_exact_cuda
from .ops import beam_fast
from .ops import crf as crf_ops
from .ops import viterbi as viterbi_ops
from .parallel import pipeline

__all__ = [
    "viterbi_search",
    "beam_search",
    "crf_greedy_search",
    "crf_beam_search",
    "beam_search_duplex",
    "crf_beam_search_duplex",
]


def _as_f32(arr, ndim: int, name: str) -> np.ndarray:
    """Strict dtype/rank check mirroring PyO3's PyArrayN<f32> extraction:
    a non-f32 or wrong-rank array is a TypeError, not a silent cast."""
    if not isinstance(arr, np.ndarray):
        raise TypeError(f"{name} must be a numpy.ndarray")
    if arr.dtype != np.float32:
        raise TypeError(f"{name} must have dtype float32")
    if arr.ndim != ndim:
        raise TypeError(f"{name} must be {ndim}-dimensional")
    return np.ascontiguousarray(arr)


def _check_beam_args(alphabet: List[str], beam_size: int, beam_cut_threshold: float):
    """Shared beam_search argument validation (src/lib.rs:332-350), with the
    threshold comparison done in f32 like the Rust binding."""
    if beam_size == 0:
        raise ValueError("beam_size cannot be 0")
    thr = np.float32(beam_cut_threshold)
    if thr < -np.float32(0.0):
        raise ValueError("beam_cut_threshold must be at least 0.0")
    max_beam_cut = np.float32(1.0) / np.float32(len(alphabet))
    if thr >= max_beam_cut:
        raise ValueError(f"beam_cut_threshold cannot be more than {max_beam_cut}")


def _beam_result_to_seq_path(out, alphabet: List[str]) -> Tuple[str, List[int]]:
    """One read's result dict (row 0 of a B=1 batch) -> (sequence, path)."""
    out = {k: v[0].cpu().numpy() for k, v in out.items()}
    errors.raise_for_status(int(out["err"]))
    n = int(out["count"])
    # traceback is leaf->root; the reference reverses both (src/search.rs:295-298)
    seq = "".join(alphabet[int(l) + 1] for l in out["labels_rev"][:n][::-1])
    path = [int(t) for t in out["times_rev"][:n][::-1]]
    return seq, path


def _one_read(x: np.ndarray, device):
    """A host read as a [1, ...] tensor on ``device`` plus its [1] length."""
    dev = torch.device(device)
    probs = torch.from_numpy(x).to(dev)[None]
    return dev, probs, torch.full((1,), x.shape[0], dtype=torch.int32, device=dev)


def viterbi_search(
    network_output,
    alphabet: Union[str, Sequence],
    qstring: bool = False,
    qscale: float = 1.0,
    qbias: float = 0.0,
    collapse_repeats: bool = True,
    *,
    device=None,
) -> Tuple[str, List[int]]:
    """Viterbi decode; parity with src/lib.rs:180-212 / src/search.rs:320-383.
    The per-frame argmax and the run means (summed in frame order, as the
    batch decoder sums them) run on ``device``; the strings are built on
    the host."""
    device = resolve_device(device)
    alphabet = normalize_alphabet(alphabet)
    network_output = _as_f32(network_output, 2, "network_output")
    if len(alphabet) == 0:
        raise ValueError("Empty alphabet given")
    if len(alphabet) != network_output.shape[1]:
        raise ValueError(
            "alphabet size does not match probability matrix dimensions"
        )
    if network_output.shape[0] == 0:
        raise ValueError("network_output must not be empty")

    labels, pmax = viterbi_ops.viterbi_core(
        torch.from_numpy(network_output).to(device)
    )
    return viterbi_ops.assemble_host(
        labels, pmax, alphabet, qstring, qscale, qbias, collapse_repeats,
    )


def beam_search(
    network_output,
    alphabet: Union[str, Sequence],
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    collapse_repeats: bool = True,
    *,
    max_nodes: Optional[int] = None,
    engine: Optional[str] = None,
    device=None,
) -> Tuple[str, List[int]]:
    """CTC prefix beam search; parity with src/lib.rs:323-365 /
    src/search.rs:159-301.  ``engine``: "exact" (default) or "fast" (see
    the module docstring); combining ``max_nodes`` with "fast" is an
    error.  On a CUDA ``device`` both run the hand-written kernels and
    raise outside their bounds (beam_size <= 16, len(alphabet) <= 8)."""
    device = resolve_device(device)
    alphabet = normalize_alphabet(alphabet)
    network_output = _as_f32(network_output, 2, "network_output")
    if len(alphabet) != network_output.shape[1]:
        raise ValueError(
            f"alphabet size {len(alphabet)} does not match probability matrix "
            f"inner dimension {network_output.shape[1]}"
        )
    _check_beam_args(alphabet, beam_size, beam_cut_threshold)

    T, A1 = network_output.shape
    if T == 0:
        return "", []
    if engine is None:
        engine = "exact"
    thr = np.float32(beam_cut_threshold)
    kw = dict(beam_size=int(beam_size), collapse_repeats=bool(collapse_repeats))
    if engine == "fast":
        if max_nodes is not None:
            raise ValueError("max_nodes requires engine='exact'")
        dev, probs, lengths = _one_read(network_output, device)
        fn = (
            beam_cuda.beam_search_kernel_batch
            if dev.type == "cuda"
            else beam_fast.beam_search_fast_batch
        )
        out = fn(probs, lengths, thr, **kw)
    elif engine == "exact":
        if max_nodes is None:
            max_nodes = beam_ops.default_max_nodes(T, beam_size, A1 - 1)
        dev, probs, lengths = _one_read(network_output, device)
        fn = (
            beam_exact_cuda.beam_search_exact_kernel_batch
            if dev.type == "cuda"
            else beam_ops.beam_search_device_batch
        )
        out = fn(probs, lengths, thr, max_nodes=int(max_nodes), **kw)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return _beam_result_to_seq_path(out, alphabet)


def crf_greedy_search(
    network_output,
    init_state,
    alphabet: Union[str, Sequence],
    qstring: bool = False,
    qscale: float = 1.0,
    qbias: float = 0.0,
    *,
    device=None,
) -> Tuple[str, List[int]]:
    """Greedy CRF decode; parity with src/lib.rs:217-250 / src/search.rs:385-423."""
    device = resolve_device(device)
    alphabet = normalize_alphabet(alphabet)
    network_output = _as_f32(network_output, 3, "network_output")
    init_state = _as_f32(init_state, 1, "init_state")
    if len(alphabet) == 0:
        raise ValueError("Empty alphabet given")
    if network_output.shape[2] != len(alphabet):
        raise ValueError(
            "alphabet size does not match probability matrix dimensions"
        )
    if network_output.shape[0] == 0:
        raise ValueError("network_output must not be empty")

    dev, probs, lengths = _one_read(network_output, device)
    out = crf_ops.crf_greedy_batch(
        probs, torch.from_numpy(init_state).to(dev)[None], lengths, qscale, qbias
    )
    out = {k: v[0].cpu().numpy() for k, v in out.items()}
    n = int(out["n"])
    seq = "".join(alphabet[int(t)] for t in out["tokens"][:n])
    if qstring:
        seq += "".join(chr(int(q) + 33) for q in out["qints"][:n])
    return seq, [int(i) for i in out["path"][:n]]


def crf_beam_search(
    network_output,
    init_state,
    alphabet: Union[str, Sequence],
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    *,
    max_nodes: Optional[int] = None,
    engine: str = "exact",
    device=None,
) -> Tuple[str, List[int]]:
    """CRF prefix beam search; parity with src/lib.rs:255-286 /
    src/search.rs:38-157.  The reference binding performs no
    beam_size/threshold validation here; beam_size=0 empties the beam on
    the first step, which surfaces as RanOutOfBeam.  ``engine``: "exact"
    (default) or "fast"; "fast" ignores ``max_nodes``, as the JAX package
    does."""
    device = resolve_device(device)
    alphabet = normalize_alphabet(alphabet)
    network_output = _as_f32(network_output, 3, "network_output")
    init_state = _as_f32(init_state, 1, "init_state")
    if len(alphabet) == 0:
        raise ValueError("Empty alphabet given")
    if network_output.shape[2] != len(alphabet):
        raise ValueError(
            "alphabet size does not match probability matrix dimensions"
        )
    if network_output.shape[0] == 0:
        raise ValueError("network_output must not be empty")
    if beam_size == 0:
        # truncate(0) empties the beam immediately (src/search.rs:133-137)
        raise errors.SearchError(errors.RAN_OUT_OF_BEAM)

    T = network_output.shape[0]
    A = network_output.shape[2] - 1
    thr = np.float32(beam_cut_threshold)
    if engine == "fast":
        dev, probs, lengths = _one_read(network_output, device)
        init = torch.from_numpy(init_state).to(dev)[None]
        fn = (
            beam_cuda.crf_beam_search_kernel_batch
            if dev.type == "cuda"
            else beam_fast.crf_beam_search_fast_batch
        )
        out = fn(probs, init, lengths, thr, beam_size=int(beam_size))
    elif engine == "exact":
        if max_nodes is None:
            max_nodes = beam_ops.default_max_nodes(T, beam_size, A)
        dev, probs, lengths = _one_read(network_output, device)
        init = torch.from_numpy(init_state).to(dev)[None]
        fn = (
            beam_exact_cuda.crf_beam_search_exact_kernel_batch
            if dev.type == "cuda"
            else crf_ops.crf_beam_search_device_batch
        )
        out = fn(probs, init, lengths, thr, beam_size=int(beam_size), max_nodes=int(max_nodes))
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return _beam_result_to_seq_path(out, alphabet)


def _pick_duplex_engine(
    engine: Optional[str],
    batch,
    max_nodes: Optional[int] = None,
    *,
    device=None,
    beam_size: int = 5,
    crf: bool = False,
) -> str:
    """Engine selection for the duplex searches: the ``run_duplex_engine``
    engine of one prepared pair.

    "fast" (the slot-band engines) is sequence-exact against the reference
    whenever every step sees the *same* clamped window, in particular the
    default full-range envelope, because a re-derived prefix's rebuilt band
    is then value-identical to the reference's reused one.  Any envelope
    whose window moves can make the slot engines rebuild bands over a
    different window than the reference's stale ones, so those default to
    the bit-exact tree engine ("exact").  An explicitly supplied
    ``max_nodes`` (the exact engine's tree budget) also forces "exact".
    Auto is the batch decoders' rule (``pipeline.auto_duplex_engine``).  On
    a CUDA device "fast" is the slot kernel ("cuda"; plain duplex only),
    which raises ValueError outside its envelope class or bounds.
    """
    device = resolve_device(device)
    if engine is None:
        if max_nodes is not None:
            return "exact"
        return pipeline.auto_duplex_engine(batch.lo, batch.hi, device, beam_size, crf=crf)
    if engine not in ("fast", "exact"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "fast" and max_nodes is not None:
        raise ValueError("max_nodes requires engine='exact'")
    if engine == "fast" and torch.device(device).type == "cuda" and not crf:
        return "cuda"
    return engine


def _check_envelope(envelope, network_output_1, network_output_2) -> np.ndarray:
    """Envelope validation + default construction (src/lib.rs:445-469):
    default = the full network_output_2 range for every network_output_1 row."""
    t1 = network_output_1.shape[0]
    t2 = network_output_2.shape[0]
    if envelope is None:
        env = np.zeros((t1, 2), dtype=np.int64)
        env[:, 1] = t2
        return env
    if not isinstance(envelope, np.ndarray):
        raise TypeError("envelope must be a numpy.ndarray")
    if envelope.ndim != 2:
        raise TypeError("envelope must be 2-dimensional")
    if not np.issubdtype(envelope.dtype, np.integer):
        raise TypeError("envelope must have an integer dtype")
    if envelope.shape[0] != t1:
        raise ValueError("the lengths of network_output_1 and envelope do not match")
    if envelope.shape[1] != 2:
        raise ValueError("the inner axis of envelope must have size 2")
    if np.any(envelope < 0):
        # reference takes usize — negative values are a TypeError at binding
        raise TypeError("envelope values must be non-negative")
    return envelope.astype(np.int64)


def _duplex_string(out, alphabet) -> str:
    out = {k: v[0].cpu().numpy() for k, v in out.items()}
    errors.raise_for_status(int(out["err"]))
    n = int(out["count"])
    return "".join(alphabet[int(l) + 1] for l in out["labels_rev"][:n][::-1])


def beam_search_duplex(
    network_output_1,
    network_output_2,
    alphabet: Union[str, Sequence],
    envelope=None,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    collapse_repeats: bool = True,
    *,
    max_nodes: Optional[int] = None,
    engine: Optional[str] = None,
    device=None,
) -> str:
    """2-D pair-consensus beam search; parity with src/lib.rs:411-488 /
    src/duplex.rs:443-650.  ``engine``: None (auto, ``_pick_duplex_engine``),
    "fast" (slot bands: the slot kernel on a CUDA ``device``, which raises
    ValueError outside its envelope class of non-decreasing lower bounds or
    its bounds; the plain engine on the CPU) or "exact" (the tree kernel on
    CUDA, the plain tree engine on the CPU)."""
    device = resolve_device(device)
    alphabet = normalize_alphabet(alphabet)
    network_output_1 = _as_f32(network_output_1, 2, "network_output_1")
    network_output_2 = _as_f32(network_output_2, 2, "network_output_2")
    if network_output_1.shape[1] != network_output_2.shape[1]:
        raise ValueError("inner axes of the network outputs do not match")
    if len(alphabet) != network_output_1.shape[1]:
        raise ValueError(
            f"alphabet size {len(alphabet)} does not match probability matrix "
            f"inner dimension {network_output_1.shape[1]}"
        )
    _check_beam_args(alphabet, beam_size, beam_cut_threshold)
    envelope = _check_envelope(envelope, network_output_1, network_output_2)

    batch = pipeline.prep_duplex_batch(
        network_output_1[None], network_output_2[None], envelope, None, beam_cut_threshold,
        T1=network_output_1.shape[0], T2=network_output_2.shape[0],
    )
    engine = _pick_duplex_engine(engine, batch, max_nodes, device=device,
                                 beam_size=int(beam_size))
    out = pipeline.run_duplex_engine(
        engine, batch, device, beam_size=int(beam_size), collapse=bool(collapse_repeats),
        crf=False, max_nodes=max_nodes,
    )
    return _duplex_string(out, alphabet)


def crf_beam_search_duplex(
    network_output_1,
    init_state_1,
    network_output_2,
    init_state_2,
    alphabet: Union[str, Sequence],
    envelope=None,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.0,
    *,
    max_nodes: Optional[int] = None,
    engine: Optional[str] = None,
    device=None,
) -> str:
    """2-D CRF pair-consensus beam search; parity with src/lib.rs:495-578 /
    src/duplex.rs:652-834.  ``engine`` as in ``beam_search_duplex``, except
    that "fast" runs the plain CRF slot engine on every device (there is no
    CRF slot kernel, as in the JAX package), and auto on a CUDA device runs
    the CRF tree kernel for every envelope."""
    device = resolve_device(device)
    alphabet = normalize_alphabet(alphabet)
    network_output_1 = _as_f32(network_output_1, 3, "network_output_1")
    network_output_2 = _as_f32(network_output_2, 3, "network_output_2")
    init_state_1 = _as_f32(init_state_1, 1, "init_state_1")
    init_state_2 = _as_f32(init_state_2, 1, "init_state_2")
    if network_output_1.shape[2] != network_output_2.shape[2]:
        raise ValueError("inner axes of the network outputs do not match")
    if len(alphabet) != network_output_1.shape[2]:
        raise ValueError(
            f"alphabet size {len(alphabet)} does not match probability matrix "
            f"inner dimension {network_output_1.shape[1]}"
        )
    _check_beam_args(alphabet, beam_size, beam_cut_threshold)
    envelope = _check_envelope(envelope, network_output_1, network_output_2)

    batch = pipeline.prep_duplex_batch(
        network_output_1[None], network_output_2[None], envelope, None, beam_cut_threshold,
        T1=network_output_1.shape[0], T2=network_output_2.shape[0], init1=init_state_1[None],
        init2=init_state_2[None],
    )
    engine = _pick_duplex_engine(engine, batch, max_nodes, device=device,
                                 beam_size=int(beam_size), crf=True)
    out = pipeline.run_duplex_engine(
        engine, batch, device, beam_size=int(beam_size), collapse=False, crf=True,
        max_nodes=max_nodes,
    )
    return _duplex_string(out, alphabet)
