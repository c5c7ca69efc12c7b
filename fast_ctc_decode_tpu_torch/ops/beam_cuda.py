"""Hand-written CUDA kernels of the batched hash-identity beam paths (1D and
CRF), with their plain versions.

Five kernels, built from ``csrc/`` by ``ops/_build.py`` and launched through
ctypes on PyTorch's current stream:

 - ``beam_ids_kernel`` launches one of three versions of the fused T-loop
   beam, one thread per read (``csrc/beam_core.cuh`` describes them); all
   compute one function, whose plain version is
   ``beam_fast.beam_search_ids_batch``:

   - version 2, the default (``csrc/beam_kernel.cu``), replaces
     ``fast_ctc_decode_tpu/ops/beam_pallas.py::_beam_kernel2`` (parent-hash
     identity);
   - version 1 (``csrc/beam_v1_kernel.cu``) replaces ``_beam_kernel``
     (own-hash identity);
   - version 3 (``csrc/beam_v3_kernel.cu``) replaces ``_beam_kernel3``
     (version 2 with the candidates enumerated a-major).

   They exist side by side for the A/B tool ``tools/ab_bench.py``, as
   ``beam_search_pallas_batch(version=...)`` does in the JAX package.
 - ``traceback_kernel`` (``csrc/traceback_kernel.cu``) replaces
   ``beam_pallas.py::_traceback_kernel`` plus the key sort of
   ``beam_fast._sort_unpack_keys``: a direct walk of the id log, one thread
   per read.  Plain version: ``beam_fast._traceback_scan_batch``.  It walks
   the CRF id log and the duplex slot kernel's id log too (same id coding).
 - ``crf_beam_ids_kernel`` (``csrc/crf_beam_kernel.cu``) replaces
   ``beam_pallas.py::_crf_beam_kernel``: the CRF instances of the fused
   beam, one thread per read, each tip loading its own state's row.  Plain
   version: ``beam_fast.crf_beam_search_ids_batch``.

Each wrapper checks its inputs and its kernel's bounds and raises beyond
them, whatever the device.  A tensor on the CPU then goes to the plain
version; a CUDA tensor launches the kernel or raises, with no fallback.
``launches`` counts kernel launches (the plain versions count nothing).
"""

from __future__ import annotations

import torch

from . import _build
from . import beam_fast

#: kernel launches per wrapper since the last reset (plain integers); "beam"
#: counts version 2, "beam_v1" / "beam_v3" the A/B versions
launches = {"beam": 0, "beam_v1": 0, "beam_v3": 0, "traceback": 0, "crf_beam": 0}

#: version -> (C launch function, launch counter)
VERSIONS = {
    1: ("ctc_beam_ids_v1_launch", "beam_v1"),
    2: ("ctc_beam_ids_launch", "beam"),
    3: ("ctc_beam_ids_v3_launch", "beam_v3"),
}

MAX_BEAM = 16  # per-thread beam arrays of the widest kernel instance
MAX_A1 = 8  # blank + at most 7 labels

beam_ids_plain = beam_fast.beam_search_ids_batch
crf_beam_ids_plain = beam_fast.crf_beam_search_ids_batch


def traceback_plain(fin, ids_log, *, T, K, A):
    return beam_fast._traceback_scan_batch(fin, ids_log, T, K, A)


def reset_launches():
    for name in launches:
        launches[name] = 0


def _check(x, name, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _bounds(T, K, A):
    if not 1 <= K <= MAX_BEAM:
        raise ValueError(f"beam_size must be in [1, {MAX_BEAM}] for the CUDA kernel, got {K}")
    if not 2 <= A + 1 <= MAX_A1:
        raise ValueError(f"A+1 must be in [2, {MAX_A1}] for the CUDA kernel, got {A + 1}")
    if T * K * A > beam_fast._I32_MAX:
        raise ValueError("T * beam_size * A overflows the int32 node ids")


def _raise_for(rc, what):
    if rc != 0:
        msg = _build.load_library().ctc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _version(version):
    if version not in VERSIONS:
        raise ValueError(f"unknown beam kernel version {version!r}; known: {sorted(VERSIONS)}")
    return VERSIONS[version]


def beam_ids_kernel(probs, lengths, thr, *, beam_size, collapse_repeats=True, version=2):
    """Forward beam: ``(ids_log [T, K, B], fin [B], err [B])``, all int32.

    probs: [B, T, A+1] f32 contiguous; lengths: [B] i32 on the same device.
    ``version`` (1, 2 or 3) picks the kernel on a CUDA tensor; every version
    computes the same outputs, so a CPU tensor runs the plain version for any.
    """
    fn_name, counter = _version(version)
    if not isinstance(probs, torch.Tensor) or probs.dim() != 3:
        raise ValueError("probs must be a [B, T, A+1] torch.Tensor")
    B, T, A1 = probs.shape
    K = int(beam_size)
    _check(probs, "probs", torch.float32, (B, T, A1), probs.device)
    _check(lengths, "lengths", torch.int32, (B,), probs.device)
    _bounds(T, K, A1 - 1)
    if probs.device.type == "cpu":
        return beam_ids_plain(
            probs, lengths, thr, beam_size=K, collapse_repeats=collapse_repeats
        )
    dev = probs.device
    ids_log = torch.empty((T, K, B), dtype=torch.int32, device=dev)
    fin = torch.empty((B,), dtype=torch.int32, device=dev)
    err = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return ids_log, fin, err
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = getattr(lib, fn_name)(
            probs.data_ptr(), lengths.data_ptr(), float(thr),
            B, T, A1 - 1, K, int(bool(collapse_repeats)),
            ids_log.data_ptr(), fin.data_ptr(), err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_for(rc, f"beam kernel (version {version})")
    launches[counter] += 1
    return ids_log, fin, err


def crf_beam_ids_kernel(probs, init_states, lengths, thr, *, beam_size):
    """CRF forward beam: ``(ids_log [T, K, B], fin [B], err [B])``, all int32.

    probs: [B, T, S, A+1] f32 contiguous; init_states: [B, Si] f32;
    lengths: [B] i32; all on one device.
    """
    if not isinstance(probs, torch.Tensor) or probs.dim() != 4:
        raise ValueError("probs must be a [B, T, S, A+1] torch.Tensor")
    B, T, S, A1 = probs.shape
    K = int(beam_size)
    _check(probs, "probs", torch.float32, (B, T, S, A1), probs.device)
    if not isinstance(init_states, torch.Tensor) or init_states.dim() != 2:
        raise ValueError("init_states must be a [B, Si] torch.Tensor")
    Si = init_states.shape[1]
    _check(init_states, "init_states", torch.float32, (B, Si), probs.device)
    _check(lengths, "lengths", torch.int32, (B,), probs.device)
    _bounds(T, K, A1 - 1)
    _crf_bounds(S, Si, A1 - 1)
    if probs.device.type == "cpu":
        return crf_beam_ids_plain(probs, init_states, lengths, thr, beam_size=K)
    dev = probs.device
    ids_log = torch.empty((T, K, B), dtype=torch.int32, device=dev)
    fin = torch.empty((B,), dtype=torch.int32, device=dev)
    err = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return ids_log, fin, err
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.ctc_crf_beam_ids_launch(
            probs.data_ptr(), init_states.data_ptr(), lengths.data_ptr(),
            float(thr), B, T, S, Si, A1 - 1, K,
            ids_log.data_ptr(), fin.data_ptr(), err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_for(rc, "CRF beam kernel")
    launches["crf_beam"] += 1
    return ids_log, fin, err


def _crf_bounds(S, Si, A):
    """The next state ``(state * A) % S + a`` is int32 arithmetic in the
    kernel, for states below max(S, Si)."""
    if S < 1 or Si < 1:
        raise ValueError(f"S and Si must be >= 1, got {S}, {Si}")
    if max(S, Si) * A + A > beam_fast._I32_MAX:
        raise ValueError("max(S, Si) * A overflows the int32 transition states")


def traceback_kernel(fin, ids_log, *, T, K, A):
    """Walk the [T, K, B] id log: ``(labels_rev [B, T], times_rev [B, T],
    count [B])``, all int32, emits leaf-first and -1 padded.

    Any position-coded log: the 1D and CRF beams' and the duplex slot
    kernel's (``ops/duplex_cuda.py``, where K*A <= 32 but K or A+1 may pass
    the beam kernels' 16 / 8).  The walk keeps no per-thread arrays, so its
    only bound is int32 node ids: T*K*A < 2**31."""
    if not isinstance(ids_log, torch.Tensor) or ids_log.dim() != 3:
        raise ValueError("ids_log must be a [T, K, B] torch.Tensor")
    B = ids_log.shape[2]
    _check(ids_log, "ids_log", torch.int32, (T, K, B), ids_log.device)
    _check(fin, "fin", torch.int32, (B,), ids_log.device)
    if K < 1 or A < 1:
        raise ValueError(f"K and A must be >= 1, got {K}, {A}")
    if T * K * A > beam_fast._I32_MAX:
        raise ValueError("T * beam_size * A overflows the int32 node ids")
    if ids_log.device.type == "cpu":
        return traceback_plain(fin, ids_log, T=T, K=K, A=A)
    dev = ids_log.device
    labels_rev = torch.empty((B, T), dtype=torch.int32, device=dev)
    times_rev = torch.empty((B, T), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return labels_rev, times_rev, count
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.ctc_traceback_launch(
            fin.data_ptr(), ids_log.data_ptr(), B, T, K, A,
            labels_rev.data_ptr(), times_rev.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_for(rc, "traceback kernel")
    launches["traceback"] += 1
    return labels_rev, times_rev, count


def beam_search_kernel_batch(
    probs, lengths, thr, *, beam_size, collapse_repeats=True, version=2, raw=False
):
    """Both kernels in turn; the output dict of
    ``beam_fast.beam_search_fast_batch`` (labels_rev, times_rev, count, err).

    ``version`` picks the beam kernel (1, 2 or 3).  ``raw=True`` stops after
    it and returns ``{"ids_log" [T, K, B], "fin" [B], "err" [B]}``, as
    ``beam_search_pallas_batch(raw=True)`` returns the kernel's outputs."""
    ids_log, fin, err = beam_ids_kernel(
        probs, lengths, thr, beam_size=beam_size,
        collapse_repeats=collapse_repeats, version=version,
    )
    if raw:
        return {"ids_log": ids_log, "fin": fin, "err": err}
    T, A = probs.shape[1], probs.shape[2] - 1
    labels_rev, times_rev, count = traceback_kernel(
        fin, ids_log, T=T, K=int(beam_size), A=A
    )
    return {
        "labels_rev": labels_rev,
        "times_rev": times_rev,
        "count": count,
        "err": err,
    }


def crf_beam_search_kernel_batch(probs, init_states, lengths, thr, *, beam_size):
    """The CRF beam kernel then the traceback kernel; the output dict of
    ``beam_fast.crf_beam_search_fast_batch``."""
    ids_log, fin, err = crf_beam_ids_kernel(
        probs, init_states, lengths, thr, beam_size=beam_size
    )
    T, A = probs.shape[1], probs.shape[3] - 1
    labels_rev, times_rev, count = traceback_kernel(
        fin, ids_log, T=T, K=int(beam_size), A=A
    )
    return {
        "labels_rev": labels_rev,
        "times_rev": times_rev,
        "count": count,
        "err": err,
    }
