"""Hand-written CUDA kernels of the batched hash-identity beam paths (1D and
CRF), with their plain versions.

The kernels, built from ``csrc/`` by ``ops/_build.py`` and launched through
ctypes on PyTorch's current stream:

 - ``beam_ids_kernel`` launches one of three versions of the fused T-loop
   beam (``csrc/beam_core.cuh`` describes them); all compute one function,
   whose plain version is ``beam_fast.beam_search_ids_batch``:

   - version 2, the default, replaces
     ``fast_ctc_decode_tpu/ops/beam_pallas.py::_beam_kernel2`` (parent-hash
     identity) in two designs, routed by ``design_for`` from the batch size
     and the kernel instance: one thread per read with a one-pass selection
     (``csrc/beam_kernel.cu``) or one warp per read
     (``csrc/beam_warp_kernel.cu``), which fills the card where a thread
     per read leaves most SMs idle.  Both give the same outputs;
     ``design=`` forces one (for the probe and ``chip_smoke.py``; the
     decoders never pass it);
   - version 1 (``csrc/beam_v1_kernel.cu``) replaces ``_beam_kernel``
     (own-hash identity);
   - version 3 (``csrc/beam_v3_kernel.cu``) replaces ``_beam_kernel3``
     (version 2 with the candidates enumerated a-major).

   Versions 1 and 3 run version 2's thread design at every B: one thread
   per read, the frame loaded a step ahead, and at beam <= 5 and A+1 <= 5
   the one-pass selection (K selection rounds above that).  They exist
   side by side for the A/B tool ``tools/ab_bench.py``, as
   ``beam_search_pallas_batch(version=...)`` does in the JAX package, and
   differ only in the TPU's identity and enumeration schemes.
 - ``traceback_kernel`` (``csrc/traceback_kernel.cu``) replaces
   ``beam_pallas.py::_traceback_kernel`` plus the key sort of
   ``beam_fast._sort_unpack_keys``: one warp per 32 reads, one lane a read,
   emits staged in shared memory and written in aligned 128-byte chunks of
   each row.  Two
   routes, chosen by ``traceback_route`` from the kernel's shared-memory
   arithmetic: the sweep streams the log backward through a ring of tiles
   in shared memory, in coalesced 128-byte runs; the walk, for a K whose
   one-step ring does not fit, gathers each parent from global memory.
   Plain version: ``beam_fast._traceback_scan_batch``.  It walks the CRF id
   log and the duplex slot kernel's id log too (same id coding).
 - ``crf_beam_ids_kernel`` (``csrc/beam_warp_kernel.cu``, CRF instances)
   replaces ``beam_pallas.py::_crf_beam_kernel``: one warp per read, each
   tip's pairs loading its own state's row.  Plain version:
   ``beam_fast.crf_beam_search_ids_batch``.

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
#: counts version 2 one thread per read, "beam_warp" version 2 one warp per
#: read, "beam_v1" / "beam_v3" the A/B versions, "traceback" the traceback's
#: sweep, "traceback_walk" its walk
launches = {
    "beam": 0, "beam_warp": 0, "beam_v1": 0, "beam_v3": 0, "traceback": 0, "traceback_walk": 0,
    "crf_beam": 0,
}

#: version -> (C launch function, launch counter)
VERSIONS = {
    1: ("ctc_beam_ids_v1_launch", "beam_v1"),
    2: ("ctc_beam_ids_launch", "beam"),
    3: ("ctc_beam_ids_v3_launch", "beam_v3"),
}

MAX_BEAM = 16  # per-thread beam arrays of the widest kernel instance
MAX_A1 = 8  # blank + at most 7 labels
#: (KMAX, AMAX) of the hash beam kernels' instances, narrowest first: beam K
#: over A labels runs the first that holds it (``instance``)
INSTANCES = ((5, 4), (MAX_BEAM, MAX_A1 - 1))
#: version 2 at ``<5, 4>`` runs one thread per read from this batch size on,
#: one warp per read below it (set from ``tools/kernel_probe.py``'s times at
#: beam 5, A+1 = 5, PERF.md).  The wide instance ``<16, 7>`` runs one warp per
#: read at every B: in the probe's wide sweep at T=1000 (NVIDIA H100 80GB
#: HBM3, 700 W; thread / warp ms) beam 16, A+1 = 8 took B=1 123.26 / 9.99,
#: 8192 194.95 / 57.97, 32768 358.86 / 217.78, and beam 8, A+1 = 5 B=1
#: 83.38 / 4.40, 8192 133.22 / 24.47, 32768 237.95 / 91.58 (PERF.md)
THREAD_MIN_B = 8192
DESIGNS = ("thread", "warp")
MAX_READS_PER_BLOCK = 8  # csrc/beam_warp_kernel.cu: kMaxReadsPerBlock
READS_PER_BLOCK = 4  # the warp kernel's default launch: four reads a block

#: the traceback's routes (``csrc/traceback_kernel.cu``) -> launch counter
TRACEBACK_ROUTES = {"sweep": "traceback", "walk": "traceback_walk"}
TRACEBACK_CHUNK = 32  # kChunk: entries of one aligned store, and the most steps a tile
TRACEBACK_RING = 4  # kRing: tiles of the sweep a warp holds
TRACEBACK_SMEM_LIMIT = 227 * 1024  # kSmemLimit: dynamic bytes a block (H100)
MAX_TRACEBACK_WARPS = 8  # kMaxWarps: warps (32 reads each) a block
#: the traceback's default block and tile (set from ``tools/kernel_probe.py``'s times
#: at B=32768, where 4 warps of 6-step tiles keep all 1,024 warps resident at once)
TRACEBACK_WARPS = 4
TRACEBACK_STEPS = 6

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


def instance(K: int, A: int) -> tuple:
    """(KMAX, AMAX) of the kernel instance that beam K over A labels runs."""
    return INSTANCES[0] if K <= INSTANCES[0][0] and A <= INSTANCES[0][1] else INSTANCES[1]


def design_for(B: int, K: int, A: int) -> str:
    """The version-2 design that a batch of B reads at beam K over A labels
    runs: one thread per read only at ``<5, 4>`` from ``THREAD_MIN_B`` on."""
    return "thread" if instance(K, A) == INSTANCES[0] and B >= THREAD_MIN_B else "warp"


def _check_reads_per_block(rpb) -> int:
    if isinstance(rpb, bool) or not isinstance(rpb, int) or not 1 <= rpb <= MAX_READS_PER_BLOCK:
        raise ValueError(
            f"reads_per_block must be an int in [1, {MAX_READS_PER_BLOCK}], got {rpb!r}"
        )
    return rpb


def warp_blocks_per_sm(K: int, A: int, *, crf: bool, reads_per_block: int = READS_PER_BLOCK) -> int:
    """Blocks of ``reads_per_block`` warps one SM holds at once for the warp
    kernel's instance that (K, A) launches, by the CUDA runtime's occupancy
    calculation (needs the built library and a card)."""
    rpb = _check_reads_per_block(reads_per_block)
    blocks = _build.load_library().ctc_beam_warp_blocks_per_sm(K, A, int(bool(crf)), rpb)
    if blocks < 0:
        _raise_for(-blocks, "warp beam kernel occupancy")
    return blocks


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


def beam_ids_kernel(
    probs, lengths, thr, *, beam_size, collapse_repeats=True, version=2, design=None,
    reads_per_block=READS_PER_BLOCK,
):
    """Forward beam: ``(ids_log [T, K, B], fin [B], err [B])``, all int32.

    probs: [B, T, A+1] f32 contiguous; lengths: [B] i32 on the same device.
    ``version`` (1, 2 or 3) picks the kernel on a CUDA tensor; every version
    computes the same outputs, so a CPU tensor runs the plain version for any.
    Version 2 runs ``design_for(B, K, A)`` unless ``design`` ("thread" or "warp")
    forces one; ``reads_per_block`` (1..8) sets the warp design's block.
    """
    _version(version)
    if design is not None and (version != 2 or design not in DESIGNS):
        raise ValueError(f"design must be None or one of {DESIGNS} (version 2), got {design!r}")
    rpb = _check_reads_per_block(reads_per_block)
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
    if version == 2 and (design or design_for(B, K, A1 - 1)) == "warp":
        return _warp_launch(probs, None, lengths, thr, B=B, T=T, S=1, Si=1, A=A1 - 1, K=K,
                            collapse=collapse_repeats, crf=False, rpb=rpb)
    return _thread_launch(probs, lengths, thr, B=B, T=T, A=A1 - 1, K=K,
                          collapse=collapse_repeats, version=version)


def _outputs(B, T, K, dev):
    """The beam kernels' outputs: ids_log [T, K, B], fin [B], err [B] (i32)."""
    return (torch.empty((T, K, B), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def _thread_launch(probs, lengths, thr, *, B, T, A, K, collapse, version):
    """A one-thread-per-read kernel (``csrc/beam_core.cuh``) of ``version``."""
    fn_name, counter = _version(version)
    ids_log, fin, err = _outputs(B, T, K, probs.device)
    if B == 0:
        return ids_log, fin, err
    lib = _build.load_library()
    with torch.cuda.device(probs.device):
        rc = getattr(lib, fn_name)(
            probs.data_ptr(), lengths.data_ptr(), float(thr), B, T, A, K,
            int(bool(collapse)), ids_log.data_ptr(), fin.data_ptr(), err.data_ptr(),
            torch.cuda.current_stream(probs.device).cuda_stream,
        )
    _raise_for(rc, f"beam kernel (version {version})")
    launches[counter] += 1
    return ids_log, fin, err


def _warp_launch(probs, init_states, lengths, thr, *, B, T, S, Si, A, K, collapse, crf, rpb):
    """The warp-per-read kernel (``csrc/beam_warp_kernel.cu``), 1D or CRF."""
    dev = probs.device
    ids_log, fin, err = _outputs(B, T, K, dev)
    if B == 0:
        return ids_log, fin, err
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.ctc_beam_warp_launch(
            probs.data_ptr(), init_states.data_ptr() if crf else None,
            lengths.data_ptr(), float(thr), B, T, S, Si, A, K, int(bool(collapse)),
            int(crf), ids_log.data_ptr(), fin.data_ptr(), err.data_ptr(), rpb,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_for(rc, "CRF beam kernel" if crf else "warp beam kernel")
    launches["crf_beam" if crf else "beam_warp"] += 1
    return ids_log, fin, err


def crf_beam_ids_kernel(
    probs, init_states, lengths, thr, *, beam_size, reads_per_block=READS_PER_BLOCK
):
    """CRF forward beam: ``(ids_log [T, K, B], fin [B], err [B])``, all int32.

    probs: [B, T, S, A+1] f32 contiguous; init_states: [B, Si] f32;
    lengths: [B] i32; all on one device.  One warp per read,
    ``reads_per_block`` (1..8) reads a block.
    """
    rpb = _check_reads_per_block(reads_per_block)
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
    return _warp_launch(probs, init_states, lengths, thr, B=B, T=T, S=S, Si=Si, A=A1 - 1,
                        K=K, collapse=False, crf=True, rpb=rpb)


def _crf_bounds(S, Si, A):
    """The next state ``(state * A) % S + a`` is int32 arithmetic in the
    kernel, for states below max(S, Si)."""
    if S < 1 or Si < 1:
        raise ValueError(f"S and Si must be >= 1, got {S}, {Si}")
    if max(S, Si) * A + A > beam_fast._I32_MAX:
        raise ValueError("max(S, Si) * A overflows the int32 transition states")


def traceback_smem_bytes(K: int, warps: int, steps: int) -> int:
    """Dynamic shared memory of a traceback block of ``warps`` warps: each
    warp's staged emits and, for the sweep (``steps`` > 0), its ring of
    ``TRACEBACK_RING`` tiles of ``steps`` steps (``csrc/traceback_kernel.cu``:
    ``ctc_traceback_smem_bytes``)."""
    return warps * (32 * (2 * TRACEBACK_CHUNK + 1) + TRACEBACK_RING * steps * K * 32) * 4


def traceback_route(T: int, K: int, *, warps: int = TRACEBACK_WARPS,
                    steps: int = TRACEBACK_STEPS):
    """``(route, steps)`` the traceback takes for a [T, K, B] log at
    ``warps`` warps a block: the sweep with as many steps a tile as fit, up
    to ``steps`` (and T); the walk, with 0, where even a one-step ring does
    not fit the block's shared memory."""
    for name, value, top in (("warps", warps, MAX_TRACEBACK_WARPS),
                             ("steps", steps, TRACEBACK_CHUNK)):
        if isinstance(value, bool) or not isinstance(value, int) or not 1 <= value <= top:
            raise ValueError(f"{name} must be an int in [1, {top}], got {value!r}")
    room = TRACEBACK_SMEM_LIMIT - traceback_smem_bytes(K, warps, 0)
    fit = room // (traceback_smem_bytes(K, warps, 1) - traceback_smem_bytes(K, warps, 0))
    if fit < 1:
        return "walk", 0
    return "sweep", min(steps, max(T, 1), fit)


def traceback_kernel(fin, ids_log, *, T, K, A, route=None, warps=TRACEBACK_WARPS,
                     steps=TRACEBACK_STEPS):
    """Walk the [T, K, B] id log: ``(labels_rev [B, T], times_rev [B, T],
    count [B])``, all int32, emits leaf-first and -1 padded.

    Any position-coded log: the 1D and CRF beams' and the duplex slot
    kernel's (``ops/duplex_cuda.py``, where K*A <= 32 but K or A+1 may pass
    the beam kernels' 16 / 8).  Its only input bound is int32 node ids:
    T*K*A < 2**31.  On a CUDA tensor it runs ``traceback_route(T, K,
    warps=, steps=)`` unless ``route`` ("sweep" or "walk") forces one (for
    the probe, the tests and ``chip_smoke.py``; the decoders never pass
    it); a forced sweep must fit.  ``warps`` (1..8) sets the block."""
    if not isinstance(ids_log, torch.Tensor) or ids_log.dim() != 3:
        raise ValueError("ids_log must be a [T, K, B] torch.Tensor")
    B = ids_log.shape[2]
    _check(ids_log, "ids_log", torch.int32, (T, K, B), ids_log.device)
    _check(fin, "fin", torch.int32, (B,), ids_log.device)
    if K < 1 or A < 1:
        raise ValueError(f"K and A must be >= 1, got {K}, {A}")
    if T * K * A > beam_fast._I32_MAX:
        raise ValueError("T * beam_size * A overflows the int32 node ids")
    if route is not None and route not in TRACEBACK_ROUTES:
        raise ValueError(f"route must be None or one of {tuple(TRACEBACK_ROUTES)}, got {route!r}")
    fits, fit_steps = traceback_route(T, K, warps=warps, steps=steps)
    if route == "sweep" and fits != "sweep":
        raise ValueError(f"the sweep's one-step ring does not fit at K={K}, {warps} warps a block "
                         f"({traceback_smem_bytes(K, warps, 1)} > {TRACEBACK_SMEM_LIMIT} bytes)")
    if ids_log.device.type == "cpu":
        return traceback_plain(fin, ids_log, T=T, K=K, A=A)
    return _traceback_launch(fin, ids_log, B=B, T=T, K=K, A=A, route=route or fits,
                             warps=warps, steps=fit_steps)


def _traceback_launch(fin, ids_log, *, B, T, K, A, route, warps, steps):
    """One launch of ``csrc/traceback_kernel.cu`` on ``route``."""
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
            0 if route == "sweep" else 1, warps, steps,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_for(rc, f"traceback kernel ({route})")
    launches[TRACEBACK_ROUTES[route]] += 1
    return labels_rev, times_rev, count


def beam_search_kernel_batch(
    probs, lengths, thr, *, beam_size, collapse_repeats=True, version=2, design=None,
    raw=False,
):
    """Both kernels in turn; the output dict of
    ``beam_fast.beam_search_fast_batch`` (labels_rev, times_rev, count, err).

    ``version`` picks the beam kernel (1, 2 or 3), ``design`` forces one of
    version 2's (``beam_ids_kernel``).  ``raw=True`` stops after it and
    returns ``{"ids_log" [T, K, B], "fin" [B], "err" [B]}``, as
    ``beam_search_pallas_batch(raw=True)`` returns the kernel's outputs."""
    ids_log, fin, err = beam_ids_kernel(
        probs, lengths, thr, beam_size=beam_size,
        collapse_repeats=collapse_repeats, version=version, design=design,
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


def crf_beam_search_kernel_batch(probs, init_states, lengths, thr, *, beam_size, raw=False):
    """The CRF beam kernel then the traceback kernel; the output dict of
    ``beam_fast.crf_beam_search_fast_batch``.  ``raw=True`` stops after the
    beam kernel, as ``beam_search_kernel_batch(raw=True)`` does."""
    ids_log, fin, err = crf_beam_ids_kernel(
        probs, init_states, lengths, thr, beam_size=beam_size
    )
    if raw:
        return {"ids_log": ids_log, "fin": fin, "err": err}
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
