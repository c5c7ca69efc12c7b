#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fast_ctc_decode_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

or, to time the hash beam kernels (rows 1, 3, 4, 5 and 10, and the wide
instances of rows 1, 3 and 4) and the traceback (row 2, at B=32768 and on
the first 256 reads of its log) beside a parent commit's kernels in the
same run, with the parent's package unpacked in DIR (``git archive <commit>
fast_ctc_decode_tpu_torch | tar -x -C DIR``), imported under another name and
driven through its own wrappers (``ops/beam_cuda.py``,
``tools/kernel_ablate.py``), which build its kernels there:

    python3 chip_smoke.py --parent DIR

Phases, each of which raises on failure (exit code non-zero):
  1. builds the CUDA kernels from ``fast_ctc_decode_tpu_torch/csrc`` with nvcc
     (sm_90a, one compiler per source, all at once) and prints the card, the
     versions, the build time, ptxas's register/spill lines, the SASS
     instructions in each thread-per-read hash beam instance's step loop
     (``cuobjdump``) and, for the two duplex kernels and both instances of
     the exact tree and warp beam kernels, block size, shared memory and
     blocks per SM (with ``--parent``: the parent's kernels built too, and
     the hash beam instances' registers and SASS step loops beside the
     parent's);
  2. holds each 1D kernel against its plain PyTorch version on the card, bit
     for bit: the beam kernel's versions 1 and 3, version 2 in both designs
     (one thread per read; one warp per read at 1, 2, 4 or 8 reads a block
     in turn) and the traceback's two routes (the sweep and the walk, at
     1-8 warps a block) on the id log of each version-2 design, on the
     shapes of the CPU tests (a +-inf/NaN batch, -0.0, zero lengths, beams
     1/8/12/16, A+1 = 8) and at B=1024, T=1000;
  2b. the same for the CRF beam kernel (one warp per read, every case at 1,
     2, 4 and 8 reads a block) and the exact tree kernel (1D and
     CRF, random bits in the tree kernel's scratch memory): NaN, empty
     beams, zero lengths, overflow through a small ``max_nodes``, -0.0
     entries, beams 8/16, S = 9, B = 1 and B = 33 (a partial block of the
     warp-per-read kernel), beam 16 at A+1 = 8 (112 pairs: four lane
     chunks), an overflow cut inside the second lane chunk, zero-length
     reads beside full ones in a block, each at 1, 2, 4 or 8 reads a block,
     and at full width;
  3. drives the main path, ``BatchBeamDecoder("NACGT", T=1000, beam_size=5,
     beam_cut_threshold=0.1, device="cuda")``, on B=32768 reads made from a
     seed, with every status OK, 8 sampled reads equal to tests/oracle.py,
     and both kernels' launch counters grown (the beam kernel in the
     design the batch size routes to: one thread per read at B=32768);
  4. resumes ``decode_many`` from a checkpoint over ~2,000 mixed-length
     reads (batches of at most 256: the warp design, whose counter must
     grow) and checks the result against an uninterrupted run;
  5. holds the beam kernel to the plain version on the main path's inputs
     (B=32768, T=1000) in both designs, and its wide instance (one thread
     per read, beam 16, A+1 = 8; and one warp per read) and the wide
     instances of versions 1 and 3 on inputs of that width, bit for bit;
     times both kernels (the beam kernel in both designs, its wide instance
     in both and in the design the wrapper routes it to, printed beside the
     faster one, those of versions 1 and 3),
     ``decode_arrays``, ``decode`` and the plain engine there
     (CUDA-synchronised medians of 5 runs; the plain beam and the plain
     engine, seconds a call, of 3); holds both traceback routes to
     the plain version on the main path's log, on its first 1 and 33 reads,
     on logs of every kind of node id (``random_log``: the duplex slot
     log's widths K=32/A=1 and K=4/A=8, and 1-8 warps a block) and at the
     sweep's just-fits and the walk's just-misses, and times both routes at
     B=32768 and on the first 256 reads; with ``--parent``, rows 1, 3 and 4
     (both instances), 10 and 2 (both B) beside the parent's kernels in
     turns (parent, new, new, parent) after checking equal outputs; then
     ``tools.kernel_probe`` (the main path's stages, both designs at B = 1
     ... 32768 at beam 5, A+1 = 5 and at the wide instance's two shapes,
     beam 16 at A+1 = 8 and beam 8 at A+1 = 5, the warp design at 1-8 reads
     a block, both traceback routes at B = 1 ... 32768 and the sweep's
     blocks and tiles at B=32768; medians of 3);
  6. drives the paths of the single-read API and the CRF family at full
     width: ``BatchBeamDecoder(engine="exact")`` (T=1000, B=1024),
     ``BatchCrfBeamDecoder`` with the CUDA engine (T=400, S=64, B=1024) and
     the exact engine (B=256), ``BatchViterbiDecoder`` (T=1000, B=8192):
     statuses OK, the kernels' launch counters grown, 8 sampled reads equal
     to tests/oracle.py (sequence and path for the exact engines, sequence
     for the CRF CUDA engine), viterbi equal to its CPU run on every field
     (phred ints with tolerance 0, through the frame-ordered run-means
     kernel); ``api.beam_search`` / ``api.crf_beam_search`` on the card
     equal to the batch results, and one read of each timed (T=1000; T=400,
     S=64); ``decode_many_crf`` resumed from a checkpoint equal to an
     uninterrupted run; ``api.beam_search(engine="fast")`` on the card (the
     warp design at B=1) equal to the batch sequences; ``tools.exact_probe``
     at B=1024 (budgets and reads per block); both traceback routes held to
     the plain version and timed on the CRF path's log;
  7. times the new kernels against their plain versions (CUDA events), the
     CRF beam kernel at 1, 2, 4 and 8 reads a block (with ``--parent``: beside
     the parent's CRF kernel in turns), and the new decoders'
     ``decode_arrays`` / ``decode`` (wall), medians of 5;
  8. checks the duplex kernels' straight-line exp / log1p against the CUDA
     math library on all 2^32 float arguments, then holds the duplex slot
     kernel and the exact duplex tree kernel (plain and CRF) to their plain
     versions on the card, 0 differing entries of the output dict, with
     random bits in the kernels' scratch memory: full range, diagonal,
     dipping upper bound, invalid envelope, zero-probability and NaN rows,
     ragged and zero lengths, beam 1 and the widest beam, a small
     ``max_nodes``, CRF S=16 and S=9, per-pair envelopes; window widths that
     are no multiple of 32 or 4 (diagonal half-widths 7 and 33), an upper
     bound that jumps by 5 cells and then stalls (plain and CRF), a lower
     bound that jumps by a whole band after a dip, B=1 and B=133, the
     widest band the slot kernel's shared memory holds at beam 8 (its stage
     rows then live in the scratch slab) and a band past the tree kernel's
     shared stage rows; inputs outside a kernel's bounds raise;
  9. drives the duplex paths at full width (T1 = T2 = 500, B = 256, beam 5,
     cut 0.0): ``BatchDuplexDecoder`` auto on the full range (slot kernel),
     ``engine="cuda"`` on a diagonal envelope (slot kernel), auto on the
     diagonal (tree kernel), ``BatchCrfDuplexDecoder`` S=16 auto on the
     diagonal and on the full range (the CRF tree kernel both: auto sends a
     CRF constant window to it on the card), each with its launch counters
     and 4 sampled pairs
     equal to tests/oracle.py (not the slot kernel on a moving window, whose
     divergence from the reference is documented); the oracle runs in a
     process pool while the card works;
  10. resumes ``decode_many_duplex`` over ~200 pairs of 100-600 frames with
     per-pair diagonal envelopes from a checkpoint;
  11. the single-read duplex API on the card equals the batch results;
  12. times each duplex kernel beside its plain version on the same
     full-width shape (CUDA events; the plain versions once, they take
     tens of seconds), both traceback routes on the slot kernel's
     full-range log, and the duplex decoders' ``decode_arrays`` / ``decode``,
     the CRF tree kernel's launches on the constant-window full range alone
     (CUDA events around each launch inside ``decode``, summed), and holds
     the full-width kernel outputs to the plain ones; then the CRF full range
     through the exact engine in chunks sized from the card's free memory
     and forced to the CPU's 2 GB chunks: each chunk size and launch count
     (as ``pipeline.exact_launch_pairs`` gives), 0 differing entries and
     equal statuses between the two, both timed in turns, and the bytes the
     caching allocator keeps reserved after each;
  13. the A/B path (``tools.ab_bench``) at B=32768, T=1000: versions 1
     (own-hash), 2 (parent-hash) and 3 (parent-hash, candidates a-major),
     all three selecting in one pass, equal on all four fields, each
     launched; each version's kernel and full pipeline timed, and
     ``BatchBeamDecoder.decode`` (version 2);
  14. the ablation path (``tools.kernel_ablate``, version 1's one-pass body
     with phases stubbed): each of the nine phase sets on the kernel equals
     ``ablate_plain`` (fin, err) and the unstubbed kernel equals version 1,
     at B=256, T=200 and at B=16384, T=1000, then all nine are timed at
     B=16384, T=1000 with their deltas;
  15. the JSON/HTTP service on the card with micro-batching, on a free
     127.0.0.1 port: a B=256, T=1000 beam batch request equal to
     ``BatchBeamDecoder`` (8 reads equal to tests/oracle.py), a viterbi
     batch request, 64 concurrent single reads (600-1000 frames) equal to
     ``api.beam_search`` in fewer than 64 micro-batches, a malformed request
     answered 400 on its own; then ``distributed_init`` (world size 1, NCCL)
     and ``decode_and_count`` with totals [B, 0];
  16. the measurement tools and the demo through their entry points, each
     between a reset and a read of every launch counter: ``bench_torch.py``
     at its default (B=32768, T=1000, engine ``cuda``, its oracle gate;
     printed beside phase 5's beam + traceback kernel ms) and with the plain
     engine at B=4096 (no kernel may launch); ``tools.benchmark`` in its
     default mode and with ``--full --quick``; ``tools.bench_exact_duplex``
     at B=256, plain and ``--crf``; ``tools.scaling_bench overhead --engine
     cuda`` (the kernels' path; the plain engine's calls of seconds are left to
     the CPU tests), ``hosts --nproc 1`` and ``--nproc 2``
     (with one card its n=2 row must say it was not measured); the demo
     ``examples/basecall_demo_torch.py`` at its defaults (256 reads: the
     warp design).
The line before the last is a JSON object describing the kernels (one entry
per TPU kernel, and the viterbi run-means kernel, which has no Pallas
counterpart; each with its launches on its path, its kernel-vs-plain
difference, its time, its plain version's time and its bound: the larger of
its bytes over the HBM rate and its f32 operations over the f32 rate; and
``tools_launches``, phase 16's launches of it by tool); the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
outside the repository, it exits non-zero and prints no result.
"""

import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

ALPHABET = "NACGT"
B_MAIN, T_MAIN, BEAM, THR = 32768, 1000, 5, 0.1
WIDE_BEAM, WIDE_A1 = 16, 8  # the wide instance <16, 7> (versions 1-3) at B_MAIN, T_MAIN
B_SMALL_TB = 256  # row 2 also timed on the first B_SMALL_TB reads of the main log
B_EXACT = 1024  # exact 1D at T_MAIN
T_CRF, S_CRF, B_CRF, B_CRF_EXACT = 400, 64, 1024, 256
B_VITERBI = 8192  # viterbi at T_MAIN
REPEATS = 5
FIELDS = ("labels_rev", "times_rev", "count", "err")
B_DUP, T_DUP, S_DUP, W_DIAG, DUP_THR = 256, 500, 16, 40, 0.0  # duplex full width
DUP_FIELDS = ("labels_rev", "count", "err")
ORACLE_SAMPLES = 4
CHUNK_SWEEP = (1, 16, 49, 132, 256)  # pairs of one CRF full-range launch, timed alone
TESTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def log(msg):
    print(msg, flush=True)


def make_reads(B, T, A1, seed):
    """Random L2-normalised posteriors, made as bench.py makes them."""
    rng = np.random.RandomState(seed)
    probs = rng.rand(B, T, A1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    return probs


def tie_reads(B, T, seed, A1=5):
    """Posteriors of exact powers of two, not normalised: each frame draws
    its blank and one label probability shared by every label (a third of the
    frames draw one per label), so tips carry equal masses and fresh
    extensions of different tips tie inside the beam."""
    rng = np.random.RandomState(seed)
    shared = np.repeat(rng.randint(1, 4, size=(B, T, 1)), A1 - 1, axis=2)
    own = rng.randint(1, 4, size=(B, T, A1 - 1))
    labels = np.where(rng.rand(B, T, 1) < 1 / 3, own, shared)
    blank = rng.randint(1, 6, size=(B, T, 1))
    return np.exp2(-np.concatenate([blank, labels], axis=2)).astype(np.float32)


def make_crf_reads(B, T, S, A1, seed):
    """CRF posteriors [B, T, S, A+1] (L2-normalised rows, as make_reads) and
    init states [B, S] (normalised to sum 1)."""
    rng = np.random.RandomState(seed)
    probs = rng.rand(B, T, S, A1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    init = rng.rand(B, S).astype(np.float32)
    init /= init.sum(axis=1, keepdims=True)
    return probs, init


def random_log(T, K, A, B, seed):
    """(fin [B], ids_log [T, K, B]) int32 arrays of every kind of node id:
    parents at earlier steps (most), the root, empty slots, ids at the same
    or a later step, ids past T and any int32.  The traceback must stop
    where the plain sweep stops on any of them."""
    rng = np.random.RandomState(seed)
    KA = K * A

    def ids(shape, t_now):
        t_par = np.floor(rng.rand(*shape) * np.maximum(t_now, 1)).astype(np.int64)
        out = t_par * KA + rng.randint(0, KA, size=shape)
        kind = rng.rand(*shape)
        out = np.where(kind < 0.04, -1, out)
        out = np.where((kind >= 0.04) & (kind < 0.06), -2, out)
        later = np.minimum(t_now + rng.randint(0, 3, size=shape), T + 1) * KA
        out = np.where((kind >= 0.06) & (kind < 0.08), later + rng.randint(0, KA, size=shape), out)
        return np.where((kind >= 0.08) & (kind < 0.09),
                        rng.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64), out)

    t_col = np.arange(T)[:, None, None]
    log = ids((T, K, B), np.broadcast_to(t_col, (T, K, B)))
    fin = ids((B,), np.full(B, T))
    clip = lambda x: np.clip(x, -2**31, 2**31 - 1).astype(np.int32)
    return clip(fin), np.ascontiguousarray(clip(log))


def max_abs_diff(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def median_ms(fn, torch, repeats=REPEATS):
    """Median wall time of ``fn`` in ms, synchronised before and after."""
    fn()  # warm-up
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def median_event_ms(fn, torch, repeats=REPEATS, calls=1):
    """Median device time of ``fn`` in ms between two CUDA events; with
    ``calls`` > 1, per call of that many calls back to back between the
    events (a sub-millisecond kernel then is not its wrapper's host work)."""
    fn()  # warm-up
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


TB_CALLS = 10  # row 2 (~0.1-0.5 ms) is timed over ten calls back to back


# Peak rates of one H100 SXM (NVIDIA's data sheet, at the 700 W limit):
# HBM3 bytes/s and f32 operations/s
# outside the tensor cores (none of these kernels has a matrix product).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time the card could take for work that
    moves ``nbytes`` (each input read once, each output written once) and
    does ``ops`` f32 operations, the larger of the two times."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / F32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def beam_step_ops(K, A):
    """f32 operations of one read-step of the hash beam: K*A extension
    products, K lab+gap sums, 2K stay/blank products, K tip sums, K + K*A
    candidate totals, K*(K + K*A) selection compares, 2K divides."""
    return K * A + K + 2 * K + K + (K + K * A) + K * (K + K * A) + 2 * K


def beam_bound(lengths, T, K, A1, *, rows_per_step=1, extra_in=0, out_bytes=None):
    """Bound of a hash or tree beam over reads of ``lengths`` (a host array):
    ``rows_per_step`` posterior rows of A1 f32 per read-step (1D: 1; CRF:
    one per tip, K), the lengths and ``extra_in`` more input bytes; the
    outputs default to the [T, K, B] id log plus fin and err."""
    B = len(lengths)
    steps = int(np.minimum(np.asarray(lengths, np.int64), T).sum())
    nbytes = steps * rows_per_step * A1 * 4 + B * 4 + extra_in
    nbytes += (T * K * B + 2 * B) * 4 if out_bytes is None else out_bytes
    return bound(nbytes, steps * beam_step_ops(K, A1 - 1))


def duplex_bound(inp, K, A, *, tree):
    """Bound of a duplex kernel on prepared inputs: every input read once,
    the outputs (slot: the id log, fin, err; tree: labels_rev, count, err)
    written once, and per read-1 step each of the K tips and K*A extensions
    builds its band over the window, two log-sum-exps of ~5 operations (one
    exp, one log1p, three adds) per cell."""
    l1, l2, rg, lo, hi, _, _, ln, _ = inp
    B, T1 = lo.shape
    active = (np.arange(T1)[None, :] < ln.cpu().numpy()[:, None])
    cells = int(((hi - lo).clamp(min=0).cpu().numpy() * active).sum())
    nbytes = 4 * sum(x.numel() for x in (l1, l2, rg, lo, hi, ln))
    nbytes += 4 * ((B * T1 if tree else T1 * K * B) + 2 * B)
    return bound(nbytes, cells * (K + K * A) * 10)


# ---- the hash beam kernels' ptxas lines, and the parent commit's kernels ----

BEAM_ENTRY = re.compile(r"beam_ids_kernelILi(\d+)ELi(\d+)E(?:Lb([01])E)?Li(\d)ELi(\d+)E")
WARP_ENTRY = re.compile(r"beam_warp_kernelILi(\d+)ELi(\d+)ELb([01])E")


def parse_ptxas(build_log):
    """{entry function: (registers, spill bytes stored + loaded)} from nvcc's
    ``-Xptxas -v`` lines."""
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = [None, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def beam_kernel_registers(build_log):
    """{instance: (registers, spill bytes)} of the hash beam kernels: the
    thread-per-read body by (KMAX, AMAX, version, ablation mask; the parent's
    CRF instances marked), the warp-per-read kernel by (KMAX, AMAX, CRF)."""
    regs = {}
    for entry, val in parse_ptxas(build_log).items():
        m = BEAM_ENTRY.search(entry)
        if m:
            kmax, amax, crf, v, abl = m.groups()
            name = f"beam_ids_kernel<{kmax}, {amax}>{' CRF' if crf == '1' else ''} v{v}"
            regs[name + (f" ablate {abl}" if abl != "0" else "")] = val
        m = WARP_ENTRY.search(entry)
        if m:
            kmax, amax, crf = m.groups()
            regs[f"beam_warp_kernel<{kmax}, {amax}>{' CRF' if crf == '1' else ''}"] = val
    return regs


def beam_launch_shapes(build_log, parent_log=None):
    """Log the hash beam kernels' registers and spills, the warp kernel's
    blocks per SM, and, given the parent commit's build log, each instance's
    registers beside the parent's ("(equal)" where they match).  Returns
    {instance: (registers, spills)}."""
    from fast_ctc_decode_tpu_torch.ops import beam_cuda

    regs = beam_kernel_registers(build_log)
    for name, (r, sp) in sorted(regs.items()):
        log(f"ptxas {name}: {r} registers, {sp} bytes spilled")
    rpb = beam_cuda.READS_PER_BLOCK
    for K, A, what in ((BEAM, len(ALPHABET) - 1, "<5, 4>"), (16, 7, "<16, 7>")):
        for crf in (False, True):
            blocks = beam_cuda.warp_blocks_per_sm(K, A, crf=crf, reads_per_block=rpb)
            log(f"beam_warp_kernel{what}{' CRF' if crf else ''}: block {32 * rpb} threads "
                f"({rpb} reads, one warp each), {blocks} blocks per SM "
                f"({blocks * rpb} reads per SM)")
    if parent_log is not None:
        old = beam_kernel_registers(parent_log)
        for name, (r, sp) in sorted(old.items()):
            now = regs.get(name)
            log(f"ptxas parent {name}: {r} registers, {sp} bytes spilled; this tree: "
                f"{'gone' if now is None else f'{now[0]} registers, {now[1]} bytes spilled'}"
                f"{' (equal)' if now == (r, sp) else ''}")
    return regs


def sass_step_counts(lib_path):
    """{instance: (instructions in the step loop, instructions in all)} of
    the one-thread-per-read hash beam kernels (the names of
    ``beam_kernel_registers``), from ``cuobjdump -sass`` of the built library.
    The step loop is the longest backward branch's span: the loop over t,
    whose body the narrow instances unroll whole.  {} where cuobjdump is
    missing."""
    from fast_ctc_decode_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name, addrs, back = {}, None, [], []

    def close():
        if name is not None and addrs:
            span = max(((a - t) // 16 + 1 for a, t in back), default=0)
            out[name] = (span, len(addrs))

    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            fn = BEAM_ENTRY.search(m.group(1))
            name, addrs, back = None, [], []
            if fn:
                kmax, amax, crf, v, abl = fn.groups()
                name = f"beam_ids_kernel<{kmax}, {amax}>{' CRF' if crf == '1' else ''} v{v}"
                name += f" ablate {abl}" if abl != "0" else ""
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            addrs.append(addr)
            target = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)\s*$", m.group(2))
            if target and int(target.group(1), 16) < addr:
                back.append((addr, int(target.group(1), 16)))
    close()
    return out


def beam_sass_steps(lib_path, parent_path=None):
    """Log each thread-per-read hash beam instance's SASS step loop (and the
    parent's beside it).  Returns {instance: (step, total)}."""
    steps = sass_step_counts(lib_path)
    old = sass_step_counts(parent_path) if parent_path else {}
    if not steps:
        log("sass: not measured (no cuobjdump beside nvcc)")
    for name, (step, total) in sorted(steps.items()):
        was = old.get(name)
        log(f"sass {name}: {step} instructions in the step loop, {total} in all"
            + (f"; parent {was[0]} / {was[1]}" if was else ""))
    return steps


def beam_counter(design):
    """The launch counter of a version-2 design."""
    return "beam" if design == "thread" else "beam_warp"


def parent_package(parent_dir, name="parent_fast_ctc_decode_tpu_torch"):
    """The parent commit's package from ``DIR/fast_ctc_decode_tpu_torch``,
    imported under another name (its modules import each other relatively),
    so that its own wrappers build and launch its kernels (into its own
    ``_build`` directory) beside this tree's.  Returns its ``ops.beam_cuda``,
    ``ops._build`` and ``tools.kernel_ablate``."""
    import importlib
    import importlib.util

    pkg = os.path.join(parent_dir, "fast_ctc_decode_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return types.SimpleNamespace(**{
        short: importlib.import_module(f"{name}.{path}")
        for short, path in (("beam_cuda", "ops.beam_cuda"), ("build", "ops._build"),
                            ("kernel_ablate", "tools.kernel_ablate"))})


def turns_ms(torch, parent_fn, new_fn, same, calls=1):
    """Time the parent's kernel and this tree's in turns (parent, new, new,
    parent; each a median of REPEATS CUDA-event runs of ``calls`` calls),
    after checking that both give the same outputs (``same``).  Returns
    (parent_ms, new_ms), each the mean of its two medians, and the four
    medians."""
    if not same(parent_fn(), new_fn()):
        raise AssertionError("this tree's kernel and the parent's give different outputs")
    order = (parent_fn, new_fn, new_fn, parent_fn)
    t = [median_event_ms(fn, torch, calls=calls) for fn in order]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def parent_turns(torch, smi, parent, probs, lengths, wide, tb_logs):
    """Rows 1, 3, 4 and 10, the wide instances of versions 2, 1 and 3, and row 2 (on each of
    ``tb_logs``, (fin, ids_log) pairs) beside the parent's kernels on the
    same inputs, through each tree's own wrappers (``parent`` from
    ``parent_package``): {row: (parent ms, this tree's ms)}."""
    from fast_ctc_decode_tpu_torch.ops import beam_cuda
    from fast_ctc_decode_tpu_torch.tools import kernel_ablate

    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    B, T = probs.shape[:2]
    half = slice(0, B // 2)  # the ablation tool's B=16384
    pa, la = probs[half].contiguous(), lengths[half].contiguous()
    shape = f"B={B} T={T}"
    rows = [
        ("row 1 beam v2", shape, lambda m: m.beam_ids_kernel(probs, lengths, THR, beam_size=BEAM)),
        ("row 1 beam v2 <16, 7>", f"beam {WIDE_BEAM} A+1={WIDE_A1} {shape}",
         lambda m: m.beam_ids_kernel(wide, lengths, THR, beam_size=WIDE_BEAM)),
        ("row 3 beam v1", shape, lambda m: m.beam_ids_kernel(
            probs, lengths, THR, beam_size=BEAM, version=1)),
        ("row 3 beam v1 <16, 7>", f"beam {WIDE_BEAM} A+1={WIDE_A1} {shape}",
         lambda m: m.beam_ids_kernel(wide, lengths, THR, beam_size=WIDE_BEAM, version=1)),
        ("row 4 beam v3", shape, lambda m: m.beam_ids_kernel(
            probs, lengths, THR, beam_size=BEAM, version=3)),
        ("row 4 beam v3 <16, 7>", f"beam {WIDE_BEAM} A+1={WIDE_A1} {shape}",
         lambda m: m.beam_ids_kernel(wide, lengths, THR, beam_size=WIDE_BEAM, version=3)),
        ("row 10 ablation", f"kernel (no phase stubbed) B={B // 2} T={T}",
         lambda m: tuple(m.run_ablate(pa, la, THR, beam_size=BEAM).values())),
    ]
    for f, g in tb_logs:
        b = f.shape[0]
        rows.append((f"row 2 traceback{'' if b == B else f' B={b}'}",
                     shape if b == B else f"T={T}",
                     lambda m, f=f, g=g: m.traceback_kernel(f, g, T=T, K=BEAM,
                                                            A=probs.shape[2] - 1)))
    out = {}
    for name, where, fn in rows:
        mods = (parent.kernel_ablate, kernel_ablate) if name == "row 10 ablation" else (
            parent.beam_cuda, beam_cuda)
        calls = TB_CALLS if name.startswith("row 2") else 1
        old, new, t = turns_ms(torch, lambda: fn(mods[0]), lambda: fn(mods[1]), same, calls)
        out[name] = (old, new)
        log(f"time {name} {where}: parent {old!r} ms, this tree {new!r} ms "
            f"(turns parent/new/new/parent: {', '.join(f'{x:.3f}' for x in t)}"
            f"{f'; {calls} calls back to back' if calls > 1 else ''}) [{smi}]")
    return out


def launch_event_ms(torch, module, name, run):
    """Run ``run()`` once with ``module.name`` wrapped between two CUDA events
    per call: (summed device ms between the events, calls).  Host work
    between the calls is not counted."""
    real = getattr(module, name)
    marks = []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        marks.append((start, end))
        return out

    setattr(module, name, timed)
    try:
        run()
    finally:
        setattr(module, name, real)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks), len(marks)


def traceback_parity(torch, fin, ids_log, A, what, routes=None, **kw):
    """Both routes of the traceback kernel (or ``routes``) against its plain
    version on one id log on the card: {route: max_abs_err}; raises on any
    differing entry."""
    from fast_ctc_decode_tpu_torch.ops import beam_cuda

    T, K, _ = ids_log.shape
    want = beam_cuda.traceback_plain(fin, ids_log, T=T, K=K, A=A)
    err = {}
    for route in routes or beam_cuda.TRACEBACK_ROUTES:
        got = beam_cuda.traceback_kernel(fin, ids_log, T=T, K=K, A=A, route=route, **kw)
        err[route] = max(max_abs_diff(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    log(f"traceback parity {what}: max_abs_err {err}")
    if any(err.values()):
        raise AssertionError(f"traceback kernel != plain on {what}: {err}")
    return err


def traceback_edge_phase(torch, dev, fin, ids_log):
    """Row 2 on the card beyond the paths' logs, both routes against the
    plain version: B = 1 and 33 (slices of the main log), logs of every kind
    of node id (``random_log``) at the duplex slot kernel's widths (K=32,
    A=1; K=4, A=8) and at each block size, and the route's just-fits (the
    sweep at the largest K whose one-step ring fits the default block) and
    just-misses (the walk one K past it).  Returns the largest error."""
    from fast_ctc_decode_tpu_torch.ops import beam_cuda

    A = len(ALPHABET) - 1
    err = 0
    for b in (1, 33):
        e = traceback_parity(torch, fin[:b].contiguous(), ids_log[:, :, :b].contiguous(), A,
                             f"main log B={b}")
        err = max(err, *e.values())
    cases = [(500, 32, 1, 256, 8, 2), (500, 4, 8, 256, 8, 4)]  # the duplex slot log's widths
    cases += [(200, BEAM, A, 1000, w, w) for w in range(1, beam_cuda.MAX_TRACEBACK_WARPS + 1)]
    for T, K, A_, B, warps, seed in cases:
        f, g = (torch.from_numpy(x).to(dev) for x in random_log(T, K, A_, B, seed))
        e = traceback_parity(torch, f, g, A_, f"random log T={T} K={K} A={A_} B={B}, "
                             f"{warps} warps a block", warps=warps)
        err = max(err, *e.values())
    warps = beam_cuda.TRACEBACK_WARPS
    k = 1
    while beam_cuda.traceback_route(1, k + 1, warps=warps)[0] == "sweep":
        k += 1
    for K, route in ((k, "sweep"), (k + 1, "walk")):
        if beam_cuda.traceback_route(50, K, warps=warps)[0] != route:
            raise AssertionError(f"traceback route at K={K} is not {route}")
        f, g = (torch.from_numpy(x).to(dev) for x in random_log(50, K, 1, 33, K))
        e = traceback_parity(torch, f, g, 1, f"random log T=50 K={K} A=1 B=33 (the {route}'s "
                             f"{'just-fits' if route == 'sweep' else 'just-misses'})",
                             routes=(route,))
        err = max(err, *e.values())
    try:
        beam_cuda.traceback_kernel(f, g, T=50, K=k + 1, A=1, route="sweep")
    except ValueError:
        pass
    else:
        raise AssertionError(f"the sweep took K={k + 1} past its shared memory")
    return err


def parity_cases(full_width=True):
    """(name, probs, lengths, thr, beam_size, collapse): the CPU tests'
    shapes, then (``full_width``) B=1024 at T=1000."""
    nan_probs = make_reads(3, 20, 5, 4)
    nan_probs[1, 5, 2] = np.nan
    nan_probs[2] = 0.01  # all under the cut
    cases = [
        ("ragged", make_reads(4, 40, 5, 1), [40, 23, 7, 40], 0.1, 5, True),
        ("block_boundaries", make_reads(3, 37, 5, 2), [37] * 3, 0.1, 5, True),
        ("collapse_off_thr0_A1=4", make_reads(2, 30, 4, 3), [30] * 2, 0.0, 3, False),
        ("nan_and_empty", nan_probs, [20] * 3, 0.19, 5, True),
        ("zero_lengths", make_reads(4, 16, 5, 6), [0, 16, 0, 5], 0.1, 5, True),
    ]
    for K in (8, 12, 16):
        cases.append((f"beam{K}", make_reads(3, 30, 5, 5), [30] * 3, 0.0, K, True))
    inf_probs = make_reads(4, 24, 5, 8)
    inf_probs[0, 3, 2] = np.inf
    inf_probs[1, 5, 0] = np.inf
    inf_probs[2, 2, 1] = -np.inf
    inf_probs[3, 7, 4] = np.nan
    cases.append(("pm_inf_nan", inf_probs, [24] * 4, 0.1, 5, True))
    negz = make_reads(3, 30, 5, 9)
    negz[np.random.RandomState(10).rand(*negz.shape) < 0.2] = -0.0
    cases.append(("neg_zero", negz, [30] * 3, 0.0, 5, True))
    cases.append(("beam1", make_reads(3, 30, 5, 15), [30, 12, 30], 0.05, 1, True))
    cases.append(("A1=8", make_reads(3, 30, 8, 12), [30, 17, 30], 0.05, 5, True))
    cases.append(("A1=8_beam16", make_reads(3, 30, 8, 13), [30, 17, 30], 0.0, 16, True))
    # fresh extensions of different tips tie inside the top K: their order is
    # the id order (k, a), which is not version 3's a-major slot order
    cases.append(("ties", tie_reads(4, 24, 16), [24, 24, 15, 24], 0.0, 5, True))
    cases.append(("ties_cut0.1", tie_reads(4, 24, 17), [24, 9, 24, 24], 0.1, 5, True))
    if not full_width:
        return cases
    rng = np.random.RandomState(11)
    cases.append(
        ("B1024_T1000", make_reads(1024, 1000, 5, 7),
         list(rng.randint(0, 1001, size=1024)), THR, BEAM, True)
    )
    return cases


def exact_cases():
    """(name, probs, lengths, thr, beam_size, collapse, max_nodes) for the
    exact 1D kernel: the CPU tests' kinds of input and the full width."""
    ties = (np.random.RandomState(3).rand(4, 40, 5) > 0.5).astype(np.float32) * 0.9 + 0.05
    nan_probs = make_reads(3, 16, 5, 5)
    nan_probs[0, 4, 2] = np.nan
    nan_probs[1, 0, 0] = np.nan
    inf_probs = make_reads(3, 20, 5, 8)
    inf_probs[0, 3, 2] = np.inf
    inf_probs[1, 6, 0] = -np.inf
    cases = [
        ("ragged", make_reads(4, 40, 5, 1), [40, 23, 7, 40], 0.1, 5, True, None),
        ("collapse_off_thr0_A1=4", make_reads(2, 30, 4, 3), [30, 30], 0.0, 3, False, None),
        ("ties", ties, [40] * 4, 0.0, 5, True, None),
        ("uniform_prune", np.full((4, 40, 5), 0.05, np.float32), [40] * 4, 0.1, 5, True, None),
        ("nan", nan_probs, [16] * 3, 0.0, 5, True, None),
        ("pm_inf", inf_probs, [20] * 3, 0.0, 5, True, None),
        ("overflow_N8", make_reads(2, 40, 5, 9), [40, 40], 0.0, 5, True, 8),
        ("overflow_N37", make_reads(3, 30, 5, 10), [30, 12, 30], 0.1, 5, False, 37),
        ("zero_lengths", make_reads(4, 16, 5, 6), [0, 16, 0, 5], 0.1, 5, True, None),
        ("beam8", make_reads(3, 30, 5, 5), [30] * 3, 0.0, 8, True, None),
        ("beam16", make_reads(3, 30, 5, 5), [30] * 3, 0.0, 16, True, None),
        ("A1=8", make_reads(3, 30, 8, 12), [30, 17, 30], 0.05, 5, True, None),
        # one read alone in its block, and a partial block of the warp-per-read kernel
        ("B1", make_reads(1, 40, 5, 15), [40], 0.1, 5, True, None),
        ("B33", make_reads(33, 24, 5, 16), list(np.random.RandomState(17).randint(0, 25, 33)),
         0.05, 5, True, None),
        # 112 (tip, label) pairs: four lane chunks of 32
        ("beam16_A1=8", make_reads(3, 24, 8, 18), [24, 11, 24], 0.0, 16, True, None),
        # step 1 allocates 42 nodes over chunks 0-1 and only 33 fit: the cut
        # falls inside the second lane chunk (chunk 0 allocates at most 28)
        ("overflow_in_chunk1", make_reads(2, 12, 8, 19), [12, 12], 0.0, 16, True, 40),
        # zero-length reads beside full reads in the same blocks
        ("zero_length_in_block", make_reads(8, 30, 5, 20), [30, 0, 30, 30, 0, 30, 30, 30],
         0.1, 5, True, None),
    ]
    rng = np.random.RandomState(13)
    cases.append(
        (f"B{B_EXACT}_T{T_MAIN}", make_reads(B_EXACT, T_MAIN, 5, 14),
         list(rng.randint(0, T_MAIN + 1, size=B_EXACT)), THR, BEAM, True, None)
    )
    return cases


def crf_cases(full_width=True):
    """(name, probs, init, lengths, thr, beam_size, max_nodes) for the CRF
    kernels (the CRF beam kernel ignores max_nodes); the last
    (``full_width``) at the CRF path's B, T and S."""
    def crf(B, T, S, seed, A1=5, Si=None):
        p, init = make_crf_reads(B, T, S, A1, seed)
        if Si is not None:
            init = np.random.RandomState(seed).rand(B, Si).astype(np.float32)
        return p, init

    negz, negz_init = crf(3, 30, 16, 22)
    negz[np.random.RandomState(23).rand(*negz.shape) < 0.2] = -0.0
    negz_init[:, 1] = -0.0
    nan_p, nan_init = crf(3, 20, 8, 24)
    nan_p[1, 5, :, 2] = np.nan
    nan_p[2] = 0.01  # all under the cut
    ties = (np.random.RandomState(25).rand(3, 30, 9, 4) > 0.5).astype(np.float32) * 0.9 + 0.05
    cases = [
        ("ragged_S8", *crf(4, 40, 8, 20), [40, 23, 7, 40], 0.1, 5, None),
        ("S9_A1=4", *crf(3, 30, 9, 21, A1=4), [30] * 3, 0.0, 5, None),
        ("S16_neg_zero", negz, negz_init, [30] * 3, 0.0, 5, None),
        ("nan_and_empty", nan_p, nan_init, [20] * 3, 0.19, 5, None),
        ("ties_S9_A1=4", ties, crf(3, 30, 9, 26)[1], [30] * 3, 0.0, 5, None),
        ("zero_lengths", *crf(4, 16, 8, 27), [0, 16, 0, 5], 0.1, 5, None),
        ("overflow_N8", *crf(2, 30, 8, 28), [30, 30], 0.0, 5, 8),
        ("init_wider_than_S", *crf(3, 24, 8, 29, Si=11), [24] * 3, 0.05, 5, None),
        ("beam8", *crf(3, 30, 16, 30), [30] * 3, 0.0, 8, None),
        ("beam16", *crf(3, 30, 16, 31), [30] * 3, 0.0, 16, None),
        ("A1=8", *crf(3, 20, 8, 32, A1=8), [20, 9, 20], 0.05, 5, None),
        ("B1", *crf(1, 30, 16, 35), [30], 0.1, 5, None),
        ("B33", *crf(33, 20, 8, 36), list(np.random.RandomState(37).randint(0, 21, 33)),
         0.05, 5, None),
        ("beam16_A1=8_S7", *crf(3, 20, 7, 38, A1=8), [20, 9, 20], 0.0, 16, None),
        # step 1 allocates 49 nodes over chunks 0-1 and only 33 fit (chunk 0: <= 32)
        ("overflow_in_chunk1", *crf(2, 12, 7, 39, A1=8), [12, 12], 0.0, 16, 40),
        ("zero_length_in_block", *crf(8, 20, 16, 40), [20, 0, 20, 20, 0, 20, 20, 20],
         0.1, 5, None),
    ]
    if not full_width:
        return cases
    rng = np.random.RandomState(33)
    cases.append(
        (f"B{B_CRF}_T{T_CRF}_S{S_CRF}", *make_crf_reads(B_CRF, T_CRF, S_CRF, 5, 34),
         list(rng.randint(0, T_CRF + 1, size=B_CRF)), THR, BEAM, None)
    )
    return cases


def make_pairs(B, T1, T2, A1, seed):
    """Duplex read pairs: two batches of L2-normalised posteriors."""
    return make_reads(B, T1, A1, seed), make_reads(B, T2, A1, seed + 1)


def make_crf_pairs(B, T1, T2, S, A1, seed):
    """CRF duplex pairs: (net1, init1, net2, init2)."""
    n1, i1 = make_crf_reads(B, T1, S, A1, seed)
    n2, i2 = make_crf_reads(B, T2, S, A1, seed + 1)
    return n1, i1, n2, i2


def oracle_job(job):
    """One tests/oracle.py duplex decode (run in a worker process)."""
    sys.path.insert(0, TESTS_DIR)
    import oracle

    kind, args, kw = job
    fn = oracle.beam_search_duplex if kind == "plain" else oracle.crf_beam_search_duplex
    return fn(*args, **kw)


def once_event_ms(fn, torch):
    """Device time of one call of ``fn`` in ms between two CUDA events (for
    the plain duplex engines, whose one call takes tens of seconds)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def seq_path(out, i):
    """(sequence, path) of read i of a result dict on any device."""
    n = int(out["count"][i])
    labels = out["labels_rev"][i, :n].tolist()[::-1]
    return "".join(ALPHABET[l + 1] for l in labels), out["times_rev"][i, :n].tolist()[::-1]


def duplex_inputs(torch, dev, n1, n2, envs, thr, crf=None, tree=False, K=BEAM, lengths=None):
    """Prepare a duplex batch as every duplex entry point does
    (``pipeline.prep_duplex_batch``) and put it on ``dev``.  Returns (l1, l2,
    root_gap, lo, hi, thr, init_states, lengths, static) with ``static`` the
    engine's static arguments: W, needs_ext, max_nodes (tree) or needs_ext
    (slot)."""
    from fast_ctc_decode_tpu_torch.parallel.pipeline import prep_duplex_batch

    init1, init2 = (None, None) if crf is None else crf
    b = prep_duplex_batch(n1, n2, envs, lengths, thr, T1=n1.shape[1], T2=n2.shape[1],
                          init1=init1, init2=init2)
    if tree:
        static = dict(W=b.W, needs_ext=b.tree_needs_ext, max_nodes=b.max_nodes(K))
    else:
        static = dict(needs_ext=b.needs_ext)
    return (*b.tensors(dev), static)


def duplex_parity_cases():
    """(name, kind, inputs, kw): the CPU tests' kinds of input for the duplex
    kernels; kind "plain" runs the slot and the tree kernel, "crf" the CRF
    tree kernel, "tree" only the tree kernel (outside the slot class)."""
    from duplex_helpers import diag_env

    T1, T2 = 16, 18
    full = np.stack([np.zeros(T1, np.int64), np.full(T1, T2, np.int64)], 1)
    diag = diag_env(T1, T2, 3)
    dip = diag.copy()
    dip[6:9, 1] -= 2  # the upper bound dips, then recovers
    dip[:, 1] = np.maximum(dip[:, 1], dip[:, 0] + 1)
    bad = diag.copy()
    bad[5, 1] = bad[5, 0]
    back = diag_env(T1, T2, 4)
    back[9, 0] = max(back[9, 0] - 2, 0)
    n1, n2 = make_pairs(3, T1, T2, 5, 60)
    zer1, zer2 = n1.copy(), n2.copy()
    zer1[0, 3:5] = 0.0
    zer2[2, 5:8] = 0.0
    nan1, nan2 = n1.copy(), n2.copy()
    nan1[1, 4] = np.nan
    nan2[2, 6] = np.nan
    per = np.stack([diag_env(T1, T2, w) for w in (2, 3, 5)])
    c16 = make_crf_pairs(3, 12, 14, 16, 5, 61)
    c9 = make_crf_pairs(3, 12, 14, 9, 4, 62)
    d12 = diag_env(12, 14, 3)
    full12 = np.stack([np.zeros(12, np.int64), np.full(12, 14, np.int64)], 1)
    base = dict(thr=0.0, K=5, collapse=True, lengths=None, N=None)
    # window widths that are no multiple of a warp or of the chain's unroll
    w7_1, w7_2 = make_pairs(3, 40, 44, 5, 63)
    w33_1, w33_2 = make_pairs(2, 80, 90, 5, 64)
    # the upper bound grows by 5 cells in one step, then stalls for three
    j1, j2 = make_pairs(3, 24, 40, 5, 65)
    hi_j = np.minimum(40, 6 + 5 * (np.arange(24) // 4))
    jumps = np.stack([np.maximum(hi_j - 9, 0), hi_j], 1).astype(np.int64)
    # the upper bound dips, then the lower bound jumps by a whole band and
    # the window slides on: a discard of many cells at once
    hi_e = np.array([12] * 4 + [8] * 3 + list(range(20, 37)), np.int64)
    lo_e = np.array([0] * 7 + list(range(8, 25)), np.int64)
    slide = np.stack([lo_e, hi_e], 1)
    many1, many2 = make_pairs(133, T1, T2, 5, 66)  # one pair more than the card has SMs
    # the widest band the slot kernel's shared memory holds at beam 8 (its
    # stage rows then live in the scratch slab), and a band past it
    wide1, wide2 = make_pairs(2, 3, 894, 5, 67)
    wide_env = np.stack([np.zeros(3, np.int64), np.full(3, 894, np.int64)], 1)
    past1, past2 = make_pairs(2, 3, 1100, 5, 68)
    past_env = np.stack([np.zeros(3, np.int64), np.array([600, 1100, 1100], np.int64)], 1)
    cj = make_crf_pairs(2, 24, 40, 16, 5, 69)
    cases = [
        ("full", "plain", (n1, n2, full), {}),
        ("diag", "plain", (n1, n2, diag), {}),
        ("dipping_upper", "plain", (n1, n2, dip), {}),
        ("invalid_envelope", "plain", (n1, n2, bad), {}),
        ("zero_rows", "plain", (zer1, zer2, diag), {}),
        ("nan_rows", "plain", (nan1, nan2, full), {}),
        ("ragged_zero_lengths", "plain", (n1, n2, diag), dict(lengths=[16, 0, 7])),
        ("beam1", "plain", (n1, n2, diag), dict(K=1)),
        ("beam8_widest", "plain", (n1, n2, diag), dict(K=8, thr=0.05)),
        ("per_pair_collapse_off", "plain", (n1, n2, per), dict(collapse=False, thr=0.1)),
        ("max_nodes20", "tree", (n1, n2, diag), dict(N=20)),
        ("lower_steps_back", "tree", (n1, n2, back), {}),
        ("crf_S16_diag", "crf", (c16, d12), {}),
        ("crf_S16_full", "crf", (c16, full12), {}),
        ("crf_S9_A3", "crf", (c9, d12), {}),
        ("diag_halfwidth7", "plain", (w7_1, w7_2, diag_env(40, 44, 7)), {}),
        ("diag_halfwidth33", "plain", (w33_1, w33_2, diag_env(80, 90, 33)), {}),
        ("upper_jumps_then_stalls", "plain", (j1, j2, jumps), {}),
        ("dip_then_lower_jump", "plain", (j1, j2, slide), {}),
        ("one_pair", "plain", (n1[:1], n2[:1], diag), {}),
        ("B133", "plain", (many1, many2, diag), {}),
        ("beam8_widest_band_in_shared_memory", "plain", (wide1, wide2, wide_env), dict(K=8)),
        ("beam8_band_past_shared_stage", "tree", (past1, past2, past_env), dict(K=8)),
        ("crf_S16_upper_jumps", "crf", (cj, jumps), {}),
    ]
    return [(name, kind, inputs, {**base, **kw}) for name, kind, inputs, kw in cases]


def duplex_paths(torch, dn1, dn2, c1, i1, c2, i2, diag, log_counts):
    """Phase 9's five full-width duplex paths, each between counter reads."""
    from fast_ctc_decode_tpu_torch import BatchCrfDuplexDecoder, BatchDuplexDecoder

    def drive(name, fn, kernels, none_of=()):
        torch.cuda.synchronize()
        log_counts.reset()
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
        got = log_counts.read()
        log(f"{name}: {len(res)} pairs decoded in {wall:.3f} s (first call), launches "
            f"{ {k: got[k] for k in (*kernels, *none_of)} }")
        if min((got[k] for k in kernels), default=1) < 1:
            raise AssertionError(f"{name}: a kernel of the path never launched: {got}")
        if any(got[k] for k in none_of):
            raise AssertionError(f"{name}: an unexpected kernel launched: {got}")
        if len(res) != B_DUP or any(r[1] != 0 for r in res):
            raise AssertionError(f"{name}: status codes not all OK")
        return res, {k: got[k] for k in kernels}, wall

    kw = dict(beam_size=BEAM, beam_cut_threshold=DUP_THR, device="cuda")
    dec = BatchDuplexDecoder(ALPHABET, T1=T_DUP, T2=T_DUP, **kw)
    dec_cuda = BatchDuplexDecoder(ALPHABET, T1=T_DUP, T2=T_DUP, engine="cuda", **kw)
    crf_dec = BatchCrfDuplexDecoder(ALPHABET, T1=T_DUP, T2=T_DUP, n_state=S_DUP, **kw)
    res_full, l_full, _ = drive("duplex auto full range (slot kernel)",
                                lambda: dec.decode(dn1, dn2), ["duplex", "traceback"],
                                ("duplex_exact",))
    res_cd, l_cd, _ = drive("duplex engine=cuda diagonal (slot kernel)",
                            lambda: dec_cuda.decode(dn1, dn2, envelopes=diag),
                            ["duplex", "traceback"], ("duplex_exact",))
    res_diag, l_diag, _ = drive("duplex auto diagonal (tree kernel)",
                                lambda: dec.decode(dn1, dn2, envelopes=diag), ["duplex_exact"],
                                ("duplex",))
    res_cdiag, l_cdiag, _ = drive("CRF duplex auto diagonal (CRF tree kernel)",
                                  lambda: crf_dec.decode(c1, i1, c2, i2, envelopes=diag),
                                  ["duplex_exact_crf"], ("duplex", "duplex_exact"))
    res_cfull, l_cfull, cfull_s = drive(
        "CRF duplex auto full range (CRF tree kernel)", lambda: crf_dec.decode(c1, i1, c2, i2),
        ["duplex_exact_crf"], ("duplex", "duplex_exact"))
    if sum(a[0] != b[0] for a, b in zip(res_cd, res_diag)):
        log(f"slot kernel vs tree kernel on the diagonal: "
            f"{sum(a[0] != b[0] for a, b in zip(res_cd, res_diag))}/{B_DUP} sequences differ "
            f"(the slot engines rebuild re-derived prefixes' bands; documented)")
    return {"full": res_full, "cuda_diag": res_cd, "diag": res_diag, "crf_diag": res_cdiag,
            "crf_full": res_cfull, "crf_full_s": cfull_s, "dec": dec, "crf_dec": crf_dec,
            "launches": {"full": l_full, "diag": l_diag, "crf_diag": l_cdiag,
                         "crf_full": l_cfull}}


def auto_past_slot_smem(torch, api, log_counts):
    """Auto on a constant window whose band the slot kernel's shared memory
    cannot hold (beam 8, T2 = 1000) runs the tree kernel and equals the CPU
    tree engine; past both kernels' lanes (beam 9 * 4 labels) it raises."""
    from fast_ctc_decode_tpu_torch import BatchDuplexDecoder

    n1, n2 = make_pairs(2, 8, 1000, len(ALPHABET), 73)
    kw = dict(T1=8, T2=1000, beam_cut_threshold=DUP_THR)
    torch.cuda.synchronize()
    log_counts.reset()
    got = BatchDuplexDecoder(ALPHABET, beam_size=8, device="cuda", **kw).decode(n1, n2)
    one = api.beam_search_duplex(n1[0], n2[0], ALPHABET, beam_size=8, device="cuda")
    launched = log_counts.read()
    want = BatchDuplexDecoder(ALPHABET, beam_size=8, engine="exact", **kw).decode(n1, n2)
    if launched["duplex_exact"] != 2 or launched["duplex"]:
        raise AssertionError(f"auto past the slot kernel's shared memory: launches {launched}")
    if got != want or one != want[0][0]:
        raise AssertionError("auto past the slot kernel's shared memory differs from the CPU")
    try:
        BatchDuplexDecoder(ALPHABET, beam_size=9, device="cuda", **kw).decode(n1, n2)
    except ValueError:
        pass
    else:
        raise AssertionError("auto ran a duplex kernel past its lanes (beam 9 * 4 labels)")
    log(f"duplex auto, constant window past the slot kernel's shared memory (beam 8, T2=1000): "
        f"tree kernel, launches {launched['duplex_exact']} (batch + api), equal to the CPU tree "
        f"engine; beam 9 raises ValueError")


def garbage_scratch(torch, duplex_cuda, duplex_exact_cuda, beam_exact_cuda):
    """Make the duplex wrappers and the exact tree wrapper hand their kernels
    scratch memory full of random bits (NaN patterns and wild indices
    included) instead of whatever ``torch.empty`` finds; returns a function
    that undoes it."""
    saved = duplex_cuda._new_slab, duplex_exact_cuda._new_scratch, beam_exact_cuda._new_scratch
    gen = torch.Generator(device="cuda").manual_seed(90)

    def bits(B, words, device):
        return torch.randint(-2**31, 2**31 - 1, (B, words), generator=gen, device=device,
                             dtype=torch.int64).to(torch.int32)

    duplex_cuda._new_slab = lambda B, words, device: bits(B, words, device).view(torch.float32)
    duplex_exact_cuda._new_scratch = bits
    beam_exact_cuda._new_scratch = bits

    def restore():
        duplex_cuda._new_slab, duplex_exact_cuda._new_scratch, beam_exact_cuda._new_scratch = saved
    return restore


def duplex_runners(duplex_cuda):
    """Callers of the duplex kernels and plain engines on prepared inputs."""
    def diff(got, want):
        return max(max_abs_diff(g, w) for g, w in zip(got, want))

    def slot_run(fn, inp, K, collapse):
        l1, l2, rg, lo, hi, lt, _, ln, st = inp
        return fn(l1, l2, rg, lo, hi, lt, ln, beam_size=K, collapse_repeats=collapse,
                  needs_ext=st["needs_ext"])

    def slot_plain(inp, K, collapse):
        l1, l2, rg, lo, hi, lt, init, ln, st = inp
        return duplex_cuda.duplex_ids_plain(l1, l2, rg, lo, hi, lt, init, ln, beam_size=K,
                                            collapse_repeats=collapse,
                                            needs_ext=st["needs_ext"], crf=False)

    def tree_run(fn, inp, K, collapse, crf, N=None):
        l1, l2, rg, lo, hi, lt, init, ln, st = inp
        st = dict(st, max_nodes=N or st["max_nodes"])
        out = fn(l1, l2, rg, lo, hi, lt, init, ln, beam_size=K, collapse_repeats=collapse,
                 crf=crf, **st)
        return [out[f] for f in DUP_FIELDS]

    return diff, slot_run, slot_plain, tree_run


def duplex_parity_phase(torch, dev):
    """Phase 8: the duplex kernels against their plain versions, bit for bit,
    on the card, with garbage in the kernels' scratch memory.  Returns the
    largest difference of the slot, tree and CRF tree kernels (0 or it
    raised)."""
    from fast_ctc_decode_tpu_torch.ops import beam_exact_cuda, duplex_cuda, duplex_exact_cuda

    diff, slot_run, slot_plain, tree_run = duplex_runners(duplex_cuda)
    t0 = time.perf_counter()
    bad = duplex_cuda.math_check(dev)
    log(f"duplex math check: exp_f32 / log1p_f32 differ from expf / log1pf on {bad[0]} / "
        f"{bad[1]} of 2^32 float arguments ({time.perf_counter() - t0:.2f} s)")
    if any(bad):
        raise AssertionError("the duplex kernels' exp / log1p differ from the math library's")
    restore = garbage_scratch(torch, duplex_cuda, duplex_exact_cuda, beam_exact_cuda)
    err_slot = err_tree = err_tree_crf = 0
    for name, kind, inputs, kw in duplex_parity_cases():
        K, thr, collapse, N = kw["K"], kw["thr"], kw["collapse"], kw["N"]
        crf = kind == "crf"
        if crf:
            (c1, i1, c2, i2), env = inputs
            n1, n2, crf_in = c1, c2, (i1, i2)
        else:
            n1, n2, env = inputs
            crf_in = None
        lengths = kw["lengths"]
        msg = []
        if kind == "plain":
            inp = duplex_inputs(torch, dev, n1, n2, env, thr, K=K, lengths=lengths)
            d_ids = diff(slot_run(duplex_cuda.duplex_ids_kernel, inp, K, collapse),
                         slot_plain(inp, K, collapse))
            got = slot_run(duplex_cuda.duplex_kernel_batch, inp, K, collapse)
            l1, l2, rg, lo, hi, lt, init, ln, st = inp
            want = duplex_cuda.duplex_fast.duplex_fast_batch(
                l1, l2, rg, lo, hi, lt, init, ln, beam_size=K, collapse_repeats=collapse,
                needs_ext=st["needs_ext"], crf=False)
            d_slot = max(d_ids, diff([got[f] for f in DUP_FIELDS], [want[f] for f in DUP_FIELDS]))
            err_slot = max(err_slot, d_slot)
            Wk = duplex_cuda.band_width(lo, hi)
            msg.append(f"slot {d_slot} (codes {sorted(set(got['err'].tolist()))}, Wk {Wk}, stage "
                       f"in {'shared memory' if duplex_cuda.stage_in_shared_memory(K, Wk) else 'the slab'})")
            if d_slot:
                raise AssertionError(f"duplex slot kernel != plain on case {name}")
        inp = duplex_inputs(torch, dev, n1, n2, env, thr, crf=crf_in, tree=True, K=K,
                            lengths=lengths)
        got = tree_run(duplex_exact_cuda.duplex_exact_kernel_batch, inp, K, collapse, crf, N)
        want = tree_run(duplex_exact_cuda.duplex_exact_plain, inp, K, collapse, crf, N)
        d_tree = diff(got, want)
        W = inp[-1]["W"]
        msg.append(f"tree{' crf' if crf else ''} {d_tree} (codes {sorted(set(got[2].tolist()))}, "
                   f"W {W}, stage in "
                   f"{'shared memory' if duplex_exact_cuda.stage_in_shared_memory(K, W) else 'the slab'})")
        if d_tree:
            raise AssertionError(f"duplex tree kernel != plain on case {name}")
        if crf:
            err_tree_crf = max(err_tree_crf, d_tree)
        else:
            err_tree = max(err_tree, d_tree)
        if kind == "tree" and name in ("lower_steps_back", "beam8_band_past_shared_stage"):
            # outside the slot kernel's bounds: a CUDA tensor raises
            sl = duplex_inputs(torch, dev, n1, n2, env, thr, K=K)
            try:
                slot_run(duplex_cuda.duplex_ids_kernel, sl, K, collapse)
            except ValueError:
                msg.append("slot kernel refuses it (ValueError)")
            else:
                raise AssertionError("the slot kernel ran outside its bounds")
        torch.cuda.synchronize()
        log(f"parity duplex {name}: max_abs_err " + ", ".join(msg))
    restore()
    return err_slot, err_tree, err_tree_crf


def duplex_launch_shapes(build_log):
    """Log what ptxas reports for the two duplex kernels, and how their blocks
    fill an SM at the full-width shapes."""
    from fast_ctc_decode_tpu_torch.ops import duplex_cuda, duplex_exact_cuda

    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "duplex" in line:
            log("ptxas duplex: " + " | ".join(x.strip() for x in lines[i:i + 4]))
    A = len(ALPHABET) - 1
    for what, Wk in (("full range", T_DUP + 2), (f"diag{W_DIAG}", 2 * W_DIAG + 3)):
        sh = duplex_cuda.launch_shape(BEAM, Wk)
        log(f"duplex_slot_kernel {what} (beam {BEAM}, Wk {Wk}): block {sh['block']} threads, "
            f"{sh['smem']} bytes of dynamic shared memory, {sh['blocks_per_sm']} blocks per SM, "
            f"slab {4 * duplex_cuda.slab_words(BEAM, A, Wk)} bytes per pair")
    for crf, what, W in ((False, f"diag{W_DIAG}", 2 * W_DIAG + 3),
                         (True, f"diag{W_DIAG}", 2 * W_DIAG + 3), (True, "full range", T_DUP + 1)):
        sh = duplex_exact_cuda.launch_shape(BEAM, W, crf=crf)
        log(f"duplex_exact_kernel{' CRF' if crf else ''} {what} (beam {BEAM}, W {W}): block "
            f"{sh['block']} threads, {sh['smem']} bytes of dynamic shared memory, "
            f"{sh['blocks_per_sm']} blocks per SM")


def duplex_kernel_times(torch, dev, smi, dn1, dn2, c1, i1, c2, i2, diag):
    """Phase 12's kernel part: each duplex kernel timed beside its plain
    version on the same full-width shape and held to it there, and the
    traceback's routes held to their plain version and timed on the slot
    kernel's full-range log; returns ({name: (kernel_ms, plain_ms)} with
    "traceback": ({route: max_abs_err}, {route: ms}), {name: bound})."""
    from fast_ctc_decode_tpu_torch.ops import beam_cuda, duplex_cuda, duplex_exact_cuda

    diff, slot_run, slot_plain, tree_run = duplex_runners(duplex_cuda)
    full_env = np.stack([np.zeros(T_DUP, np.int64), np.full(T_DUP, T_DUP, np.int64)], 1)
    shape = f"B={B_DUP} T1=T2={T_DUP}"
    rows = {}
    bounds = {}
    for name, env in (("slot full", full_env), (f"slot diag{W_DIAG}", diag)):
        inp = duplex_inputs(torch, dev, dn1, dn2, env, DUP_THR)
        bounds[name] = duplex_bound(inp, BEAM, len(ALPHABET) - 1, tree=False)
        k_ms = median_event_ms(lambda: slot_run(duplex_cuda.duplex_ids_kernel, inp, BEAM, True),
                               torch)
        got = slot_run(duplex_cuda.duplex_ids_kernel, inp, BEAM, True)
        p_ms, want = once_event_ms(lambda: slot_plain(inp, BEAM, True), torch)
        d = diff(got, want)
        log(f"time duplex {name} {shape}: kernel {k_ms!r} ms, plain {p_ms!r} ms; full-width "
            f"max_abs_err {d} [{smi}]")
        if d:
            raise AssertionError(f"duplex slot kernel != plain at full width ({name})")
        rows[name] = (k_ms, p_ms)
        if name == "slot full":  # row 2 on the slot kernel's full-range log
            ids_log, fin, _ = got
            A = len(ALPHABET) - 1
            tb_err = traceback_parity(torch, fin, ids_log, A,
                                      f"duplex slot full-range log {shape}")
            tb_ms = {route: median_event_ms(lambda route=route: beam_cuda.traceback_kernel(
                fin, ids_log, T=T_DUP, K=BEAM, A=A, route=route), torch, calls=TB_CALLS)
                for route in beam_cuda.TRACEBACK_ROUTES}
            log(f"time traceback on the duplex slot full-range log {shape}: {tb_ms} ms [{smi}]")
            rows["traceback"] = (tb_err, tb_ms)
    for name, crf in (("tree", False), ("tree crf", True)):
        if crf:
            inp = duplex_inputs(torch, dev, c1, c2, diag, DUP_THR, crf=(i1, i2), tree=True)
        else:
            inp = duplex_inputs(torch, dev, dn1, dn2, diag, DUP_THR, tree=True)
            bounds[name] = duplex_bound(inp, BEAM, len(ALPHABET) - 1, tree=True)
        k_ms = median_event_ms(
            lambda: tree_run(duplex_exact_cuda.duplex_exact_kernel_batch, inp, BEAM, not crf, crf),
            torch)
        got = tree_run(duplex_exact_cuda.duplex_exact_kernel_batch, inp, BEAM, not crf, crf)
        p_ms, want = once_event_ms(
            lambda: tree_run(duplex_exact_cuda.duplex_exact_plain, inp, BEAM, not crf, crf), torch)
        d = diff(got, want)
        log(f"time duplex {name} diag{W_DIAG} {shape}{' S=16' if crf else ''}: kernel "
            f"{k_ms!r} ms, plain {p_ms!r} ms; full-width max_abs_err {d} [{smi}]")
        if d:
            raise AssertionError(f"duplex {name} kernel != plain at full width")
        rows[name] = (k_ms, p_ms)
        del inp, got, want
        torch.cuda.empty_cache()
    return rows, bounds


def crf_full_range_chunks(torch, dev, smi, c1, i1, c2, i2, log_counts):
    """Phase 12's chunk check: the CRF full range through the exact engine in
    the chunks sized from the card's free memory, held to a run forced to
    the CPU's 2 GB chunks on the same inputs (0 differing entries, equal
    statuses), each in the launches ``exact_launch_pairs`` gives; both timed
    in turns (the tree kernel's launches alone, CUDA events around each,
    summed; and the engine's wall); returns the figures for the kernels
    line."""
    from fast_ctc_decode_tpu_torch.ops import duplex_exact_cuda
    from fast_ctc_decode_tpu_torch.parallel import pipeline

    batch = pipeline.prep_duplex_batch(c1, c2, None, None, DUP_THR, T1=T_DUP, T2=T_DUP,
                                       init1=i1, init2=i2)
    budgets = {"sized": None, "2 GB": pipeline.EXACT_CHUNK_BYTES}

    def run(budget):
        return pipeline.run_duplex_engine("exact", batch, dev, beam_size=BEAM, collapse=False,
                                          crf=True, budget_bytes=budget)

    per_pair = 4 * duplex_exact_cuda.scratch_stride(batch.max_nodes(BEAM), BEAM,
                                                    len(ALPHABET) - 1, batch.W)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out, fig = {}, {}
    for what, budget in budgets.items():
        chunk = pipeline.exact_launch_pairs(batch, dev, beam_size=BEAM, crf=True,
                                            budget_bytes=budget)
        free = torch.cuda.mem_get_info(dev)[0]
        log_counts.reset()
        out[what] = run(budget)
        torch.cuda.synchronize()
        launched = log_counts.read()["duplex_exact_crf"]
        want = -(-B_DUP // chunk)
        fig[what] = {"chunk_pairs": chunk, "launches": launched,
                     "reserved_bytes": torch.cuda.memory_reserved(dev)}
        log(f"duplex CRF full range B={B_DUP} T1=T2={T_DUP} S={S_DUP}, {what} chunks: "
            f"{chunk} pairs a launch (W {batch.W}, {per_pair} bytes of scratch a pair; {free} "
            f"bytes free before), {launched} launches (expected {want}); the "
            f"caching allocator keeps {fig[what]['reserved_bytes']} bytes reserved after it")
        if launched != want:
            raise AssertionError(f"CRF full range, {what} chunks: {launched} launches, "
                                 f"expected {want}")
    d = max(max_abs_diff(out["sized"][k], out["2 GB"][k]) for k in DUP_FIELDS)
    if d or not torch.equal(out["sized"]["err"], out["2 GB"]["err"]):
        raise AssertionError(f"CRF full range: sized chunks != 2 GB chunks (max_abs_err {d})")
    if bool((out["sized"]["err"] != 0).any()):
        raise AssertionError("CRF full range through the exact engine: status codes not all OK")
    del out
    # in turns, three of each
    times = {what: [] for what in budgets}
    walls = {what: [] for what in budgets}
    for what in ("sized", "2 GB", "2 GB", "sized", "sized", "2 GB"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k_ms, _ = launch_event_ms(torch, duplex_exact_cuda, "duplex_exact_kernel_batch",
                                  lambda w=what: run(budgets[w]))
        walls[what].append((time.perf_counter() - t0) * 1e3)
        times[what].append(k_ms)
    for what in budgets:
        fig[what]["kernel_ms"] = statistics.median(times[what])
        fig[what]["wall_ms"] = statistics.median(walls[what])
        log(f"time duplex CRF full range B={B_DUP} T1=T2={T_DUP} S={S_DUP}, {what} chunks "
            f"({fig[what]['launches']} launches): kernels {fig[what]['kernel_ms']!r} ms "
            f"(each: {', '.join(f'{t:.3f}' for t in times[what])}), engine wall "
            f"{fig[what]['wall_ms']!r} ms; max_abs_err against the other {d} [{smi}]")
    fig["max_abs_err"] = d
    # one launch of the first b pairs: how a launch's time grows with the
    # pairs resident beside each other
    fig["one_launch_ms"] = {}
    for b in CHUNK_SWEEP:
        sub = batch._replace(**{k: getattr(batch, k)[:b] for k in (
            "l1", "l2", "root_gap", "lo", "hi", "init_states", "lengths")})
        one = lambda sub=sub: pipeline.run_duplex_engine(
            "exact", sub, dev, beam_size=BEAM, collapse=False, crf=True)
        one()
        t = [launch_event_ms(torch, duplex_exact_cuda, "duplex_exact_kernel_batch", one)
             for _ in range(3)]
        if any(n != 1 for _, n in t):
            raise AssertionError(f"CRF full range, first {b} pairs: {t[0][1]} launches, not 1")
        fig["one_launch_ms"][b] = statistics.median(ms for ms, _ in t)
    log(f"time duplex CRF full range T1=T2={T_DUP} S={S_DUP}, one launch of the first b pairs "
        f"(CUDA events, median of 3): "
        f"{', '.join(f'b={b}: {ms:.3f} ms' for b, ms in fig['one_launch_ms'].items())} [{smi}]")
    return fig


def duplex_phases(torch, dev, smi, log_counts):
    """Phases 8-12 (duplex); returns the two duplex kernels' JSON rows and
    row 2's part: {"err", "ms"} on the slot kernel's full-range log and
    "launches" on the slot path."""
    from duplex_helpers import diag_env
    from fast_ctc_decode_tpu_torch import api, decode_many_duplex

    # ---- phase 8: duplex kernels vs plain, bit for bit, on the card ----
    err_slot, err_tree, err_tree_crf = duplex_parity_phase(torch, dev)

    # ---- phase 9: the duplex paths at full width ----
    dn1, dn2 = make_pairs(B_DUP, T_DUP, T_DUP, len(ALPHABET), 70)
    c1, i1, c2, i2 = make_crf_pairs(B_DUP, T_DUP, T_DUP, S_DUP, len(ALPHABET), 71)
    diag = diag_env(T_DUP, T_DUP, W_DIAG)
    sample = np.linspace(0, B_DUP - 1, ORACLE_SAMPLES).astype(int)
    jobs = {
        "full": [("plain", (dn1[i], dn2[i], ALPHABET), dict(beam_size=BEAM)) for i in sample],
        "diag": [("plain", (dn1[i], dn2[i], ALPHABET), dict(envelope=diag, beam_size=BEAM))
                 for i in sample],
        "crf_diag": [("crf", (c1[i], i1[i], c2[i], i2[i], ALPHABET),
                      dict(envelope=diag, beam_size=BEAM)) for i in sample],
        "crf_full": [("crf", (c1[i], i1[i], c2[i], i2[i], ALPHABET), dict(beam_size=BEAM))
                     for i in sample],
    }
    # the oracle is plain Python: it runs in worker processes while the card works
    pool = multiprocessing.get_context("spawn").Pool(min(6, os.cpu_count() or 1))
    try:
        pending = {k: pool.map_async(oracle_job, v) for k, v in jobs.items()}
        res = duplex_paths(torch, dn1, dn2, c1, i1, c2, i2, diag, log_counts)
        for key, out in (("full", res["full"]), ("diag", res["diag"]),
                         ("crf_diag", res["crf_diag"]), ("crf_full", res["crf_full"])):
            want = pending[key].get(timeout=900)
            for i, w in zip(sample, want):
                if out[i][0] != w:
                    raise AssertionError(f"duplex {key} pair {i}: {out[i][0]!r} != oracle {w!r}")
            log(f"oracle gate duplex {key}: {ORACLE_SAMPLES} sampled pairs equal "
                f"tests/oracle.py (mean length {np.mean([len(r[0]) for r in out]):.1f})")
    finally:
        pool.terminate()
        pool.join()
    res_full, res_cd, res_diag, res_cdiag = (res[k] for k in ("full", "cuda_diag", "diag", "crf_diag"))
    l_full, l_diag, l_cdiag, cfull_s = res["launches"]["full"], res["launches"]["diag"], \
        res["launches"]["crf_diag"], res["crf_full_s"]
    dec, crf_dec = res["dec"], res["crf_dec"]
    auto_past_slot_smem(torch, api, log_counts)

    # ---- phase 10: decode_many_duplex resumes from a checkpoint ----
    rng = np.random.RandomState(72)
    t1s = rng.randint(100, 601, size=200)
    t1s[0] = 600  # the interrupted run sees the same auto bucket edges
    t2s = np.clip(t1s + rng.randint(-20, 21, size=200), 80, None)
    t2s[0] = 620
    pairs = []
    for i, (a, b) in enumerate(zip(t1s, t2s)):
        p1, p2 = make_pairs(1, int(a), int(b), len(ALPHABET), 3000 + 2 * i)
        pairs.append((p1[0], p2[0], diag_env(int(a), int(b), 30)))
    mkw = dict(beam_size=BEAM, beam_cut_threshold=DUP_THR, batch_size=64, device="cuda")
    log_counts.reset()
    t0 = time.perf_counter()
    full = decode_many_duplex(pairs, ALPHABET, **mkw)
    full_s = time.perf_counter() - t0
    if log_counts.read()["duplex_exact"] < 1:
        raise AssertionError("decode_many_duplex: the tree kernel never launched")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "duplex.jsonl")
        half = decode_many_duplex(pairs[:100], ALPHABET, checkpoint_path=ckpt, **mkw)
        resumed = decode_many_duplex(pairs, ALPHABET, checkpoint_path=ckpt, **mkw)
        before = log_counts.read()
        again = decode_many_duplex(pairs, ALPHABET, checkpoint_path=ckpt, **mkw)
        if log_counts.read() != before:
            raise AssertionError("a complete duplex checkpoint decoded again")
    if half != full[:100] or resumed != full or again != full:
        raise AssertionError("decode_many_duplex: resumed results differ from an uninterrupted run")
    if any(e != 0 for _, e in full):
        raise AssertionError("decode_many_duplex: status codes not all OK")
    log(f"decode_many_duplex: {len(pairs)} pairs, T1 {t1s.min()}-{t1s.max()}, T2 "
        f"{t2s.min()}-{t2s.max()}, per-pair diagonal envelopes, {full_s:.3f} s uninterrupted; "
        f"resumed run equals it")

    # ---- phase 11: the single-read duplex API on the card ----
    for i in (0, 1):
        checks = [
            ("auto full range (slot kernel)", api.beam_search_duplex(
                dn1[i], dn2[i], ALPHABET, beam_size=BEAM, device="cuda"), res_full[i][0]),
            ("fast on the diagonal (slot kernel)", api.beam_search_duplex(
                dn1[i], dn2[i], ALPHABET, envelope=diag, beam_size=BEAM, engine="fast",
                device="cuda"), res_cd[i][0]),
            ("auto diagonal (tree kernel)", api.beam_search_duplex(
                dn1[i], dn2[i], ALPHABET, envelope=diag, beam_size=BEAM, device="cuda"),
             res_diag[i][0]),
            ("CRF auto diagonal (CRF tree kernel)", api.crf_beam_search_duplex(
                c1[i], i1[i], c2[i], i2[i], ALPHABET, envelope=diag, beam_size=BEAM,
                device="cuda"), res_cdiag[i][0]),
        ]
        for what, got, want in checks:
            if got != want:
                raise AssertionError(f"api duplex {what} pair {i} differs from the batch")
    back = diag.copy()
    back[300, 0] -= 5
    try:
        api.beam_search_duplex(dn1[0], dn2[0], ALPHABET, envelope=back, engine="fast",
                               device="cuda")
    except ValueError:
        pass
    else:
        raise AssertionError("the slot kernel ran outside its envelope class")
    log("single-read api.beam_search_duplex (auto, fast, exact) / crf_beam_search_duplex "
        "on the card equal the batch results; engine='fast' outside the slot kernel's "
        "class raises ValueError")

    # ---- phase 12: times at full width; kernels held to plain there too ----
    rows, bounds = duplex_kernel_times(torch, dev, smi, dn1, dn2, c1, i1, c2, i2, diag)
    shape = f"B={B_DUP} T1=T2={T_DUP}"
    dec_ms = {
        "auto full range decode_arrays": median_ms(lambda: dec.decode_arrays(dn1, dn2), torch, 3),
        "auto full range decode": median_ms(lambda: dec.decode(dn1, dn2), torch, 3),
        "auto diagonal decode_arrays": median_ms(
            lambda: dec.decode_arrays(dn1, dn2, envelopes=diag), torch, 3),
        "auto diagonal decode": median_ms(lambda: dec.decode(dn1, dn2, envelopes=diag), torch, 3),
        "CRF auto diagonal decode": median_ms(
            lambda: crf_dec.decode(c1, i1, c2, i2, envelopes=diag), torch, 3),
        "CRF auto full range decode (CRF tree kernel; the plain CRF slot engine it replaces took "
        "89097 ms on an H100 80GB HBM3 at 700 W)":
            median_ms(lambda: crf_dec.decode(c1, i1, c2, i2), torch, 3),
        "CRF auto full range decode (CRF tree kernel), first call": cfull_s * 1e3,
    }
    for name, t in dec_ms.items():
        log(f"time duplex {name} {shape}: {t!r} ms ({B_DUP / (t / 1e3):.1f} pairs/s) [{smi}]")
    # the CRF tree kernel's launches alone on the full range (events around each)
    from fast_ctc_decode_tpu_torch.ops import duplex_exact_cuda

    cfull = [launch_event_ms(torch, duplex_exact_cuda, "duplex_exact_kernel_batch",
                             lambda: crf_dec.decode(c1, i1, c2, i2)) for _ in range(3)]
    cfull_ms = statistics.median(t for t, _ in cfull)
    log(f"time duplex CRF auto full range {shape} S={S_DUP}, the CRF tree kernel's "
        f"{cfull[0][1]} launches alone (CUDA events around each, summed): median of 3 "
        f"{cfull_ms!r} ms (each: {', '.join(f'{t:.3f}' for t, _ in cfull)}) [{smi}]")
    chunks = crf_full_range_chunks(torch, dev, smi, c1, i1, c2, i2, log_counts)

    src = "fast_ctc_decode_tpu_torch/csrc/"
    tb = {"err": rows["traceback"][0], "ms": rows["traceback"][1],
          "launches": l_full["traceback"]}
    return tb, [
        {"name": "duplex_slot_kernel", "route": "cuda", "source": src + "duplex_kernel.cu",
         "replaces": "fast_ctc_decode_tpu/ops/duplex_pallas.py:103",
         "launches": l_full["duplex"], "max_abs_err": err_slot,
         "ms": rows["slot full"][0], "plain_ms": rows["slot full"][1],
         "bound_ms": bounds["slot full"][0], "bound_by": bounds["slot full"][1],
         "library_ms": None,
         "diag_ms": rows[f"slot diag{W_DIAG}"][0], "diag_plain_ms": rows[f"slot diag{W_DIAG}"][1],
         "diag_bound_ms": bounds[f"slot diag{W_DIAG}"][0]},
        {"name": "duplex_exact_kernel", "route": "cuda", "source": src + "duplex_exact_kernel.cu",
         "replaces": "fast_ctc_decode_tpu/ops/duplex_exact_pallas.py:108",
         "launches": l_diag["duplex_exact"] + l_cdiag["duplex_exact_crf"],
         "max_abs_err": max(err_tree, err_tree_crf),
         "ms": rows["tree"][0], "plain_ms": rows["tree"][1],
         "bound_ms": bounds["tree"][0], "bound_by": bounds["tree"][1], "library_ms": None,
         "crf_launches": l_cdiag["duplex_exact_crf"],
         "crf_full_range_launches": res["launches"]["crf_full"]["duplex_exact_crf"],
         "crf_full_range_ms": cfull_ms, "crf_full_range_chunks": chunks,
         "crf_ms": rows["tree crf"][0], "crf_plain_ms": rows["tree crf"][1]},
    ]


def ab_phase(torch, dev, smi):
    """Phase 13: the A/B path.  Versions 1, 2 and 3 of the beam kernel equal
    one another on all four fields at the main shape (``tools.ab_bench``
    exits at the first mismatch), then each version's kernel alone and its
    full pipeline are timed, and ``decode`` through ``BatchBeamDecoder``
    (which runs version 2)."""
    from fast_ctc_decode_tpu_torch import BatchBeamDecoder
    from fast_ctc_decode_tpu_torch.ops import beam_cuda
    from fast_ctc_decode_tpu_torch.tools import ab_bench

    probs_d = torch.from_numpy(make_reads(B_MAIN, T_MAIN, len(ALPHABET), 42)).to(dev)
    lengths_d = torch.full((B_MAIN,), T_MAIN, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    beam_cuda.reset_launches()
    out = ab_bench.parity(probs_d, lengths_d, THR, beam_size=BEAM)
    torch.cuda.synchronize()
    launched = dict(beam_cuda.launches)
    if min(launched[k] for k in ("beam_v1", "beam", "beam_v3")) < 1:
        raise AssertionError(f"A/B path: a version never launched: {launched}")
    if int((out["err"] != 0).sum()) or int(out["count"].min()) < 1:
        raise AssertionError("A/B path: statuses not all OK")
    log(f"A/B path B={B_MAIN} T={T_MAIN}: versions 1, 2, 3 equal on {', '.join(FIELDS)}; "
        f"launches {launched}")
    times = ab_bench.time_versions(probs_d, lengths_d, THR, beam_size=BEAM)
    for (v, kind), t in times.items():
        log(f"time A/B v{v} {'raw kernel' if kind == 'raw' else 'full pipeline'} "
            f"B={B_MAIN} T={T_MAIN}: {t!r} ms ({B_MAIN / (t / 1e3):.1f} reads/s) [{smi}]")
    dec = BatchBeamDecoder(ALPHABET, T=T_MAIN, beam_size=BEAM, beam_cut_threshold=THR,
                           device="cuda")
    dec_ms = median_ms(lambda: dec.decode(probs_d, lengths_d), torch, 3)
    log(f"time A/B BatchBeamDecoder.decode (version 2) B={B_MAIN} T={T_MAIN}: {dec_ms!r} ms "
        f"({B_MAIN / (dec_ms / 1e3):.1f} reads/s) [{smi}]")
    del probs_d, lengths_d, out
    torch.cuda.empty_cache()
    return launched, times


def ablate_phase(torch, dev, smi):
    """Phase 14: the ablation path.  Each of the tool's nine sets on the
    kernel (version 1's one-pass body with phases stubbed) equals
    ``ablate_plain`` (fin, err), and the whole kernel (no phase stubbed)
    equals version 1, at B=256, T=200 (ragged and zero lengths) and at the
    tool's default B=16384, T=1000; then ``tools.kernel_ablate`` times all
    nine at that shape."""
    from fast_ctc_decode_tpu_torch.ops import beam_cuda
    from fast_ctc_decode_tpu_torch.tools import kernel_ablate as ka

    def parity(p, ln, what):
        """Max fin/err difference of the nine sets against ``ablate_plain``
        (raises on any), and the plain version's one-call ms of each set."""
        worst, plain = 0, {}
        for ab in ka.SETS:
            got = ka.run_ablate(p, ln, THR, beam_size=BEAM, ablate=ab)
            plain[ab], want = once_event_ms(
                lambda ab=ab: ka.ablate_plain(p, ln, THR, beam_size=BEAM, ablate=ab), torch)
            d = max(max_abs_diff(got[k], want[k]) for k in ("fin", "err"))
            log(f"parity ablate {ab or 'none'} {what}: fin/err max_abs_err {d}, err codes "
                f"{sorted(set(got['err'].tolist()))}")
            if d:
                raise AssertionError(f"ablation kernel != ablate_plain for set {ab!r} at {what}")
            worst = max(worst, d)
        _, fin1, err1 = beam_cuda.beam_ids_kernel(p, ln, THR, beam_size=BEAM, version=1)
        whole = ka.run_ablate(p, ln, THR, beam_size=BEAM)
        if not (torch.equal(whole["fin"], fin1) and torch.equal(whole["err"], err1)):
            raise AssertionError(f"the ablation kernel with nothing stubbed differs from "
                                 f"version 1 at {what}")
        log(f"parity ablate none {what}: equal to version 1 (fin, err)")
        return worst, plain

    p = torch.from_numpy(make_reads(256, 200, len(ALPHABET), 80)).to(dev)
    ln = torch.from_numpy(np.random.RandomState(81).randint(0, 201, 256).astype(np.int32)).to(dev)
    err, _ = parity(p, ln, "B=256 T=200")
    B, T = 16384, 1000
    pd = torch.from_numpy(make_reads(B, T, len(ALPHABET), 42)).to(dev)
    ld = torch.full((B,), T, dtype=torch.int32, device=dev)
    d, plain = parity(pd, ld, f"B={B} T={T}")
    err = max(err, d)
    torch.cuda.synchronize()
    ka.launches["ablate"] = 0
    ms = ka.time_sets(pd, ld, THR, beam_size=BEAM)
    torch.cuda.synchronize()
    launches = ka.launches["ablate"]
    if launches < len(ka.SETS):
        raise AssertionError(f"ablation path: {launches} launches for {len(ka.SETS)} sets")
    for ab, t in ms.items():
        log(f"time ablate={ab or 'none':12s} B={B} T={T}: {t!r} ms, delta "
            f"{ms[''] - t:+.3f} ms [{smi}]")
    plain_ms = plain[""]
    log(f"time ablate_plain (none) B={B} T={T}: {plain_ms!r} ms (one call) [{smi}]")
    row = {"launches": launches, "max_abs_err": err, "ms": ms[""], "plain_ms": plain_ms,
           "bound": beam_bound(np.full(B, T), T, BEAM, len(ALPHABET)),
           "sets_ms": {ab or "none": t for ab, t in ms.items()}}
    del pd, ld
    torch.cuda.empty_cache()
    return row


def serving_phase(torch, dev, smi, oracle, counts, reset_counts):
    """Phase 15: the JSON/HTTP service on the card with micro-batching, and
    the torch.distributed counters (world size 1 over NCCL)."""
    import http.client
    import socket
    import threading

    from fast_ctc_decode_tpu_torch import BatchBeamDecoder, BatchViterbiDecoder, api, serve
    from fast_ctc_decode_tpu_torch.ops import beam_cuda
    from fast_ctc_decode_tpu_torch.parallel import mesh, pipeline

    httpd = serve.make_http_server("127.0.0.1", 0, microbatch=True, device="cuda")
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            t0 = time.perf_counter()
            conn.request("POST", "/", body)
            r = conn.getresponse()
            data = r.read()
            return r.status, json.loads(data), time.perf_counter() - t0
        finally:
            conn.close()

    def request(x, method="beam_search", **kw):
        return json.dumps({"method": method, "posteriors": x.reshape(-1).tolist(),
                           "shape": list(x.shape), "alphabet": list(ALPHABET), **kw})

    try:
        # a beam batch request, B=256 reads of T=1000
        Bs = 256
        sp = make_reads(Bs, T_MAIN, len(ALPHABET), 90)
        body = request(sp, beam_size=BEAM, beam_cut_threshold=THR)
        reset_counts()
        status, out, batch_s = post(body)
        launched = counts()
        if (status != 200 or launched[beam_counter(beam_cuda.design_for(Bs, BEAM, len(ALPHABET) - 1))] < 1
                or launched["traceback"] < 1):
            raise AssertionError(f"serve batch beam request: status {status}, launches {launched}")
        want = BatchBeamDecoder(ALPHABET, T=T_MAIN, beam_size=BEAM, beam_cut_threshold=THR,
                                device="cuda").decode(sp, np.full(Bs, T_MAIN, np.int32))
        got = [(r["seq"], r["starts"], r["err"]) for r in out["results"]]
        if got != want:
            raise AssertionError("serve batch beam request differs from BatchBeamDecoder")
        for i in np.linspace(0, Bs - 1, 8).astype(int):
            if got[i][0] != oracle.beam_search(sp[i], ALPHABET, BEAM, THR)[0]:
                raise AssertionError(f"serve batch read {i} differs from tests/oracle.py")
        walls = [batch_s]  # the first request's wall, then four more of the same body
        for _ in range(4):
            status, again, wall = post(body)
            if status != 200 or again != out:
                raise AssertionError("serve batch beam request: a repeat differs from the first")
            walls.append(wall)
        batch_s = float(np.median(walls))
        log(f"serve: beam batch request B={Bs} T={T_MAIN} over HTTP equals BatchBeamDecoder on "
            f"the card, 8 reads equal tests/oracle.py; launches {launched} (first request); "
            f"wall median of 5 {batch_s:.3f} s, {Bs / batch_s:.1f} reads/s (each s: "
            f"{', '.join(f'{w:.3f}' for w in walls)}; request JSON {len(body) / 2**20:.1f} MiB "
            f"parsed on the server) [{smi}]")

        # a viterbi batch request
        vp = make_reads(64, T_MAIN, len(ALPHABET), 91)
        status, out, vit_s = post(request(vp, method="viterbi_search"))
        want = BatchViterbiDecoder(ALPHABET, T=T_MAIN, device="cuda").decode(
            vp, np.full(64, T_MAIN, np.int32))
        if status != 200 or [(r["seq"], r["starts"]) for r in out["results"]] != want:
            raise AssertionError("serve viterbi batch request differs from BatchViterbiDecoder")
        log(f"serve: viterbi batch request B=64 T={T_MAIN} equals BatchViterbiDecoder; "
            f"{vit_s:.3f} s")

        # 64 concurrent single reads (bucket 1024, micro-batched) and one malformed request
        n = 64
        lens = np.random.RandomState(92).randint(600, T_MAIN + 1, n)
        reads = [make_reads(1, int(t), len(ALPHABET), 1100 + i)[0] for i, t in enumerate(lens)]
        bodies = [request(x, beam_size=BEAM, beam_cut_threshold=THR) for x in reads]
        bodies.append('{"method": "beam_search", "shape": [10, 5], "alphabet": "NACGT"}')
        results = [None] * len(bodies)

        def one(i):
            results[i] = post(bodies[i])

        mb = serve._MICRO
        b0 = mb.batches
        reset_counts()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=150)
        singles_s = time.perf_counter() - t0
        launched = counts()
        batches = mb.batches - b0
        if any(r is None for r in results):
            raise AssertionError("serve: a single-read request did not finish")
        if results[-1][0] != 400 or "error" not in results[-1][1]:
            raise AssertionError(f"serve: the malformed request got {results[-1][:2]}")
        for i, x in enumerate(reads):
            status, r, _ = results[i]
            if status != 200 or r["seq"] != api.beam_search(x, ALPHABET, BEAM, THR,
                                                            device="cuda")[0]:
                raise AssertionError(f"serve: single read {i} differs from api.beam_search")
        if not batches < n or launched["beam"] + launched["beam_warp"] < 1:
            raise AssertionError(f"serve: {batches} batches for {n} reads, launches {launched}")
        lat = np.array([r[2] for r in results[:n]]) * 1e3
        log(f"serve: {n} concurrent single reads (T {lens.min()}-{lens.max()}, bucket 1024) "
            f"equal api.beam_search on the card; {batches} micro-batches, launches {launched}; "
            f"the malformed request got 400; wall {singles_s:.3f} s, latency p50 "
            f"{np.percentile(lat, 50):.1f} ms, p99 {np.percentile(lat, 99):.1f} ms [{smi}]")
    finally:
        httpd.shutdown()
        httpd.server_close()
        serve.disable_microbatching()
        thread.join(timeout=60)

    # the torch.distributed counters: one process over NCCL
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dport = s.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: the loopback rendezvous
    mesh.distributed_init(f"tcp://127.0.0.1:{dport}", 1, 0)
    try:
        backend = torch.distributed.get_backend()
        _, totals = pipeline.decode_and_count(
            sp, np.full(Bs, T_MAIN, np.int32), beam_size=BEAM, threshold=THR, collapse=True)
        if backend != "nccl" or totals.tolist() != [Bs, 0]:
            raise AssertionError(f"decode_and_count over {backend}: totals {totals.tolist()}")
    finally:
        torch.distributed.destroy_process_group()
    log(f"distributed_init (world size 1, {backend}) + decode_and_count: totals "
        f"{totals.tolist()} after all_reduce")


#: the launch counters behind each row of the kernels line
ROW_COUNTERS = {
    "beam_ids_kernel": ("beam", "beam_warp"),
    "traceback_kernel": ("traceback", "traceback_walk"),
    "beam_ids_kernel_v1": ("beam_v1",),
    "beam_ids_kernel_v3": ("beam_v3",),
    "crf_beam_ids_kernel": ("crf_beam",),
    "exact_beam_kernel": ("exact",),
    "exact_beam_kernel_crf": ("exact_crf",),
    "duplex_slot_kernel": ("duplex",),
    "duplex_exact_kernel": ("duplex_exact", "duplex_exact_crf"),
    "beam_ablate_kernel": (),
    "viterbi_run_means_kernel": ("viterbi_runs",),
}


def tools_phase(torch, dev, smi, main_kernel_ms):
    """Phase 16: the measurement tools and the demo through their entry points
    on the card, each between a reset and a read of every launch counter
    (``hosts``: the counters its workers report); fails if a kernel the tool
    must run never launched, or a plain-engine run launched one.  Returns
    {tool: {counter: launches}}."""
    import importlib.util

    import bench_torch
    from fast_ctc_decode_tpu_torch.ops import beam_cuda, beam_exact_cuda, duplex_cuda
    from fast_ctc_decode_tpu_torch.ops import duplex_exact_cuda, viterbi_cuda
    from fast_ctc_decode_tpu_torch.tools import bench_exact_duplex, benchmark, scaling_bench

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "basecall_demo_torch.py")
    spec = importlib.util.spec_from_file_location("basecall_demo_torch", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    mods = (beam_cuda, beam_exact_cuda, duplex_cuda, duplex_exact_cuda, viterbi_cuda)
    torch.cuda.empty_cache()
    launched = {}

    def drive(tool, fn, want, none=False):
        for m in mods:
            m.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for m in mods for k, v in m.launches.items() if v}
        for r in result if isinstance(result, list) else [result]:
            if isinstance(r, dict) and r.get("mode") == "hosts":  # its workers' counters
                for k, v in r.get("launches", {}).items():
                    got[k] = got.get(k, 0) + v
        launched[tool] = got
        log(f"phase 16 {tool}: {wall:.1f} s, launches {got} [{smi}]")
        missing = [k for k in want if got.get(k, 0) < 1]
        if missing or (none and got):
            raise AssertionError(f"{tool}: launches {got}, expected {want or 'none'}")
        return result

    row = drive("bench_torch", lambda: bench_torch.main({}), ["beam", "traceback"])
    k_ms = main_kernel_ms["beam kernel"] + main_kernel_ms["traceback kernel"]
    log(f"bench_torch (B={row['B']}, cuda): {row['value']!r} reads/s, kernels "
        f"{row['kernels_ms']!r} ms, decode {row['decode_ms']!r} ms; phase 5 of this run: beam "
        f"{main_kernel_ms['beam kernel']!r} + traceback {main_kernel_ms['traceback kernel']!r} "
        f"= {k_ms!r} ms ({row['B'] / (k_ms / 1e3)!r} reads/s) [{smi}]")
    if row["vs_baseline"] is not None or row["engine"] != "cuda" or row["B"] != B_MAIN:
        raise AssertionError(f"bench_torch row {row}")
    drive("bench_torch fast B=4096", lambda: bench_torch.main(
        {"BENCH_ENGINE": "fast", "BENCH_BATCH": "4096"}), [], none=True)
    drive("tools.benchmark", lambda: benchmark.main([]), ["beam_warp", "traceback", "exact"])
    drive("tools.benchmark --full --quick", lambda: benchmark.main(["--full", "--quick"]),
          ["beam_warp", "traceback", "exact", "crf_beam", "exact_crf", "duplex", "duplex_exact",
           "duplex_exact_crf"])
    drive("tools.bench_exact_duplex 256", lambda: bench_exact_duplex.main(["256"]),
          ["duplex_exact"])
    drive("tools.bench_exact_duplex 256 --crf", lambda: bench_exact_duplex.main(["256", "--crf"]),
          ["duplex_exact_crf"])
    drive("tools.scaling_bench overhead --engine cuda",
          lambda: scaling_bench.main(["overhead", "--engine", "cuda"]), ["beam_warp", "traceback"])
    drive("tools.scaling_bench hosts --nproc 1",
          lambda: scaling_bench.main(["hosts", "--nproc", "1"]), ["beam_warp", "traceback"])
    rows = drive("tools.scaling_bench hosts --nproc 2",
                 lambda: scaling_bench.main(["hosts", "--nproc", "2"]), ["beam_warp", "traceback"])
    cards = torch.cuda.device_count()
    if cards < 2 and rows[-1].get("unmeasured") != f"needs 2 CUDA cards, found {cards}":
        raise AssertionError(f"hosts --nproc 2 on {cards} card(s): {rows[-1]}")
    res = drive("examples/basecall_demo_torch.py", lambda: demo.run(),
                ["beam_warp", "traceback", "viterbi_runs"])
    if res["engine"] != "cuda" or res["design"] != "warp" or len(res["beam"]) != 256 or any(
            r[2] != 0 for r in res["beam"]):
        raise AssertionError(f"demo: engine {res['engine']} design {res['design']}")
    if not launched["examples/basecall_demo_torch.py"].keys() & {"duplex", "duplex_exact"}:
        raise AssertionError("demo: the duplex consensus launched no duplex kernel")
    return launched


def exact_launch_shapes(build_log):
    """Log what ptxas reports for the exact tree kernel's four instances, and
    how many blocks of four reads (warps) one SM holds for each."""
    from fast_ctc_decode_tpu_torch.ops import beam_exact_cuda

    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "exact_beam_kernel" in line:
            log("ptxas exact: " + " | ".join(x.strip() for x in lines[i:i + 4]))
    rpb = beam_exact_cuda.READS_PER_BLOCK
    for K, A, what in ((BEAM, len(ALPHABET) - 1, "<5, 4>"), (16, 7, "<16, 7>")):
        for crf in (False, True):
            blocks = beam_exact_cuda.blocks_per_sm(K, A, crf=crf, reads_per_block=rpb)
            log(f"exact_beam_kernel{what}{' CRF' if crf else ''}: block {32 * rpb} threads "
                f"({rpb} reads, one warp each), {blocks} blocks per SM "
                f"({blocks * rpb} reads per SM)")


def exact_parity_phase(torch, dev):
    """Phase 2b: the CRF beam kernel and the exact tree kernel (1D and CRF)
    against their plain versions, bit for bit, with random bits in the tree
    kernel's scratch; the CRF beam kernel at 1, 2, 4 and 8 reads a block on
    every case, the tree kernel's small cases at 1, 2, 4 or 8 in turn and
    its full-width ones at the default.  Returns (err_crf, err_exact,
    err_exact_crf): 0, or it raised."""
    from fast_ctc_decode_tpu_torch.ops import beam_cuda, beam_exact_cuda, beam_fast
    from fast_ctc_decode_tpu_torch.ops import duplex_cuda, duplex_exact_cuda

    restore = garbage_scratch(torch, duplex_cuda, duplex_exact_cuda, beam_exact_cuda)
    rpbs = (4, 1, 2, 8)
    err_crf = err_exact = err_exact_crf = 0
    for i, (name, probs, lengths, thr, K, collapse, N) in enumerate(exact_cases()):
        p = torch.from_numpy(probs).to(dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        N = N or beam_exact_cuda.beam_ops.default_max_nodes(probs.shape[1], K, probs.shape[2] - 1)
        rpb = rpbs[i % 4] if probs.shape[0] <= 64 else beam_exact_cuda.READS_PER_BLOCK
        got = beam_exact_cuda.beam_search_exact_kernel_batch(
            p, ln, thr, beam_size=K, collapse_repeats=collapse, max_nodes=N, reads_per_block=rpb)
        want = beam_exact_cuda.beam_search_exact_plain(
            p, ln, thr, beam_size=K, collapse_repeats=collapse, max_nodes=N)
        d = max(max_abs_diff(got[f], want[f]) for f in FIELDS)
        torch.cuda.synchronize()
        log(f"parity exact {name} (B={probs.shape[0]}, {rpb} reads a block): max_abs_err {d}, "
            f"err codes {sorted(set(got['err'].tolist()))}")
        if d:
            raise AssertionError(f"exact kernel != plain on case {name}")
        err_exact = max(err_exact, d)
    for i, (name, probs, init, lengths, thr, K, N) in enumerate(crf_cases()):
        p = torch.from_numpy(probs).to(dev)
        ini = torch.from_numpy(init).to(dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ids_p = beam_cuda.crf_beam_ids_plain(p, ini, ln, thr, beam_size=K)
        d_ids = 0
        for r in (1, 2, 4, 8):  # the CRF beam kernel at every reads-per-block
            ids_k = beam_cuda.crf_beam_ids_kernel(p, ini, ln, thr, beam_size=K, reads_per_block=r)
            d_ids = max(d_ids, *(max_abs_diff(x, y) for x, y in zip(ids_k, ids_p)))
        got = beam_cuda.crf_beam_search_kernel_batch(p, ini, ln, thr, beam_size=K)
        want = beam_fast.crf_beam_search_fast_batch(p, ini, ln, thr, beam_size=K)
        d_crf = max(d_ids, max(max_abs_diff(got[f], want[f]) for f in FIELDS))
        if B_CRF_EXACT < probs.shape[0]:  # the exact engine's full width is B_CRF_EXACT
            p, ini, ln = p[:B_CRF_EXACT].contiguous(), ini[:B_CRF_EXACT].contiguous(), ln[:B_CRF_EXACT]
        N = N or beam_exact_cuda.beam_ops.default_max_nodes(probs.shape[1], K, probs.shape[3] - 1)
        rpb = rpbs[i % 4] if probs.shape[0] <= 64 else beam_exact_cuda.READS_PER_BLOCK
        got = beam_exact_cuda.crf_beam_search_exact_kernel_batch(
            p, ini, ln, thr, beam_size=K, max_nodes=N, reads_per_block=rpb)
        want = beam_exact_cuda.crf_beam_search_exact_plain(
            p, ini, ln, thr, beam_size=K, max_nodes=N)
        d_ex = max(max_abs_diff(got[f], want[f]) for f in FIELDS)
        torch.cuda.synchronize()
        log(f"parity crf {name} (CRF beam: 1, 2, 4, 8 reads a block; exact: B={p.shape[0]}, "
            f"{rpb} reads a block): beam max_abs_err "
            f"{d_crf}, exact {d_ex}, err codes {sorted(set(ids_k[2].tolist()))} / "
            f"{sorted(set(got['err'].tolist()))}")
        if d_crf or d_ex:
            raise AssertionError(f"CRF kernel != plain on case {name}")
        err_crf, err_exact_crf = max(err_crf, d_crf), max(err_exact_crf, d_ex)
    restore()
    return err_crf, err_exact, err_exact_crf


def single_read_times(torch, smi, probs, crf_probs, crf_init):
    """Phase 6: one read through ``api.beam_search`` (T=1000) and
    ``api.crf_beam_search`` (T=400, S=64) on the card, default (exact)
    engine: wall ms, median of 5, CUDA-synchronised."""
    from fast_ctc_decode_tpu_torch import api

    ms = {
        f"api.beam_search one read T={probs.shape[0]}": median_ms(
            lambda: api.beam_search(probs, ALPHABET, BEAM, THR, device="cuda"), torch),
        f"api.crf_beam_search one read T={crf_probs.shape[0]} S={crf_probs.shape[1]}": median_ms(
            lambda: api.crf_beam_search(crf_probs, crf_init, ALPHABET, BEAM, THR, device="cuda"),
            torch),
    }
    for name, t in ms.items():
        log(f"time {name} (exact engine, the kernel at B=1): {t!r} ms [{smi}]")
    return ms


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    parent_dir = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent_dir = os.path.abspath(argv[1])
    elif argv:
        print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import oracle  # numpy-only reference semantics
    from fast_ctc_decode_tpu_torch import BatchBeamDecoder, decode_many
    from fast_ctc_decode_tpu_torch import BatchCrfBeamDecoder, BatchViterbiDecoder
    from fast_ctc_decode_tpu_torch import api, decode_many_crf, native
    from fast_ctc_decode_tpu_torch.ops import _build, beam_cuda, beam_fast
    from fast_ctc_decode_tpu_torch.ops import beam_exact_cuda, duplex_cuda, duplex_exact_cuda
    from fast_ctc_decode_tpu_torch.ops import viterbi as viterbi_ops
    from fast_ctc_decode_tpu_torch.ops import viterbi_cuda
    from fast_ctc_decode_tpu_torch.tools import exact_probe, kernel_probe
    from fast_ctc_decode_tpu_torch.utils import profiling

    run_t0 = time.perf_counter()
    dev = torch.device("cuda", 0)

    # ---- phase 1: card, versions, kernel build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build = _build.build()
    _build.load_library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.seconds:.2f} s{', cached' if build.seconds == 0 else ''}) -> {build.path}")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")
    duplex_launch_shapes(build.log)
    exact_launch_shapes(build.log)
    parent = parent_log = None
    if parent_dir is not None:
        t0 = time.perf_counter()
        parent = parent_package(parent_dir)
        parent_log = parent.build.build().log
        parent.build.load_library()
        log(f"parent kernels from {parent_dir}: built in {time.perf_counter() - t0:.2f} s")
    beam_regs = beam_launch_shapes(build.log, parent_log)
    beam_sass = beam_sass_steps(build.path, parent.build.build().path if parent else None)

    # ---- phase 2: kernel vs plain, bit for bit, on the card ----
    # every version of the beam kernel (1, 2 in both designs, 3) against the
    # one plain function they compute; the warp design at 1, 2, 4, 8 reads
    # a block in turn
    err_beam = {1: 0, "thread": 0, "warp": 0, 3: 0}
    err_tb = {route: 0 for route in beam_cuda.TRACEBACK_ROUTES}
    runs = ((1, None), (2, "thread"), (2, "warp"), (3, None))
    for i, (name, probs, lengths, thr, K, collapse) in enumerate(parity_cases()):
        p = torch.from_numpy(probs).to(dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ids_p, fin_p, e_p = beam_cuda.beam_ids_plain(
            p, ln, thr, beam_size=K, collapse_repeats=collapse)
        want = beam_fast.beam_search_fast_batch(
            p, ln, thr, beam_size=K, collapse_repeats=collapse)
        T, A = probs.shape[1], probs.shape[2] - 1
        rpb = (1, 2, 4, 8)[i % 4]
        msg = []
        for v, design in runs:
            ids_k, fin_k, e_k = beam_cuda.beam_ids_kernel(
                p, ln, thr, beam_size=K, collapse_repeats=collapse, version=v, design=design,
                reads_per_block=rpb)
            d_beam = max(max_abs_diff(ids_k, ids_p), max_abs_diff(fin_k, fin_p),
                         max_abs_diff(e_k, e_p))
            got = beam_cuda.beam_search_kernel_batch(
                p, ln, thr, beam_size=K, collapse_repeats=collapse, version=v, design=design)
            d_all = max(max_abs_diff(got[f], want[f]) for f in FIELDS)
            if design:  # both routes on the log of each version-2 design
                d_tb = traceback_parity(torch, fin_k, ids_k, A, f"{name} ({design} design's log)",
                                        warps=(1, 2, 4, 8)[i % 4], steps=(1, 3, 16, 32)[i % 4])
                for route, d in d_tb.items():
                    err_tb[route] = max(err_tb[route], d, d_all)
            torch.cuda.synchronize()
            key = design or v
            msg.append(f"{'v2 ' + design if design else f'v{v}'} beam {d_beam} dict {d_all}")
            if d_beam or d_all:
                raise AssertionError(f"kernel (version {v}, {design}) != plain on case {name}")
            err_beam[key] = max(err_beam[key], d_beam, d_all)
        log(f"parity {name} (warp design: {rpb} reads a block): max_abs_err {', '.join(msg)}, "
            f"err codes {sorted(set(e_p.tolist()))}")

    # ---- phase 2b: CRF beam and exact tree kernels vs plain, bit for bit ----
    err_crf, err_exact, err_exact_crf = exact_parity_phase(torch, dev)

    # ---- phase 3: the main path at B=32768, T=1000 ----
    probs = make_reads(B_MAIN, T_MAIN, len(ALPHABET), 42)
    probs_d = torch.from_numpy(probs).to(dev)
    lengths_d = torch.full((B_MAIN,), T_MAIN, dtype=torch.int32, device=dev)
    dec = BatchBeamDecoder(ALPHABET, T=T_MAIN, beam_size=BEAM,
                           beam_cut_threshold=THR, device="cuda")
    if dec.engine != "cuda":
        raise AssertionError(f"default engine on the card is {dec.engine!r}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    beam_cuda.reset_launches()
    t0 = time.perf_counter()
    res = dec.decode(probs_d, lengths_d)
    main_s = time.perf_counter() - t0
    main_design = beam_cuda.design_for(B_MAIN, BEAM, len(ALPHABET) - 1)
    launches = {k: beam_cuda.launches[k]
                for k in ("beam", "beam_warp", *beam_cuda.TRACEBACK_ROUTES.values())}
    main_route = beam_cuda.traceback_route(T_MAIN, BEAM)[0]
    tb_counter = beam_cuda.TRACEBACK_ROUTES[main_route]
    log(f"main path: {B_MAIN} reads decoded in {main_s:.3f} s (first call), "
        f"launches {launches} (version 2, {main_design} design), peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    if launches[beam_counter(main_design)] < 1 or launches[tb_counter] < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if len(res) != B_MAIN or any(r[2] != 0 for r in res):
        raise AssertionError("main path: status codes not all OK")
    out = dec.decode_arrays(probs_d, lengths_d)
    for f in FIELDS:
        want_shape = (B_MAIN, T_MAIN) if f in ("labels_rev", "times_rev") else (B_MAIN,)
        if tuple(out[f].shape) != want_shape or out[f].dtype != torch.int32:
            raise AssertionError(f"main path: {f} is {tuple(out[f].shape)} {out[f].dtype}")
    counts_main = out["count"].cpu().numpy()
    if int(counts_main.min()) < 1 or int(counts_main.max()) > T_MAIN:
        raise AssertionError("main path: counts out of range")
    for i in np.linspace(0, B_MAIN - 1, 8).astype(int):
        want, _ = oracle.beam_search(probs[i], ALPHABET, BEAM, THR)
        if res[i][0] != want:
            raise AssertionError(f"read {i}: {res[i][0]!r} != oracle {want!r}")
        if len(res[i][1]) != len(want):
            raise AssertionError(f"read {i}: path length {len(res[i][1])}")
    log(f"oracle gate: 8 sampled reads equal tests/oracle.py "
        f"(mean length {float(counts_main.mean()):.1f})")

    # ---- phase 4: decode_many resumes from a checkpoint ----
    rng = np.random.RandomState(5)
    lens = rng.randint(100, 4001, size=2000)
    reads = [make_reads(1, int(n), len(ALPHABET), 1000 + i)[0] for i, n in enumerate(lens)]
    kw = dict(beam_size=BEAM, beam_cut_threshold=THR, device="cuda",
              bucket_edges=[128, 256, 512, 1024, 2048, 4096])
    beam_cuda.reset_launches()
    t0 = time.perf_counter()
    full = decode_many(reads, ALPHABET, **kw)
    full_s = time.perf_counter() - t0
    many_launches = dict(beam_cuda.launches)
    if many_launches["beam_warp"] < 1:  # batches of at most 256 reads: the warp design
        raise AssertionError(f"decode_many: the warp design never launched: {many_launches}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "run.jsonl")
        half = decode_many(reads[:1000], ALPHABET, checkpoint_path=ckpt, **kw)
        resumed = decode_many(reads, ALPHABET, checkpoint_path=ckpt, **kw)
        before = dict(beam_cuda.launches)
        again = decode_many(reads, ALPHABET, checkpoint_path=ckpt, **kw)
        if beam_cuda.launches != before:
            raise AssertionError("a complete checkpoint decoded again")
    if half != full[:1000] or resumed != full or again != full:
        raise AssertionError("decode_many: resumed results differ from an uninterrupted run")
    if any(r[2] != 0 for r in full):
        raise AssertionError("decode_many: status codes not all OK")
    log(f"decode_many: {len(reads)} reads, lengths {lens.min()}-{lens.max()}, "
        f"{full_s:.3f} s uninterrupted (launches {many_launches}); resumed run equals it")

    # ---- phase 5: the main path's inputs through both designs, then times ----
    # version 2 in the design B=32768 routes to and forced to the other, held
    # to the plain version bit for bit; then the wide instance (beam 16, A+1 =
    # 8) the same way on its own inputs
    plain_main = beam_cuda.beam_ids_plain(probs_d, lengths_d, THR, beam_size=BEAM)
    ids_log, fin, err_main = beam_cuda.beam_ids_kernel(probs_d, lengths_d, THR, beam_size=BEAM)
    other = "warp" if main_design == "thread" else "thread"
    forced = beam_cuda.beam_ids_kernel(probs_d, lengths_d, THR, beam_size=BEAM, design=other)
    err_main_b = {
        main_design: max(max_abs_diff(x, y) for x, y in zip((ids_log, fin, err_main), plain_main)),
        other: max(max_abs_diff(x, y) for x, y in zip(forced, plain_main)),
    }
    log(f"main path inputs B={B_MAIN} T={T_MAIN}: max_abs_err against the plain version "
        f"{err_main_b} (ids_log, fin, err)")
    if any(err_main_b.values()):
        raise AssertionError(f"beam kernel != plain on the main path's inputs: {err_main_b}")
    del plain_main, forced
    g = torch.Generator(device=dev).manual_seed(46)
    wide = torch.rand((B_MAIN, T_MAIN, WIDE_A1), generator=g, device=dev)
    wide /= torch.linalg.vector_norm(wide, dim=-1, keepdim=True)
    # both designs forced, and the design the wrapper routes the instance to
    wide_routed = beam_cuda.design_for(B_MAIN, WIDE_BEAM, WIDE_A1 - 1)
    wide_fn = {d: (lambda d=d: beam_cuda.beam_ids_kernel(
        wide, lengths_d, THR, beam_size=WIDE_BEAM, design=d))
        for d in (*beam_cuda.DESIGNS, None)}
    wide_plain = beam_cuda.beam_ids_plain(wide, lengths_d, THR, beam_size=WIDE_BEAM)
    err_wide_d = {d or "routed": max(max_abs_diff(x, y) for x, y in zip(fn(), wide_plain))
                  for d, fn in wide_fn.items()}
    err_wide = max(err_wide_d.values())
    log(f"wide instance beam {WIDE_BEAM} A+1={WIDE_A1} B={B_MAIN} T={T_MAIN}: max_abs_err "
        f"{err_wide_d} against the plain version")
    if err_wide:
        raise AssertionError(f"beam kernel <16, 7> != plain at B={B_MAIN}: {err_wide_d}")
    wide_v = {v: (lambda v=v: beam_cuda.beam_ids_kernel(wide, lengths_d, THR,
                                                        beam_size=WIDE_BEAM, version=v))
              for v in (1, 3)}
    err_wide_v = {v: max(max_abs_diff(x, y) for x, y in zip(fn(), wide_plain))
                  for v, fn in wide_v.items()}
    for v, e in err_wide_v.items():
        log(f"wide instance of version {v}, beam {WIDE_BEAM} A+1={WIDE_A1} B={B_MAIN} "
            f"T={T_MAIN}: max_abs_err {e} against the plain version")
        if e:
            raise AssertionError(f"beam kernel v{v} <16, 7> != plain at B={B_MAIN}: {e}")
    del wide_plain
    # row 2 on the main path's own log, both routes, then the edge cases
    d_tb = traceback_parity(torch, fin, ids_log, len(ALPHABET) - 1, f"main log B={B_MAIN}")
    for route, d in d_tb.items():
        err_tb[route] = max(err_tb[route], d)
    err_tb_edge = traceback_edge_phase(torch, dev, fin, ids_log)
    fin_s, ids_s = fin[:B_SMALL_TB].contiguous(), ids_log[:, :, :B_SMALL_TB].contiguous()
    tb_ms = {
        (route, b): median_event_ms(lambda route=route, f=f, g=g: beam_cuda.traceback_kernel(
            f, g, T=T_MAIN, K=BEAM, A=4, route=route), torch, calls=TB_CALLS)
        for b, f, g in ((B_MAIN, fin, ids_log), (B_SMALL_TB, fin_s, ids_s))
        for route in beam_cuda.TRACEBACK_ROUTES
    }
    for (route, b), t in tb_ms.items():
        log(f"time traceback {route} B={b} T={T_MAIN}: {t!r} ms ({TB_CALLS} calls back to "
            f"back) [{smi}]")
    ms = {
        "beam kernel": median_event_ms(
            lambda: beam_cuda.beam_ids_kernel(probs_d, lengths_d, THR, beam_size=BEAM), torch),
        "beam kernel, warp design": median_event_ms(
            lambda: beam_cuda.beam_ids_kernel(probs_d, lengths_d, THR, beam_size=BEAM,
                                              design="warp"), torch),
        "traceback kernel": tb_ms[(main_route, B_MAIN)],
        "decode_arrays": median_ms(lambda: dec.decode_arrays(probs_d, lengths_d), torch),
        "decode (with detok)": median_ms(lambda: dec.decode(probs_d, lengths_d), torch),
        "plain beam": median_event_ms(  # seconds a call: a median of 3
            lambda: beam_cuda.beam_ids_plain(probs_d, lengths_d, THR, beam_size=BEAM), torch,
            repeats=3),
        "plain traceback": median_event_ms(
            lambda: beam_cuda.traceback_plain(fin, ids_log, T=T_MAIN, K=BEAM, A=4), torch),
        "traceback kernel, one call": median_event_ms(
            lambda: beam_cuda.traceback_kernel(fin, ids_log, T=T_MAIN, K=BEAM, A=4), torch),
        "plain engine": median_ms(
            lambda: beam_fast.beam_search_fast_batch(probs_d, lengths_d, THR, beam_size=BEAM),
            torch, repeats=3),
        **{f"beam kernel <16, 7> (beam {WIDE_BEAM}, A+1={WIDE_A1}), "
           f"{f'{d} design' if d else f'routed ({wide_routed} design)'}": median_event_ms(
               fn, torch) for d, fn in wide_fn.items()},
        **{f"beam kernel v{v} <16, 7> (beam {WIDE_BEAM}, A+1={WIDE_A1})": median_event_ms(
            fn, torch) for v, fn in wide_v.items()},
    }
    for name, t in ms.items():
        log(f"time {name} B={B_MAIN} T={T_MAIN}: {t!r} ms "
            f"({B_MAIN / (t / 1e3):.1f} reads/s) [{smi}]")
    wide_ms = {d: ms[f"beam kernel <16, 7> (beam {WIDE_BEAM}, A+1={WIDE_A1}), {d} design"]
               for d in beam_cuda.DESIGNS}
    wide_ms["routed"] = ms[f"beam kernel <16, 7> (beam {WIDE_BEAM}, A+1={WIDE_A1}), "
                           f"routed ({wide_routed} design)"]
    wide_best = min(beam_cuda.DESIGNS, key=wide_ms.get)
    log(f"wide instance beam {WIDE_BEAM} A+1={WIDE_A1} B={B_MAIN} T={T_MAIN}: the wrapper "
        f"routes it to the {wide_routed} design ({wide_ms['routed']!r} ms; forced: "
        f"{wide_routed} {wide_ms[wide_routed]!r} ms, "
        f"{'warp' if wide_routed == 'thread' else 'thread'} "
        f"{wide_ms['warp' if wide_routed == 'thread' else 'thread']!r} ms); the {wide_best} "
        f"design is faster; routed / faster = {wide_ms['routed'] / wide_ms[wide_best]:.4f} "
        f"[{smi}]")
    parent_ms = {}
    if parent is not None:
        parent_ms = parent_turns(torch, smi, parent, probs_d, lengths_d, wide,
                                 ((fin, ids_log), (fin_s, ids_s)))
    del wide
    probe = kernel_probe.run(B_MAIN, T_MAIN, device=dev, iters=3)
    for line, _ in probe:
        log(line)
    design_ms, wide_design_ms, tb_probe, tb_block = {}, {}, {}, {}
    for _, r in probe:
        if r["what"] == "design" and (r["beam"], r["A1"]) == (BEAM, len(ALPHABET)):
            design_ms.setdefault(str(r["B"]), {})[r["design"]] = r["ms"]
        elif r["what"] == "design":
            wide_design_ms.setdefault(f"beam {r['beam']} A+1={r['A1']}", {}).setdefault(
                str(r["B"]), {})[r["design"]] = r["ms"]
        elif r["what"] == "traceback":
            tb_probe.setdefault(str(r["B"]), {})[r["route"]] = r["ms"]
        elif r["what"] == "traceback_block":
            tb_block[f"B={r['B']} {r['route']}, {r['warps']} warps, {r['steps']} steps"] = r["ms"]
    stages = profiling.reset_metrics().stages
    dec.decode(probs_d, lengths_d)
    log(f"decode stages (one call, s): {stages}; "
        f"native detok {'loaded' if native.get_lib() is not None else 'absent (Python path)'}")

    del probs_d, lengths_d, ids_log, fin, out, fin_s, ids_s
    torch.cuda.empty_cache()

    def reset_counts():
        for m in (beam_cuda, beam_exact_cuda, duplex_cuda, duplex_exact_cuda):
            m.reset_launches()

    def counts():
        return {**beam_cuda.launches, **beam_exact_cuda.launches, **duplex_cuda.launches,
                **duplex_exact_cuda.launches}

    def oracle_gate(name, res, oracle_fn, with_path):
        for i in np.linspace(0, len(res) - 1, 8).astype(int):
            want_seq, want_path = oracle_fn(i)
            if res[i][0] != want_seq:
                raise AssertionError(f"{name} read {i}: {res[i][0]!r} != oracle {want_seq!r}")
            if with_path and res[i][1] != want_path:
                raise AssertionError(f"{name} read {i}: path differs from the oracle")
            if len(res[i][1]) != len(want_seq):
                raise AssertionError(f"{name} read {i}: path length {len(res[i][1])}")
        log(f"oracle gate {name}: 8 sampled reads equal tests/oracle.py "
            f"({'sequence and path' if with_path else 'sequence'})")

    def drive(name, dec, args, kernels):
        """One decode of a full-width path between counter reads."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = dec.decode(*args)
        wall = time.perf_counter() - t0
        got = counts()
        log(f"{name}: {len(res)} reads decoded in {wall:.3f} s (first call), launches "
            f"{ {k: got[k] for k in kernels} }, peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
        if min(got[k] for k in kernels) < 1:
            raise AssertionError(f"{name}: a kernel of the path never launched: {got}")
        if any(r[2] != 0 for r in res):
            raise AssertionError(f"{name}: status codes not all OK")
        return res, {k: got[k] for k in kernels}

    # ---- phase 6: the single-read API and CRF paths at full width ----
    path_launches = {}
    ex_probs = make_reads(B_EXACT, T_MAIN, len(ALPHABET), 43)
    ex_probs_d = torch.from_numpy(ex_probs).to(dev)
    ex_len_d = torch.full((B_EXACT,), T_MAIN, dtype=torch.int32, device=dev)
    ex_dec = BatchBeamDecoder(ALPHABET, T=T_MAIN, beam_size=BEAM, beam_cut_threshold=THR,
                              engine="exact", device="cuda")
    ex_res, got = drive("exact 1D path", ex_dec, (ex_probs_d, ex_len_d), ["exact"])
    path_launches.update(got)
    oracle_gate("exact 1D", ex_res,
                lambda i: oracle.beam_search(ex_probs[i], ALPHABET, BEAM, THR), True)

    crf_probs, crf_init = make_crf_reads(B_CRF, T_CRF, S_CRF, len(ALPHABET), 44)
    crf_probs_d = torch.from_numpy(crf_probs).to(dev)
    crf_init_d = torch.from_numpy(crf_init).to(dev)
    crf_len_d = torch.full((B_CRF,), T_CRF, dtype=torch.int32, device=dev)
    crf_dec = BatchCrfBeamDecoder(ALPHABET, T=T_CRF, n_state=S_CRF, beam_size=BEAM,
                                  beam_cut_threshold=THR, device="cuda")
    if crf_dec.engine != "cuda":
        raise AssertionError(f"default CRF engine on the card is {crf_dec.engine!r}")
    crf_res, got = drive("CRF cuda path", crf_dec, (crf_probs_d, crf_init_d, crf_len_d),
                         ["crf_beam", "traceback"])
    path_launches.update(got)
    crf_oracle = lambda i: oracle.crf_beam_search(crf_probs[i], crf_init[i], ALPHABET, BEAM, THR)
    oracle_gate("CRF cuda", crf_res, crf_oracle, False)
    crf_raw = beam_cuda.crf_beam_search_kernel_batch(crf_probs_d, crf_init_d, crf_len_d, THR,
                                                     beam_size=BEAM, raw=True)
    crf_fin, crf_log = crf_raw["fin"], crf_raw["ids_log"]
    d_tb = traceback_parity(torch, crf_fin, crf_log, len(ALPHABET) - 1,
                            f"CRF path log B={B_CRF} T={T_CRF} S={S_CRF}")
    for route, d in d_tb.items():
        err_tb[route] = max(err_tb[route], d)
    tb_crf_ms = {route: median_event_ms(lambda route=route: beam_cuda.traceback_kernel(
        crf_fin, crf_log, T=T_CRF, K=BEAM, A=len(ALPHABET) - 1, route=route), torch,
        calls=TB_CALLS) for route in beam_cuda.TRACEBACK_ROUTES}
    log(f"time traceback on the CRF path's log B={B_CRF} T={T_CRF}: {tb_crf_ms} ms [{smi}]")
    del crf_raw, crf_fin, crf_log

    xc = slice(0, B_CRF_EXACT)
    xc_args = (crf_probs_d[xc].contiguous(), crf_init_d[xc].contiguous(), crf_len_d[xc])
    xc_dec = BatchCrfBeamDecoder(ALPHABET, T=T_CRF, n_state=S_CRF, beam_size=BEAM,
                                 beam_cut_threshold=THR, engine="exact", device="cuda")
    xc_res, got = drive("exact CRF path", xc_dec, xc_args, ["exact_crf"])
    path_launches.update(got)
    oracle_gate("exact CRF", xc_res, crf_oracle, True)
    if any(a[0] != b[0] for a, b in zip(xc_res, crf_res[:B_CRF_EXACT])):
        raise AssertionError("CRF engines cuda and exact give different sequences")

    vit_probs = make_reads(B_VITERBI, T_MAIN, len(ALPHABET), 45)
    vit_probs_d = torch.from_numpy(vit_probs).to(dev)
    vit_len = np.random.RandomState(46).randint(0, T_MAIN + 1, size=B_VITERBI).astype(np.int32)
    vit_len_d = torch.from_numpy(vit_len).to(dev)
    vit_dec = BatchViterbiDecoder(ALPHABET, T=T_MAIN, device="cuda")
    torch.cuda.synchronize()
    viterbi_cuda.reset_launches()
    vit_gpu = {k: v.cpu() for k, v in vit_dec.decode_arrays(vit_probs_d, vit_len_d).items()}
    path_launches["viterbi_runs"] = viterbi_cuda.launches["viterbi_runs"]
    if path_launches["viterbi_runs"] < 1:
        raise AssertionError("viterbi path: the run-means kernel never launched")
    vit_cpu = BatchViterbiDecoder(ALPHABET, T=T_MAIN, device="cpu").decode_arrays(
        torch.from_numpy(vit_probs), torch.from_numpy(vit_len))
    for f in ("tokens", "path", "n", "qints"):  # tolerance 0, phred ints included
        if not torch.equal(vit_gpu[f], vit_cpu[f]):
            raise AssertionError(f"viterbi: {f} on the card differs from the CPU run")
    vit_res = vit_dec.decode(vit_probs_d, vit_len_d, qstring=True)
    want0 = api.viterbi_search(vit_probs[0, : vit_len[0]], ALPHABET, qstring=True) \
        if vit_len[0] else ("", [])
    if vit_res[0][1] != want0[1] or vit_res[0][0][: len(want0[1])] != want0[0][: len(want0[1])]:
        raise AssertionError("viterbi: read 0 differs from the single-read API")
    log(f"viterbi path: {B_VITERBI} reads, launches {{'viterbi_runs': "
        f"{path_launches['viterbi_runs']}}}; tokens, path, n and phred ints equal to the CPU "
        f"run (tolerance 0)")

    # the single-read API on the card equals the batch results; engine="fast"
    # runs the hash beam at B=1: the warp design
    beam_cuda.reset_launches()
    for i in (0, 5):
        got = api.beam_search(ex_probs[i], ALPHABET, BEAM, THR, engine="fast", device="cuda")
        if got[0] != ex_res[i][0]:
            raise AssertionError(f"api.beam_search(fast) read {i} differs from the exact batch")
    if beam_cuda.launches["beam_warp"] < 2:
        raise AssertionError(f"api.beam_search(fast): the warp design never launched: "
                             f"{beam_cuda.launches}")
    for i in (0, 5):
        got = api.beam_search(ex_probs[i], ALPHABET, BEAM, THR, device="cuda")
        if got != ex_res[i][:2]:
            raise AssertionError(f"api.beam_search read {i} differs from the exact batch")
        got = api.crf_beam_search(crf_probs[i], crf_init[i], ALPHABET, BEAM, THR, device="cuda")
        if got != xc_res[i][:2]:
            raise AssertionError(f"api.crf_beam_search read {i} differs from the exact batch")
        got = api.crf_beam_search(crf_probs[i], crf_init[i], ALPHABET, BEAM, THR,
                                  engine="fast", device="cuda")
        if got != crf_res[i][:2]:
            raise AssertionError(f"api.crf_beam_search(fast) read {i} differs from the batch")
    log("single-read api.beam_search (exact; fast: the warp design at B=1) / "
        "api.crf_beam_search (exact, fast) on the card equal the batch results")
    single_ms = single_read_times(torch, smi, ex_probs[0], crf_probs[0], crf_init[0])
    for line, _ in exact_probe.run(B_EXACT, T_MAIN, device=dev):
        log(line)

    crf_lens = np.random.RandomState(47).randint(50, T_CRF + 1, size=300)
    crf_lens[0] = T_CRF  # the interrupted run sees the same auto bucket edges
    crf_reads = [
        tuple(x[0] for x in make_crf_reads(1, int(n), S_CRF, len(ALPHABET), 2000 + i))
        for i, n in enumerate(crf_lens)
    ]
    kw = dict(beam_size=BEAM, beam_cut_threshold=THR, batch_size=64, device="cuda")
    t0 = time.perf_counter()
    crf_full = decode_many_crf(crf_reads, ALPHABET, **kw)
    crf_full_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "crf.jsonl")
        half = decode_many_crf(crf_reads[:150], ALPHABET, checkpoint_path=ckpt, **kw)
        resumed = decode_many_crf(crf_reads, ALPHABET, checkpoint_path=ckpt, **kw)
        before = counts()
        again = decode_many_crf(crf_reads, ALPHABET, checkpoint_path=ckpt, **kw)
        if counts() != before:
            raise AssertionError("a complete CRF checkpoint decoded again")
    if half != crf_full[:150] or resumed != crf_full or again != crf_full:
        raise AssertionError("decode_many_crf: resumed results differ from an uninterrupted run")
    if any(r[2] != 0 for r in crf_full):
        raise AssertionError("decode_many_crf: status codes not all OK")
    log(f"decode_many_crf: {len(crf_reads)} reads, S={S_CRF}, {crf_full_s:.3f} s "
        f"uninterrupted; resumed run equals it")

    # ---- phase 7: times of the new kernels, their plain versions, decoders ----
    crf_shape = f"B={B_CRF} T={T_CRF} S={S_CRF}"
    ex_shape = f"B={B_EXACT} T={T_MAIN}"
    xc_shape = f"B={B_CRF_EXACT} T={T_CRF} S={S_CRF}"
    # the plain versions get the budget the decoders' exact engine fills in
    ex_nodes = beam_exact_cuda.beam_ops.default_max_nodes(T_MAIN, BEAM, len(ALPHABET) - 1)
    xc_nodes = beam_exact_cuda.beam_ops.default_max_nodes(T_CRF, BEAM, len(ALPHABET) - 1)
    timed = [
        ("crf beam kernel", crf_shape, lambda: beam_cuda.crf_beam_ids_kernel(
            crf_probs_d, crf_init_d, crf_len_d, THR, beam_size=BEAM)),
        ("plain crf beam", crf_shape, lambda: beam_cuda.crf_beam_ids_plain(
            crf_probs_d, crf_init_d, crf_len_d, THR, beam_size=BEAM)),
        ("exact kernel", ex_shape, lambda: beam_exact_cuda.beam_search_exact_kernel_batch(
            ex_probs_d, ex_len_d, THR, beam_size=BEAM)),
        ("plain exact", ex_shape, lambda: beam_exact_cuda.beam_search_exact_plain(
            ex_probs_d, ex_len_d, THR, beam_size=BEAM, max_nodes=ex_nodes)),
        ("exact crf kernel", xc_shape, lambda: beam_exact_cuda.crf_beam_search_exact_kernel_batch(
            *xc_args, THR, beam_size=BEAM)),
        ("plain exact crf", xc_shape, lambda: beam_exact_cuda.crf_beam_search_exact_plain(
            *xc_args, THR, beam_size=BEAM, max_nodes=xc_nodes)),
    ]
    vl, vp, v_emit, vs = viterbi_ops.frame_runs(vit_probs_d, vit_len_d)
    vpath, vn = viterbi_ops.emit_path(v_emit, vs)
    # one PyTorch call computing the same means (blank frames to a dump column;
    # atomics in no fixed order): the yardstick, not used by the port
    v_idx = torch.where(vl != 0, vs.clamp_min(0).long(), T_MAIN)
    v_zero = torch.zeros((B_VITERBI, T_MAIN + 1), dtype=torch.float32, device=dev)
    v_got = viterbi_cuda.run_means(vl, vp, vpath, vn).cpu()
    # the plain version in its own order: frame order on the CPU, atomics on the card
    v_cpu = viterbi_cuda.run_means_plain(vl.cpu(), vp.cpu(), vpath.cpu(), vn.cpu())
    v_card = viterbi_cuda.run_means_plain(vl, vp, vpath, vn).cpu()
    v_err = max_abs_diff(v_got.view(torch.int32), v_cpu.view(torch.int32))
    log(f"viterbi run-means kernel {B_VITERBI}x{T_MAIN}: max_abs_err {v_err} (f32 bits) against "
        f"the plain version on the CPU; the plain scatter-add on the card differs from it in "
        f"{int((v_card.view(torch.int32) != v_cpu.view(torch.int32)).sum())} entries")
    if v_err:
        raise AssertionError("viterbi run-means kernel != plain (CPU, frame order)")
    vit_shape = f"B={B_VITERBI} T={T_MAIN}"
    timed += [
        ("viterbi run-means kernel", vit_shape,
         lambda: viterbi_cuda.run_means(vl, vp, vpath, vn)),
        ("plain viterbi run means", vit_shape,
         lambda: viterbi_cuda.run_means_plain(vl, vp, vpath, vn)),
        ("library scatter_reduce mean", vit_shape, lambda: v_zero.clone().scatter_reduce_(
            1, v_idx, vp, "mean", include_self=False)),
    ]
    timed += [
        (f"crf beam kernel, {r} reads a block", crf_shape, lambda r=r: beam_cuda.crf_beam_ids_kernel(
            crf_probs_d, crf_init_d, crf_len_d, THR, beam_size=BEAM, reads_per_block=r))
        for r in (1, 2, 4, 8)
    ]
    new_ms = {}
    for name, shape, fn in timed:
        new_ms[name] = median_event_ms(fn, torch)
        log(f"time {name} {shape}: {new_ms[name]!r} ms [{smi}]")
    if parent is not None:  # row 5 beside the parent's kernel on the same inputs
        old, new, t = turns_ms(
            torch, lambda: parent.beam_cuda.crf_beam_ids_kernel(
                crf_probs_d, crf_init_d, crf_len_d, THR, beam_size=BEAM),
            lambda: beam_cuda.crf_beam_ids_kernel(crf_probs_d, crf_init_d, crf_len_d, THR,
                                                  beam_size=BEAM),
            lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)))
        parent_ms["row 5 crf beam"] = (old, new)
        log(f"time row 5 crf beam {crf_shape}: parent {old!r} ms, this tree {new!r} ms "
            f"(turns parent/new/new/parent: {', '.join(f'{x:.3f}' for x in t)}) [{smi}]")
    dec_ms = {
        f"exact decode_arrays B={B_EXACT} T={T_MAIN}": median_ms(
            lambda: ex_dec.decode_arrays(ex_probs_d, ex_len_d), torch),
        f"exact decode B={B_EXACT} T={T_MAIN}": median_ms(
            lambda: ex_dec.decode(ex_probs_d, ex_len_d), torch),
        f"crf cuda decode_arrays B={B_CRF} T={T_CRF} S={S_CRF}": median_ms(
            lambda: crf_dec.decode_arrays(crf_probs_d, crf_init_d, crf_len_d), torch),
        f"crf cuda decode B={B_CRF} T={T_CRF} S={S_CRF}": median_ms(
            lambda: crf_dec.decode(crf_probs_d, crf_init_d, crf_len_d), torch),
        f"crf exact decode_arrays B={B_CRF_EXACT} T={T_CRF} S={S_CRF}": median_ms(
            lambda: xc_dec.decode_arrays(*xc_args), torch),
        f"crf exact decode B={B_CRF_EXACT} T={T_CRF} S={S_CRF}": median_ms(
            lambda: xc_dec.decode(*xc_args), torch),
        f"viterbi decode_arrays B={B_VITERBI} T={T_MAIN}": median_ms(
            lambda: vit_dec.decode_arrays(vit_probs_d, vit_len_d), torch),
        f"viterbi decode B={B_VITERBI} T={T_MAIN}": median_ms(
            lambda: vit_dec.decode(vit_probs_d, vit_len_d), torch),
    }
    for name, t in dec_ms.items():
        B = int(name.split("B=")[1].split()[0])
        log(f"time {name}: {t!r} ms ({B / (t / 1e3):.1f} reads/s) [{smi}]")

    tb_dup, duplex_rows = duplex_phases(
        torch, dev, smi, types.SimpleNamespace(reset=reset_counts, read=counts))
    for route, d in tb_dup["err"].items():
        err_tb[route] = max(err_tb[route], d)

    # ---- phases 13-15: the A/B path, the ablation path, serving ----
    ab_launches, ab_ms = ab_phase(torch, dev, smi)
    abl = ablate_phase(torch, dev, smi)
    serving_phase(torch, dev, smi, oracle, counts, reset_counts)

    # ---- phase 16: the measurement tools and the demo on the card ----
    tools_launches = tools_phase(torch, dev, smi, ms)

    if "jax" in sys.modules or any(m.startswith("fast_ctc_decode_tpu.") for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    log(f"total wall time: {time.perf_counter() - run_t0:.1f} s")
    src = "fast_ctc_decode_tpu_torch/csrc/"
    A1 = len(ALPHABET)
    main_len = np.full(B_MAIN, T_MAIN)
    b_beam = beam_bound(main_len, T_MAIN, BEAM, A1)
    b_tb = bound(4 * (B_MAIN + int(counts_main.sum()) + 2 * B_MAIN * T_MAIN + B_MAIN), 0)
    # the sweep's own floor: the whole [T, K, B] log read once, not 4 B an emit
    b_sweep = bound(4 * (B_MAIN + T_MAIN * BEAM * B_MAIN + 2 * B_MAIN * T_MAIN + B_MAIN), 0)
    b_crf = beam_bound(np.full(B_CRF, T_CRF), T_CRF, BEAM, A1, rows_per_step=BEAM,
                       extra_in=4 * B_CRF * S_CRF)
    b_exact = beam_bound(np.full(B_EXACT, T_MAIN), T_MAIN, BEAM, A1,
                         out_bytes=4 * (2 * B_EXACT * T_MAIN + 2 * B_EXACT))
    # labels, pmax, path [B, T] and n [B] read once, the [B, T] means written
    # once; two adds a frame and at most one divide a frame
    b_vit = bound(4 * (4 * B_VITERBI * T_MAIN + B_VITERBI), 3 * B_VITERBI * T_MAIN)
    b_exact_crf = beam_bound(np.full(B_CRF_EXACT, T_CRF), T_CRF, BEAM, A1, rows_per_step=BEAM,
                             extra_in=4 * B_CRF_EXACT * S_CRF,
                             out_bytes=4 * (2 * B_CRF_EXACT * T_CRF + 2 * B_CRF_EXACT))

    def row(name, source, replaces, launched, err, k_ms, p_ms, bnd, **extra):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launched, "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None, **extra}

    bp = "fast_ctc_decode_tpu/ops/beam_pallas.py:"
    old_ms = lambda name: parent_ms[name][0] if name in parent_ms else None
    regs = lambda *names: {n: beam_regs.get(n) for n in names}
    kernels = [
        row("beam_ids_kernel", "beam_kernel.cu", bp + "367", launches[beam_counter(main_design)],
            max(err_beam["thread"], err_beam["warp"], *err_main_b.values(), err_wide),
            ms["beam kernel"], ms["plain beam"],
            b_beam, version=2, design=main_design, warp_source=src + "beam_warp_kernel.cu",
            thread_min_b=beam_cuda.THREAD_MIN_B,
            design_by_b={b: beam_cuda.design_for(int(b), BEAM, A1 - 1) for b in design_ms},
            design_ms=design_ms, warp_ms=ms["beam kernel, warp design"],
            small_b_launches={"beam_warp": many_launches["beam_warp"]},
            parent_ms=old_ms("row 1 beam v2"),
            wide_ms=wide_ms, wide_routed=wide_routed,
            wide_design_ms=wide_design_ms,
            wide_design_by_b={b: beam_cuda.design_for(int(b), WIDE_BEAM, WIDE_A1 - 1)
                              for b in design_ms},
            wide_parent_ms=old_ms("row 1 beam v2 <16, 7>"),
            registers=regs("beam_ids_kernel<5, 4> v2", "beam_ids_kernel<16, 7> v2",
                           "beam_warp_kernel<5, 4>"),
            sass_step=beam_sass.get("beam_ids_kernel<5, 4> v2")),
        row("traceback_kernel", "traceback_kernel.cu", bp + "967", launches[tb_counter],
            max(*err_tb.values(), err_tb_edge), ms["traceback kernel"], ms["plain traceback"],
            b_tb, design=main_route, warps=beam_cuda.TRACEBACK_WARPS,
            steps=beam_cuda.traceback_route(T_MAIN, BEAM)[1], max_abs_err_by_route=err_tb,
            edge_max_abs_err=err_tb_edge,
            design_ms={route: tb_ms[(route, B_MAIN)] for route in beam_cuda.TRACEBACK_ROUTES},
            parent_ms=old_ms("row 2 traceback"),
            small_b_ms={"B": B_SMALL_TB, "parent": old_ms(f"row 2 traceback B={B_SMALL_TB}"),
                        **{route: tb_ms[(route, B_SMALL_TB)]
                           for route in beam_cuda.TRACEBACK_ROUTES}},
            one_call_ms=ms["traceback kernel, one call"], calls_timed=TB_CALLS,
            crf_ms=tb_crf_ms, duplex_slot_ms=tb_dup["ms"],
            path_launches={"main": launches[tb_counter], "crf_beam": path_launches["traceback"],
                           "duplex_slot": tb_dup["launches"]},
            sweep_floor_ms=b_sweep[0], probe_ms=tb_probe, block_ms=tb_block),
        row("beam_ids_kernel_v1", "beam_v1_kernel.cu", bp + "93", ab_launches["beam_v1"],
            max(err_beam[1], err_wide_v[1]), ab_ms[(1, "raw")], ms["plain beam"], b_beam,
            version=1, parent_ms=old_ms("row 3 beam v1"),
            wide_ms=ms[f"beam kernel v1 <16, 7> (beam {WIDE_BEAM}, A+1={WIDE_A1})"],
            wide_parent_ms=old_ms("row 3 beam v1 <16, 7>"),
            registers=regs("beam_ids_kernel<5, 4> v1", "beam_ids_kernel<16, 7> v1"),
            sass_step=beam_sass.get("beam_ids_kernel<5, 4> v1"),
            wide_sass_step=beam_sass.get("beam_ids_kernel<16, 7> v1")),
        row("beam_ids_kernel_v3", "beam_v3_kernel.cu", bp + "679", ab_launches["beam_v3"],
            max(err_beam[3], err_wide_v[3]), ab_ms[(3, "raw")], ms["plain beam"], b_beam,
            version=3, parent_ms=old_ms("row 4 beam v3"),
            wide_ms=ms[f"beam kernel v3 <16, 7> (beam {WIDE_BEAM}, A+1={WIDE_A1})"],
            wide_parent_ms=old_ms("row 4 beam v3 <16, 7>"),
            registers=regs("beam_ids_kernel<5, 4> v3", "beam_ids_kernel<16, 7> v3"),
            sass_step=beam_sass.get("beam_ids_kernel<5, 4> v3"),
            wide_sass_step=beam_sass.get("beam_ids_kernel<16, 7> v3")),
        row("crf_beam_ids_kernel", "beam_warp_kernel.cu", bp + "1270", path_launches["crf_beam"],
            err_crf, new_ms["crf beam kernel"], new_ms["plain crf beam"], b_crf,
            reads_per_block=beam_cuda.READS_PER_BLOCK,
            reads_per_block_ms={r: new_ms[f"crf beam kernel, {r} reads a block"]
                                for r in (1, 2, 4, 8)},
            parent_ms=old_ms("row 5 crf beam"), registers=regs("beam_warp_kernel<5, 4> CRF")),
        row("exact_beam_kernel", "exact_beam_kernel.cu",
            "fast_ctc_decode_tpu/ops/beam_exact_pallas.py:65", path_launches["exact"], err_exact,
            new_ms["exact kernel"], new_ms["plain exact"], b_exact,
            reads_per_block=beam_exact_cuda.READS_PER_BLOCK,
            single_read_ms=single_ms[f"api.beam_search one read T={T_MAIN}"]),
        row("exact_beam_kernel_crf", "exact_beam_kernel.cu",
            "fast_ctc_decode_tpu/ops/beam_exact_pallas.py:65", path_launches["exact_crf"],
            err_exact_crf, new_ms["exact crf kernel"], new_ms["plain exact crf"], b_exact_crf,
            reads_per_block=beam_exact_cuda.READS_PER_BLOCK,
            single_read_ms=single_ms[f"api.crf_beam_search one read T={T_CRF} S={S_CRF}"]),
        *duplex_rows,
        row("beam_ablate_kernel", "beam_ablate_kernel.cu", "tools/kernel_ablate.py:36",
            abl["launches"], abl["max_abs_err"], abl["ms"], abl["plain_ms"], abl["bound"],
            sets_ms=abl["sets_ms"], parent_ms=old_ms("row 10 ablation"),
            registers={n: r for n, r in beam_regs.items() if " ablate " in n},
            sass_step={n: c[0] for n, c in beam_sass.items() if " ablate " in n}),
        dict(row("viterbi_run_means_kernel", "viterbi_runs_kernel.cu",
                 "none: no Pallas counterpart (XLA segment_sum, "
                 "fast_ctc_decode_tpu/ops/viterbi.py:96)", path_launches["viterbi_runs"], v_err,
                 new_ms["viterbi run-means kernel"], new_ms["plain viterbi run means"], b_vit),
             library_ms=new_ms["library scatter_reduce mean"]),
    ]
    for r in kernels:  # phase 16's launches of the row's kernel, by tool
        r["tools_launches"] = {
            tool: n for tool, got in tools_launches.items()
            if (n := sum(got.get(c, 0) for c in ROW_COUNTERS[r["name"]]))}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
