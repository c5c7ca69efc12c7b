#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fast_ctc_decode_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):
  1. builds the CUDA kernels from ``fast_ctc_decode_tpu_torch/csrc`` with nvcc
     (sm_90a) and prints the card, the versions, the build time and ptxas's
     register/spill lines;
  2. holds each kernel against its plain PyTorch version on the card, bit
     for bit, on the shapes of the CPU tests and at B=1024, T=1000;
  3. drives the main path, ``BatchBeamDecoder("NACGT", T=1000, beam_size=5,
     beam_cut_threshold=0.1, device="cuda")``, on B=32768 reads made from a
     seed, with every status OK, 8 sampled reads equal to tests/oracle.py,
     and both kernels' launch counters grown;
  4. resumes ``decode_many`` from a checkpoint over ~2,000 mixed-length
     reads and checks the result against an uninterrupted run;
  5. times both kernels, ``decode_arrays``, ``decode`` and the plain engine
     at B=32768, T=1000 (CUDA-synchronised medians of 5 runs).
The line before the last is a JSON object describing the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside
the repository, it exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ALPHABET = "NACGT"
B_MAIN, T_MAIN, BEAM, THR = 32768, 1000, 5, 0.1
REPEATS = 5
FIELDS = ("labels_rev", "times_rev", "count", "err")


def log(msg):
    print(msg, flush=True)


def make_reads(B, T, A1, seed):
    """Random L2-normalised posteriors, made as bench.py makes them."""
    rng = np.random.RandomState(seed)
    probs = rng.rand(B, T, A1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    return probs


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


def median_event_ms(fn, torch, repeats=REPEATS):
    """Median device time of ``fn`` in ms between two CUDA events."""
    fn()  # warm-up
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def parity_cases():
    """(name, probs, lengths, thr, beam_size, collapse): the CPU tests' shapes."""
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
    rng = np.random.RandomState(11)
    cases.append(
        ("B1024_T1000", make_reads(1024, 1000, 5, 7),
         list(rng.randint(0, 1001, size=1024)), THR, BEAM, True)
    )
    return cases


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import oracle  # numpy-only reference semantics
    from fast_ctc_decode_tpu_torch import BatchBeamDecoder, decode_many
    from fast_ctc_decode_tpu_torch import native
    from fast_ctc_decode_tpu_torch.ops import _build, beam_cuda, beam_fast
    from fast_ctc_decode_tpu_torch.utils import profiling

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

    # ---- phase 2: kernel vs plain, bit for bit, on the card ----
    err_beam = err_tb = 0
    for name, probs, lengths, thr, K, collapse in parity_cases():
        p = torch.from_numpy(probs).to(dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ids_k, fin_k, e_k = beam_cuda.beam_ids_kernel(
            p, ln, thr, beam_size=K, collapse_repeats=collapse)
        ids_p, fin_p, e_p = beam_cuda.beam_ids_plain(
            p, ln, thr, beam_size=K, collapse_repeats=collapse)
        d_beam = max(max_abs_diff(ids_k, ids_p), max_abs_diff(fin_k, fin_p),
                     max_abs_diff(e_k, e_p))
        T, A = probs.shape[1], probs.shape[2] - 1
        tb_k = beam_cuda.traceback_kernel(fin_k, ids_k, T=T, K=K, A=A)
        tb_p = beam_cuda.traceback_plain(fin_k, ids_k, T=T, K=K, A=A)
        d_tb = max(max_abs_diff(x, y) for x, y in zip(tb_k, tb_p))
        got = beam_cuda.beam_search_kernel_batch(
            p, ln, thr, beam_size=K, collapse_repeats=collapse)
        want = beam_fast.beam_search_fast_batch(
            p, ln, thr, beam_size=K, collapse_repeats=collapse)
        d_all = max(max_abs_diff(got[f], want[f]) for f in FIELDS)
        torch.cuda.synchronize()
        log(f"parity {name}: beam max_abs_err {d_beam}, traceback {d_tb}, "
            f"dict {d_all}, err codes {sorted(set(e_k.tolist()))}")
        if d_beam or d_tb or d_all:
            raise AssertionError(f"kernel != plain on case {name}")
        err_beam, err_tb = max(err_beam, d_beam, d_all), max(err_tb, d_tb, d_all)

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
    launches = dict(beam_cuda.launches)
    log(f"main path: {B_MAIN} reads decoded in {main_s:.3f} s (first call), "
        f"launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if len(res) != B_MAIN or any(r[2] != 0 for r in res):
        raise AssertionError("main path: status codes not all OK")
    out = dec.decode_arrays(probs_d, lengths_d)
    for f in FIELDS:
        want_shape = (B_MAIN, T_MAIN) if f in ("labels_rev", "times_rev") else (B_MAIN,)
        if tuple(out[f].shape) != want_shape or out[f].dtype != torch.int32:
            raise AssertionError(f"main path: {f} is {tuple(out[f].shape)} {out[f].dtype}")
    counts = out["count"]
    if int(counts.min()) < 1 or int(counts.max()) > T_MAIN:
        raise AssertionError("main path: counts out of range")
    for i in np.linspace(0, B_MAIN - 1, 8).astype(int):
        want, _ = oracle.beam_search(probs[i], ALPHABET, BEAM, THR)
        if res[i][0] != want:
            raise AssertionError(f"read {i}: {res[i][0]!r} != oracle {want!r}")
        if len(res[i][1]) != len(want):
            raise AssertionError(f"read {i}: path length {len(res[i][1])}")
    log(f"oracle gate: 8 sampled reads equal tests/oracle.py "
        f"(mean length {float(counts.float().mean()):.1f})")

    # ---- phase 4: decode_many resumes from a checkpoint ----
    rng = np.random.RandomState(5)
    lens = rng.randint(100, 4001, size=2000)
    reads = [make_reads(1, int(n), len(ALPHABET), 1000 + i)[0] for i, n in enumerate(lens)]
    kw = dict(beam_size=BEAM, beam_cut_threshold=THR, device="cuda",
              bucket_edges=[128, 256, 512, 1024, 2048, 4096])
    t0 = time.perf_counter()
    full = decode_many(reads, ALPHABET, **kw)
    full_s = time.perf_counter() - t0
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
        f"{full_s:.3f} s uninterrupted; resumed run equals it")

    # ---- phase 5: times at B=32768, T=1000 ----
    ids_log, fin, _ = beam_cuda.beam_ids_kernel(probs_d, lengths_d, THR, beam_size=BEAM)
    ms = {
        "beam kernel": median_event_ms(
            lambda: beam_cuda.beam_ids_kernel(probs_d, lengths_d, THR, beam_size=BEAM), torch),
        "traceback kernel": median_event_ms(
            lambda: beam_cuda.traceback_kernel(fin, ids_log, T=T_MAIN, K=BEAM, A=4), torch),
        "decode_arrays": median_ms(lambda: dec.decode_arrays(probs_d, lengths_d), torch),
        "decode (with detok)": median_ms(lambda: dec.decode(probs_d, lengths_d), torch),
        "plain beam": median_event_ms(
            lambda: beam_cuda.beam_ids_plain(probs_d, lengths_d, THR, beam_size=BEAM), torch),
        "plain traceback": median_event_ms(
            lambda: beam_cuda.traceback_plain(fin, ids_log, T=T_MAIN, K=BEAM, A=4), torch),
        "plain engine": median_ms(
            lambda: beam_fast.beam_search_fast_batch(probs_d, lengths_d, THR, beam_size=BEAM),
            torch),
    }
    for name, t in ms.items():
        log(f"time {name} B={B_MAIN} T={T_MAIN}: {t!r} ms "
            f"({B_MAIN / (t / 1e3):.1f} reads/s) [{smi}]")
    stages = profiling.reset_metrics().stages
    dec.decode(probs_d, lengths_d)
    log(f"decode stages (one call, s): {stages}; "
        f"native detok {'loaded' if native.get_lib() is not None else 'absent (Python path)'}")

    if "jax" in sys.modules or any(m.startswith("fast_ctc_decode_tpu.") for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    src = "fast_ctc_decode_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "beam_ids_kernel", "route": "cuda", "source": src + "beam_kernel.cu",
         "replaces": "fast_ctc_decode_tpu/ops/beam_pallas.py:367",
         "launches": launches["beam"], "max_abs_err": err_beam,
         "ms": ms["beam kernel"], "plain_ms": ms["plain beam"]},
        {"name": "traceback_kernel", "route": "cuda", "source": src + "traceback_kernel.cu",
         "replaces": "fast_ctc_decode_tpu/ops/beam_pallas.py:967",
         "launches": launches["traceback"], "max_abs_err": err_tb,
         "ms": ms["traceback kernel"], "plain_ms": ms["plain traceback"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
