"""Benchmark: batched 1D CTC prefix beam search reads/s on one CUDA card.

The PyTorch port's counterpart of ``bench.py``, on its workload: B=32768
reads (``BENCH_BATCH``) of T=1000 frames (``BENCH_T``) over "NACGT" (A+1 =
5), rows from ``RandomState(42)`` L2-normalised, beam 5, cut 0.1, collapse
on.  ``BENCH_ENGINE`` picks the engine: ``cuda`` (the default, the
counterpart of ``pallas``: the beam kernel then the traceback kernel,
``ops/beam_cuda.beam_search_kernel_batch``) or ``fast`` (the plain PyTorch
engine ``ops/beam_fast.beam_search_fast_batch``).  It times the device
result dict on inputs already on the card, as ``bench.py`` does.

Gate, ``bench.py``'s: every status is OK, and ``BENCH_PARITY_READS`` (8)
reads sampled across the batch equal ``tests/oracle.py``.  A mismatch fails
the run; nothing skips the check.

Timing: one warm-up, then the median of ``BENCH_ITERS`` (5) calls, each
between two ``torch.cuda.synchronize()``.  ``bench.py`` queues its calls and
waits once because a wait per call crossed a remote link to its chip; a
local card needs no such workaround.

Prints ONE JSON line: ``metric``, ``value`` (reads/s), ``unit`` and
``vs_baseline``, which is null (no baseline has been measured on a card);
then, to identify the run, ``device`` and ``power_limit`` (as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them),
``engine``, ``B``, ``T``, and two more times: ``kernels_ms`` (beam kernel +
traceback kernel, CUDA events; null for ``fast``, which has no kernel) and
``decode_ms`` (``BatchBeamDecoder.decode``, strings included, median of 3).

Runs on the card; ``BENCH_DEVICE=cpu`` runs it on the CPU as a check of the
script (host clock, not a measurement).  Without a card and without
``BENCH_DEVICE`` it raises.

Run: python bench_torch.py
"""

import json
import os
import sys

import numpy as np
import torch

from fast_ctc_decode_tpu_torch import BatchBeamDecoder
from fast_ctc_decode_tpu_torch.device import resolve_device
from fast_ctc_decode_tpu_torch.ops import beam_cuda, beam_fast
from fast_ctc_decode_tpu_torch.tools.kernel_ablate import event_ms
from fast_ctc_decode_tpu_torch.tools.workloads import card_info, median_ms

ALPHABET = "NACGT"
A1 = 5
BEAM = 5
THRESHOLD = np.float32(0.1)
ENGINES = ("cuda", "fast")
DECODE_ITERS = 3
TB_CALLS = 10  # the traceback, under a millisecond, is timed over ten calls back to back
TESTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def make_inputs(B, T, seed=42):
    """``bench.py``'s batch: [B, T, 5] f32 rows L2-normalised, [B] i32 lengths T."""
    rng = np.random.RandomState(seed)
    probs = rng.rand(B, T, A1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    return probs, np.full((B,), T, np.int32)


def _device_for(engine, device):
    if engine not in ENGINES:
        raise ValueError(f"BENCH_ENGINE must be one of {ENGINES}, got {engine!r}")
    dev = resolve_device(device)
    if engine == "cuda" and dev.type != "cuda":
        raise ValueError(f"engine 'cuda' needs a CUDA device, got {dev}")
    return dev


def _decode(engine, probs_d, lengths_d):
    fn = (beam_cuda.beam_search_kernel_batch if engine == "cuda"
          else beam_fast.beam_search_fast_batch)
    return fn(probs_d, lengths_d, THRESHOLD, beam_size=BEAM, collapse_repeats=True)


def _to(device, probs, lengths):
    return torch.from_numpy(probs).to(device), torch.from_numpy(lengths).to(device)


def run(engine, device, probs, lengths):
    """One decode of the batch by ``engine`` on ``device``: the result dict
    (labels_rev, times_rev, count, err) copied to the host at once."""
    dev = _device_for(engine, device)
    out = _decode(engine, *_to(dev, probs, lengths))
    return {k: v.cpu().numpy() for k, v in out.items()}


def gate(probs, out, n_check=8):
    """``bench.py``'s gate on a host result dict: every status OK, and
    ``n_check`` reads sampled across the batch equal ``tests/oracle.py``.
    Raises AssertionError on a failure."""
    bad = np.flatnonzero(out["err"] != 0)
    if bad.size:
        raise AssertionError(f"decode errors in bench: reads {bad[:8].tolist()}")
    if TESTS_DIR not in sys.path:
        sys.path.insert(0, TESTS_DIR)
    import oracle  # numpy-only reference semantics

    B = probs.shape[0]
    for i in np.linspace(0, B - 1, n_check).astype(int):
        n = int(out["count"][i])
        labels_rev = out["labels_rev"][i][:n]
        seq = "".join(ALPHABET[int(lab) + 1] for lab in labels_rev[::-1])
        want, _ = oracle.beam_search(probs[i], ALPHABET, BEAM, 0.1)
        if seq != want:
            raise AssertionError(f"read {i}: {seq!r} != oracle {want!r}")


def measure(engine, device, probs, lengths, iters=5):
    """Times of the batch on ``device``: ``call_ms`` (the engine's call,
    median of ``iters``), ``kernels_ms`` (CUDA events: the beam kernel, plus
    the traceback kernel per call of ``TB_CALLS``; None for ``fast``) and
    ``decode_ms`` (``BatchBeamDecoder.decode``, median of 3)."""
    dev = _device_for(engine, device)
    probs_d, lengths_d = _to(dev, probs, lengths)
    T = probs.shape[1]
    call_ms = median_ms(lambda: _decode(engine, probs_d, lengths_d), iters, dev)
    kernels_ms = None
    if engine == "cuda":
        raw = beam_cuda.beam_search_kernel_batch(
            probs_d, lengths_d, THRESHOLD, beam_size=BEAM, raw=True)
        beam_ms = event_ms(lambda: beam_cuda.beam_ids_kernel(
            probs_d, lengths_d, THRESHOLD, beam_size=BEAM), iters)
        tb_ms = event_ms(lambda: [beam_cuda.traceback_kernel(
            raw["fin"], raw["ids_log"], T=T, K=BEAM, A=A1 - 1) for _ in range(TB_CALLS)],
            iters) / TB_CALLS
        kernels_ms = beam_ms + tb_ms
        del raw
    dec = BatchBeamDecoder(ALPHABET, T=T, beam_size=BEAM, beam_cut_threshold=0.1,
                           engine=engine, device=dev)
    decode_ms = median_ms(lambda: dec.decode(probs_d, lengths_d), DECODE_ITERS, dev)
    return {"call_ms": call_ms, "kernels_ms": kernels_ms, "decode_ms": decode_ms}


def main(env=None):
    """Run the benchmark with the ``BENCH_*`` settings of ``env`` (default:
    the process environment); prints and returns the JSON row."""
    env = os.environ if env is None else env
    engine = env.get("BENCH_ENGINE", "cuda")
    B = int(env.get("BENCH_BATCH", "32768"))
    T = int(env.get("BENCH_T", "1000"))
    iters = int(env.get("BENCH_ITERS", "5"))
    n_check = int(env.get("BENCH_PARITY_READS", "8"))
    dev = _device_for(engine, env.get("BENCH_DEVICE") or None)

    probs, lengths = make_inputs(B, T, 42)
    out = run(engine, dev, probs, lengths)  # builds the kernels, warms the card
    gate(probs, out, n_check)
    del out
    times = measure(engine, dev, probs, lengths, iters)
    name, power = card_info(dev)
    row = {
        "metric": "beam_search_reads_per_sec_per_chip",
        "value": B / (times["call_ms"] / 1e3),
        "unit": "reads/s",
        "vs_baseline": None,
        "device": name,
        "power_limit": power,
        "engine": engine,
        "B": B,
        "T": T,
        "kernels_ms": times["kernels_ms"],
        "decode_ms": times["decode_ms"],
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
