"""What the port's measurement tools share: the JAX tools' input builders,
copied so that the port imports neither ``tests/`` nor ``tools/``, and the
clocks the tools read.

- ``norm_batch`` is ``tests/benchmark.py::norm_batch``;
- ``diag_env`` is ``tests/benchmark.py::diag_env`` (the same function as
  ``tests/duplex_helpers.py::diag_env``);
- ``crf_root_gaps`` is the CRF root-band loop of ``tests/benchmark.py``
  (``--full``, the CRF duplex row) and of ``tools/bench_exact_duplex.py``
  (``--crf``): the blank run of read 2 from state 0.

On a CUDA device every time is a wall between two ``torch.cuda.synchronize()``
or a pair of CUDA events; on the CPU the tools run only as checks of
themselves, by the host clock.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch

from ..device import with_index


def norm_batch(B, T, A1, seed):
    """[B, T, A1] f32 posteriors from ``RandomState(seed)``, each row
    L2-normalised."""
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=2, keepdims=True)


def diag_env(T1, T2, w):
    """Monotone diagonal banded envelope of half-width ``w``, fixed up to
    satisfy the reference validity rules (lo monotone, lo <= last upper,
    lo < hi)."""
    env = np.zeros((T1, 2), np.int64)
    for i in range(T1):
        c = int(i * T2 / T1)
        env[i, 0] = max(0, c - w)
        env[i, 1] = min(T2, c + w + 1)
    env[:, 0] = np.maximum.accumulate(env[:, 0])
    last = 0
    for i in range(T1):
        env[i, 0] = min(env[i, 0], last)
        env[i, 1] = max(env[i, 1], env[i, 0] + 1)
        last = max(last, env[i, 1])
    return env


def crf_root_gaps(l2, Wr, S, A1):
    """[B, Wr] f32 CRF root bands of the log posteriors ``l2`` [B, T2, S, A1]:
    the blank run of read 2 from state 0, the state stepping to
    ``state * (A1 - 1) % S`` a frame."""
    B = l2.shape[0]
    rg = np.zeros((B, Wr), np.float32)
    st = np.zeros((B,), np.int64)
    cur = np.zeros((B,), np.float32)
    for i in range(Wr - 1):
        cur = cur + l2[np.arange(B), i, st, 0]
        rg[:, i + 1] = cur
        st = (st * (A1 - 1)) % S
    return rg


def pop_device(argv):
    """(``--device`` value or None, the other arguments) of a tool's argv."""
    argv = list(argv)
    if "--device" not in argv:
        return None, argv
    i = argv.index("--device")
    return argv[i + 1], argv[:i] + argv[i + 2:]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mean_s(fn, iters, device):
    """Seconds a call of ``fn``: one warm-up call, then ``iters`` calls back
    to back between two synchronisations of ``device``, averaged (the
    counterpart of the JAX tools' queued calls and one wait)."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / iters


def median_ms(fn, iters, device):
    """Median ms of ``iters`` calls of ``fn``, each between two
    synchronisations of ``device``, after one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        synchronize(device)
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def card_info(device: torch.device):
    """(name, power limit) of ``device`` as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; ("cpu", None) on the CPU,
    and torch's name with no limit where nvidia-smi does not answer."""
    if device.type != "cuda":
        return "cpu", None
    device = with_index(device)
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index}"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        name, power = (s.strip() for s in line.rsplit(",", 1))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return torch.cuda.get_device_name(device), None
    return name, power
