"""What the drivers share: the seeded pools and the closed-loop window."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..gen import posteriors


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for ``seed`` (any whole number),
    one independent stream per ``stream``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0]))
    return g


def order(n: int, seed: int) -> np.ndarray:
    """A permutation of ``range(n)`` drawn from ``seed``."""
    return np.random.default_rng([seed, 0x0D]).permutation(n)


def host_reads(lengths, params, seed, device):
    """Reads of ``lengths`` made on ``device`` from ``seed`` and brought to
    the host (numpy views into one float32 array), and the pool's
    statistics."""
    rows, offsets = posteriors.ctc_reads(lengths, params, generator(seed, device), device)
    stats = posteriors.stats(rows, lengths)
    rows = rows.cpu().numpy()
    reset_peak(device)
    return [rows[offsets[i]:offsets[i + 1]] for i in range(len(lengths))], stats


def bucket_of(T: int) -> int:
    """The power-of-two length bucket (at least 128 frames) a read of ``T``
    frames falls in, as the port's streams bucket; used to pick one warm-up
    read a bucket."""
    return max(128, 1 << (int(T) - 1).bit_length())


def reset_peak(device):
    """Start the run's memory peak after the inputs are made: the
    generator's scratch is not the program's."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def length_grid(config, n: int) -> np.ndarray:
    """The config's length distribution as ``n`` seed-free quantiles (clipped
    only where the config gives a ``min`` or ``max``)."""
    d = config["lengths"]
    return posteriors.lengths_grid(n, d["median"], d["sigma"], d.get("min"), d.get("max"))


def deal(values, calls: int, seed: int, stream: int = 0) -> np.ndarray:
    """The sorted seed-free ``values`` dealt into ``calls`` calls of equal
    size (back and forth, so each call gets one of every ``calls``
    neighbouring sizes), call after call, each call in an order drawn from
    ``seed``: every call, under every seed, holds nearly the same set of
    sizes, so the seed changes the order and the content but not the work."""
    values = np.sort(np.asarray(values))
    rng = np.random.default_rng([seed, 0xDE, stream])
    rows = values[: len(values) // calls * calls].reshape(-1, calls)
    rows[1::2] = rows[1::2, ::-1]
    parts = [rows[:, c] for c in range(calls)]
    return np.concatenate([p[rng.permutation(len(p))] for p in parts])


def kept_indices(n: int, sizes, keep: int, seed: int, call: int):
    """The positions of one call whose answers are kept for the check:
    ``keep`` drawn from the seed and the call, and the call's largest."""
    rng = np.random.default_rng([seed, 0xCA11, call])
    picks = set(rng.choice(n, size=min(keep, n), replace=False).tolist())
    picks.add(int(np.argmax(sizes)))
    return sorted(picks)


def closed_loop(seconds, call, log=None):
    """Run ``call(i)`` for i = 0, 1, ... until ``seconds`` have passed; the
    window ends with the call that completes past it.  Returns the window's
    whole time and the number of calls."""
    t0 = time.perf_counter()
    ends = [t0]
    while True:
        call(len(ends) - 1)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    if log is not None:
        log(f"{len(ends) - 1} calls, seconds a call: {np.round(np.diff(ends), 3).tolist()}")
    return ends[-1] - t0, len(ends) - 1
