"""Data-parallel scaling harness of the port: reads/s and efficiency over
processes, and the cost of the counters' all-reduce; the counterpart of
``tools/scaling_bench.py``.

The decode workload has no cross-read state (the only collective is the
all-reduce of the decode counters), so data-parallel scaling is linear by
construction; this harness measures it instead of asserting it.  One process
per card replaces the JAX package's device mesh (``parallel/mesh.py``).

Modes:

  python -m fast_ctc_decode_tpu_torch.tools.scaling_bench hosts [--nproc 2]
      N worker processes, one card each (``LOCAL_RANK``): each joins the
      process group with ``mesh.distributed_init`` (NCCL on the card, Gloo
      with ``--device cpu``), decodes its ``mesh.shard_bounds`` slice of the
      reads with ``pipeline.decode_and_count`` (a warm-up, then 3 reps
      between two synchronisations), checks the all-reduced totals
      ``[B, 0]`` and that neither jax nor the JAX package was imported, and
      reports its wall; the tool reports the slowest worker's wall and the
      efficiency against nproc=1.  A run that needs more cards than the
      machine has is not made: its row says so (``"unmeasured"``).  Two
      ranks never share a card, and none moves to the CPU.

  python -m fast_ctc_decode_tpu_torch.tools.scaling_bench overhead [--engine fast|cuda]
      The same batch decoded (a) by the engine alone
      (``beam_fast.beam_search_fast_batch`` or
      ``beam_cuda.beam_search_kernel_batch``) and (b) through
      ``decode_and_count`` in a process group of one (NCCL on the card, Gloo
      on the CPU): the ratio is the fraction of throughput the collective
      machinery keeps.  The two output dicts must be equal.

The JAX tool's ``devices`` mode (one process over a mesh of n devices) has
no counterpart: a process of the port drives one card.

Each mode prints one JSON line per configuration, with the JAX tool's keys
(``mode``, ``n``, ``reads``, ``reads_per_s``, ``efficiency``; overhead:
``reads_per_s_plain``, ``reads_per_s_sharded_psum``, ``efficiency``,
``backend``) and ``device`` (the card's name) and ``launches`` (kernel
launches of the run, summed over workers).  Runs on the card; ``--device
cpu`` runs on the CPU as a check of the tool (host clock, not a
measurement).  Without a card and without ``--device`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import beam_cuda, beam_fast
from ..parallel import mesh
from ..parallel.pipeline import decode_and_count
from .workloads import card_info, mean_s, synchronize

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HOST_REPS = 3
WORKER_TIMEOUT_S = 600


def _rand_reads(B, T, A1, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=2, keepdims=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launches():
    return {k: v for k, v in beam_cuda.launches.items() if v}


def _join(port, world, rank, device):
    if device.type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: loopback rendezvous
    mesh.distributed_init(f"tcp://127.0.0.1:{port}", world, rank,
                          device=None if device.type == "cuda" else "cpu")


def host_worker(argv):
    """One worker of ``hosts``: ``rank nproc port reads_per_host T device``;
    prints ``WORKER_RESULT {json}``."""
    rank, nproc, port, B_per, T = (int(a) for a in argv[:5])
    on_card = argv[5] == "cuda"
    if not on_card:
        torch.set_num_threads(1)  # the workers share the host's cores
    dev = mesh.local_device() if on_card else torch.device("cpu")
    _join(port, nproc, rank, dev)
    try:
        B = B_per * nproc
        probs = _rand_reads(B, T, 5)
        lengths = np.full((B,), T, np.int32)
        lo, hi = mesh.shard_bounds(B, rank, nproc)
        probs_d = torch.from_numpy(probs[lo:hi]).to(dev)
        lengths_d = torch.from_numpy(lengths[lo:hi]).to(dev)
        run = lambda: decode_and_count(probs_d, lengths_d, beam_size=5, threshold=0.1,
                                       collapse=True, device=dev)
        beam_cuda.reset_launches()
        run()[1].tolist()  # build + warm
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            totals = run()[1]
        totals = totals.tolist()
        synchronize(dev)
        dt = (time.perf_counter() - t0) / HOST_REPS
    finally:
        torch.distributed.destroy_process_group()
    if totals != [B, 0]:
        raise AssertionError(f"rank {rank}: totals {totals} != [{B}, 0]")
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "fast_ctc_decode_tpu")]
    if leaked:
        raise AssertionError(f"rank {rank} imported {leaked[:4]}")
    print("WORKER_RESULT", json.dumps({"rank": rank, "dt": dt, "B": B, "totals": totals,
                                       "launches": _launches()}), flush=True)


def _run_workers(n, reads_per_host, T, device):
    port = _free_port()
    code = ("import sys; from fast_ctc_decode_tpu_torch.tools import scaling_bench as s; "
            "s.host_worker(sys.argv[1:])")
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(i), str(n), str(port), str(reads_per_host), str(T),
             device.type],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**env, "LOCAL_RANK": str(i)},
        )
        for i in range(n)
    ]
    results, logs = [], []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {i} exited {p.returncode}:\n{log[-2000:]}")
        results += [json.loads(line.split(" ", 1)[1])
                    for line in log.splitlines() if line.startswith("WORKER_RESULT")]
    if len(results) != n:
        raise RuntimeError(f"{len(results)} of {n} workers reported")
    return results


def bench_hosts(nproc, reads_per_host=64, T=1000, device=None):
    """Rows for n = 1 and n = ``nproc`` processes (one row when nproc is 1)."""
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else None
    name, _ = card_info(dev)
    rows, base = [], None
    for n in sorted({1, nproc}):
        row = {"mode": "hosts", "n": n, "reads": reads_per_host * n}
        if cards is not None and n > cards:
            row.update(reads_per_s=None, efficiency=None,
                       unmeasured=f"needs {n} CUDA cards, found {cards}")
        else:
            res = _run_workers(n, reads_per_host, T, dev)
            totals = {tuple(r["totals"]) for r in res}
            if totals != {(row["reads"], 0)}:
                raise AssertionError(f"n={n}: workers' totals {totals}")
            rps = row["reads"] / max(r["dt"] for r in res)  # global step = slowest worker
            if base is None:
                base = rps / n
            launches = {}
            for r in res:
                for k, v in r["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            row.update(reads_per_s=rps, efficiency=rps / (n * base), totals=[row["reads"], 0],
                       device=name, launches=launches)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def bench_overhead(reads_per_dev, T, reps=5, engine="fast", device=None):
    """The row, and the two host result dicts (engine alone, then
    ``decode_and_count``), which must be equal."""
    dev = resolve_device(device)
    if engine == "cuda" and dev.type != "cuda":
        raise ValueError(f"engine 'cuda' needs a CUDA device, got {dev}")
    B = reads_per_dev
    pd = torch.from_numpy(_rand_reads(B, T, 5)).to(dev)
    ld = torch.full((B,), T, dtype=torch.int32, device=dev)
    engine_fn = beam_cuda.beam_search_kernel_batch if engine == "cuda" else (
        beam_fast.beam_search_fast_batch)
    beam_cuda.reset_launches()
    plain_out = engine_fn(pd, ld, np.float32(0.1), beam_size=5, collapse_repeats=True)
    rps_plain = B / mean_s(lambda: engine_fn(pd, ld, np.float32(0.1), beam_size=5,
                                             collapse_repeats=True), reps, dev)

    owned = not torch.distributed.is_initialized()
    if owned:
        _join(_free_port(), 1, 0, dev)
    try:
        backend = torch.distributed.get_backend()
        run = lambda: decode_and_count(pd, ld, beam_size=5, threshold=0.1, collapse=True,
                                       engine=engine, device=dev)
        shard_out, totals = run()
        rps_shard = B / mean_s(run, reps, dev)
        n = torch.distributed.get_world_size()
    finally:
        if owned:
            torch.distributed.destroy_process_group()
    plain_out = {k: v.cpu().numpy() for k, v in plain_out.items()}
    shard_out = {k: v.cpu().numpy() for k, v in shard_out.items()}
    if plain_out.keys() != shard_out.keys() or not all(
            np.array_equal(plain_out[k], shard_out[k]) for k in plain_out):
        raise AssertionError("decode_and_count's dict differs from the engine's")
    if totals.tolist() != [B * n, 0]:
        raise AssertionError(f"totals {totals.tolist()}")
    row = {
        "mode": "overhead",
        "n": n,
        "reads": B,
        "reads_per_s_plain": rps_plain,
        "reads_per_s_sharded_psum": rps_shard,
        "efficiency": rps_shard / rps_plain,
        "backend": backend,
        "engine": engine,
        "device": card_info(dev)[0],
        "launches": _launches(),
    }
    print(json.dumps(row), flush=True)
    return row, plain_out, shard_out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fast_ctc_decode_tpu_torch.tools.scaling_bench",
        description="reads/s over processes (hosts) and the all-reduce's cost (overhead)")
    ap.add_argument("mode", choices=["hosts", "overhead"])
    ap.add_argument("--reads-per-dev", type=int, default=256)
    ap.add_argument("--reads-per-host", type=int, default=64)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--engine", choices=["fast", "cuda"], default="fast",
                    help="decode engine of the overhead mode (default: fast)")
    ap.add_argument("--device", default=None, help="cpu to check the tool on the CPU")
    args = ap.parse_args(argv)
    if args.mode == "overhead":
        return bench_overhead(args.reads_per_dev, args.T, engine=args.engine,
                              device=args.device)[0]
    return bench_hosts(args.nproc, args.reads_per_host, args.T, device=args.device)


if __name__ == "__main__":
    main()
