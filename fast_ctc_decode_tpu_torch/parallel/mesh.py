"""Process-group helpers for data-parallel decoding: the counterpart of
``fast_ctc_decode_tpu/parallel/mesh.py`` on ``torch.distributed``.

The JAX package shards read batches over a 1-D ``data`` mesh of devices and
merges its counters with a ``psum``.  Here one process owns one card: each
process decodes its own contiguous slice of the reads (``shard_bounds``) on
``local_device()``, and ``pipeline.decode_and_count`` sums the counters over
the default process group with ``all_reduce``.  ``make_data_mesh``,
``batch_sharding`` and ``replicated`` have no counterpart: a process holds no
mesh of devices to shard over.

Nothing on a machine tells a program of its cluster: the caller passes the
rendezvous (``init_method``, e.g. ``"tcp://localhost:29500"``), the world
size and the rank, or sets the ``env://`` variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) itself.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device, with_index


def local_device() -> torch.device:
    """This process's card: ``cuda:{LOCAL_RANK}`` (LOCAL_RANK defaults to 0)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def distributed_init(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device=None,
) -> None:
    """Join the default process group (a no-op if it already exists).

    ``device`` sets the backend: "nccl" for the card (``device=None`` or a
    CUDA device, which becomes this process's current device), "gloo" for
    ``device="cpu"``.  Without a CUDA device, ``device=None`` raises
    RuntimeError: it never switches to the CPU quietly."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)  # raises without a card unless given one
    dev = local_device() if device is None else with_index(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    kw = {}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    dist.init_process_group(backend=backend, init_method=init_method, **kw)


def shard_bounds(B: int, rank: int, world: int) -> Tuple[int, int]:
    """The contiguous slice ``[lo, hi)`` of B reads that process ``rank`` of
    ``world`` decodes (equal slices when ``world`` divides B, as the JAX
    package's process-local shards are)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    return rank * B // world, (rank + 1) * B // world
