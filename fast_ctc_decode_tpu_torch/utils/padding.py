"""Ragged-read batching: pad variable-length posterior matrices into fixed
[B, T, A] blocks + lengths, with optional length bucketing to bound padding
waste.  Device kernels gate on per-read lengths so padded frames are no-ops.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def pad_batch(
    reads: Sequence[np.ndarray], T: int = None, pad_to_multiple: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack reads [[Ti, A]] into ([B, T, A] f32, [B] i32 lengths)."""
    if not reads:
        raise ValueError("no reads given")
    A = reads[0].shape[1]
    maxT = max(r.shape[0] for r in reads)
    if T is None:
        T = -(-maxT // pad_to_multiple) * pad_to_multiple
    if maxT > T:
        raise ValueError(f"read length {maxT} exceeds block size {T}")
    batch = np.zeros((len(reads), T, A), np.float32)
    lengths = np.zeros((len(reads),), np.int32)
    for i, r in enumerate(reads):
        if r.shape[1] != A:
            raise ValueError("inconsistent label dimension across reads")
        batch[i, : r.shape[0]] = r
        lengths[i] = r.shape[0]
    return batch, lengths


def edge_holding(T: int, edges: Sequence[int]) -> int:
    """The first of ``edges`` (ascending) that holds ``T`` frames; ValueError
    when the last cannot."""
    for e in edges:
        if T <= e:
            return e
    raise ValueError(f"read of length {T} exceeds largest bucket {edges[-1]}")


def bucket_reads(
    reads: Sequence[np.ndarray], bucket_edges: Sequence[int]
) -> Dict[int, List[int]]:
    """Group read indices into length buckets (edge = max length per bucket);
    one compiled kernel per bucket keeps padding waste bounded."""
    edges = sorted(bucket_edges)
    buckets: Dict[int, List[int]] = {}
    for i, r in enumerate(reads):
        buckets.setdefault(edge_holding(r.shape[0], edges), []).append(i)
    return dict(sorted(buckets.items()))
