"""The three beam kernel versions of the port against the JAX package's.

``beam_cuda.beam_search_kernel_batch(version=v)`` (v = 1, 2, 3) must equal
``beam_pallas.beam_search_pallas_batch(version=v, interpret=True)`` bit for
bit: the output dict (labels_rev, times_rev, count, err; int32, tolerance 0)
and, with ``raw=True``, the kernel outputs (the id log against the
``[:T, :K, :B]`` corner of JAX's padded log, fin, err).  On the CPU every
version runs the one plain function they all compute; the CUDA kernels are
held to it on the card by chip_smoke.py.  Inputs are made with numpy from a
seed and handed to both packages; the tie cases are ``chip_smoke.py``'s
(powers of two, so that fresh extensions of different tips tie inside the
beam and only the id order (k, a) breaks the tie).
"""

import os
import sys

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu.ops import beam_pallas as jax_beam_pallas
from fast_ctc_decode_tpu_torch.ops import beam_cuda

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the tie cases held on the card)

torch.set_num_threads(1)

FIELDS = ("labels_rev", "times_rev", "count", "err")


def rand_batch(B, T, A1, seed):
    x = np.random.RandomState(seed).rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=-1, keepdims=True)


def case(name):
    """(probs, lengths, thr, beam_size, collapse)."""
    if name == "ragged":
        return rand_batch(4, 24, 5, 1), np.array([24, 13, 7, 24], np.int32), 0.1, 5, True
    if name == "nan_and_empty":
        probs = rand_batch(3, 16, 5, 4)
        probs[1, 5, 2] = np.nan
        probs[2] = 0.01  # all under the cut
        return probs, np.full((3,), 16, np.int32), 0.19, 5, True
    if name == "zero_lengths":
        return rand_batch(4, 16, 5, 6), np.array([0, 16, 0, 5], np.int32), 0.1, 5, True
    if name == "beam1":
        return rand_batch(3, 20, 5, 7), np.full((3,), 20, np.int32), 0.05, 1, True
    if name == "no_collapse":
        return rand_batch(2, 20, 4, 3), np.full((2,), 20, np.int32), 0.0, 3, False
    if name.startswith("ties"):
        (_, probs, lengths, thr, K, collapse), = (
            c for c in chip_smoke.parity_cases(full_width=False) if c[0] == name)
        return probs, np.array(lengths, np.int32), thr, K, collapse
    raise KeyError(name)


CASES = ["ragged", "nan_and_empty", "zero_lengths", "beam1", "no_collapse", "ties",
         "ties_cut0.1"]


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("name", CASES)
def test_version_equals_jax_interpret(version, name):
    probs, lengths, thr, K, collapse = case(name)
    B, T = probs.shape[:2]
    kw = dict(beam_size=K, collapse_repeats=collapse, version=version)
    ref = jax_beam_pallas.beam_search_pallas_batch(
        probs, lengths, np.float32(thr), interpret=True, **kw)
    raw_ref = jax_beam_pallas.beam_search_pallas_batch(
        probs, lengths, np.float32(thr), interpret=True, raw=True, **kw)
    p, ln = torch.from_numpy(probs), torch.from_numpy(lengths)
    got = beam_cuda.beam_search_kernel_batch(p, ln, thr, **kw)
    raw = beam_cuda.beam_search_kernel_batch(p, ln, thr, raw=True, **kw)
    for f in FIELDS:
        want = np.asarray(ref[f])
        assert got[f].dtype == torch.int32 and np.array_equal(got[f].numpy(), want), f
    assert np.array_equal(raw["ids_log"].numpy(), np.asarray(raw_ref["ids_log"])[:T, :K, :B])
    assert np.array_equal(raw["fin"].numpy(), np.asarray(raw_ref["fin"])[0, :B])
    assert np.array_equal(raw["err"].numpy(), np.asarray(raw_ref["err"]))
    if name == "nan_and_empty":
        assert list(got["err"].numpy()) == [0, 2, 1]


def test_unknown_version_raises():
    probs, lengths, thr, K, collapse = case("ragged")
    p, ln = torch.from_numpy(probs), torch.from_numpy(lengths)
    for version in (0, 4, "2"):
        with pytest.raises(ValueError, match="unknown beam kernel version"):
            beam_cuda.beam_search_kernel_batch(p, ln, thr, beam_size=K, version=version)
        with pytest.raises(ValueError, match="unknown beam kernel version"):
            beam_cuda.beam_ids_kernel(p, ln, thr, beam_size=K, version=version)


def test_versions_on_the_cpu_launch_nothing():
    probs, lengths, thr, K, collapse = case("ragged")
    before = dict(beam_cuda.launches)
    outs = [
        beam_cuda.beam_ids_kernel(torch.from_numpy(probs), torch.from_numpy(lengths), thr,
                                  beam_size=K, version=v)
        for v in (1, 2, 3)
    ]
    assert beam_cuda.launches == before
    assert set(before) >= {"beam", "beam_v1", "beam_v3"}
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
