"""The PyTorch port's plain beam engine against the JAX package.

``fast_ctc_decode_tpu_torch.ops.beam_fast`` must reproduce
``fast_ctc_decode_tpu.ops.beam_fast`` bit for bit: the hash lanes, and the
whole output dict (labels_rev, times_rev, count, err — all int32, compared
with tolerance 0) on the cases of tests/test_pallas_beam.py.  Inputs are
made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from fast_ctc_decode_tpu import errors
from fast_ctc_decode_tpu.ops import beam_fast as jax_beam_fast
from fast_ctc_decode_tpu.ops import beam_pallas as jax_beam_pallas
from fast_ctc_decode_tpu_torch.ops import beam_cuda
from fast_ctc_decode_tpu_torch.ops import beam_fast as torch_beam_fast

torch.set_num_threads(1)

FIELDS = ("labels_rev", "times_rev", "count", "err")


def rand_batch(B, T, A1, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=-1, keepdims=True)


def run_torch(probs, lengths, thr, beam_size=5, collapse=True):
    out = torch_beam_fast.beam_search_fast_batch(
        torch.from_numpy(probs), torch.from_numpy(lengths), np.float32(thr),
        beam_size=beam_size, collapse_repeats=collapse,
    )
    return {k: v.numpy() for k, v in out.items()}


def run_jax(probs, lengths, thr, beam_size=5, collapse=True):
    out = jax_beam_fast.beam_search_fast_batch(
        probs, lengths, np.float32(thr),
        beam_size=beam_size, collapse_repeats=collapse,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def assert_same(ref, got):
    for k in FIELDS:
        assert ref[k].dtype == np.int32 and got[k].dtype == np.int32, k
        assert np.array_equal(ref[k], got[k]), k


@pytest.mark.parametrize("mix", ["_mix1", "_mix2"])
def test_mix_lanes_bit_equal(mix):
    rng = np.random.RandomState(7)
    h = rng.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    lbl = rng.randint(-(2**31), 2**31, size=4096, dtype=np.int64).astype(np.int32)
    lbl[:8] = [0, 1, 2, 3, -1, 2**31 - 1, -(2**31), 7]
    want = np.asarray(getattr(jax_beam_fast, mix)(jnp.asarray(h), jnp.asarray(lbl)))
    got = getattr(torch_beam_fast, mix)(
        torch.from_numpy(h.astype(np.int64)), torch.from_numpy(lbl)
    )
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) < 2**32


def _case(name):
    """(probs, lengths, thr, beam_size, collapse) of tests/test_pallas_beam.py."""
    if name == "ragged":
        return rand_batch(4, 40, 5, 1), np.array([40, 23, 7, 40], np.int32), 0.1, 5, True
    if name == "block_boundaries":
        return rand_batch(3, 37, 5, 2), np.full((3,), 37, np.int32), 0.1, 5, True
    if name == "collapse_off_thr0":
        return rand_batch(2, 30, 4, 3), np.full((2,), 30, np.int32), 0.0, 3, False
    if name == "nan_and_empty":
        probs = rand_batch(3, 20, 5, 4)
        probs[1, 5, 2] = np.nan
        probs[2] = 0.01  # all under the cut
        return probs, np.full((3,), 20, np.int32), 0.19, 5, True
    if name == "zero_lengths":  # decode_many's length-0 padding rows
        return rand_batch(4, 16, 5, 6), np.array([0, 16, 0, 5], np.int32), 0.1, 5, True
    if name.startswith("beam"):
        return rand_batch(3, 30, 5, 5), np.full((3,), 30, np.int32), 0.0, int(name[4:]), True
    raise KeyError(name)


@pytest.mark.parametrize(
    "name",
    ["ragged", "block_boundaries", "collapse_off_thr0", "nan_and_empty",
     "zero_lengths", "beam8", "beam12", "beam16"],
)
def test_plain_engine_equals_jax_fast(name):
    probs, lengths, thr, K, collapse = _case(name)
    ref = run_jax(probs, lengths, thr, K, collapse)
    got = run_torch(probs, lengths, thr, K, collapse)
    assert_same(ref, got)
    if name == "nan_and_empty":
        assert got["err"][1] == errors.INCOMPARABLE_VALUES
        assert got["err"][2] == errors.RAN_OUT_OF_BEAM
    if name == "zero_lengths":
        assert list(got["count"][[0, 2]]) == [0, 0]


@pytest.mark.parametrize("thr", [0.0, 0.1])
def test_plain_engine_equals_jax_fast_on_inf_and_nan(thr):
    # +-inf and NaN entries: the plain engine (and so the CUDA kernel held
    # to it on the card) follows the JAX scan engine field for field
    rng = np.random.RandomState(17)
    for trial in range(10):
        probs = rand_batch(4, 12, 5, 100 + trial)
        u = rng.rand(*probs.shape)
        probs[u < 0.03] = np.inf
        probs[(u >= 0.03) & (u < 0.05)] = -np.inf
        probs[(u >= 0.05) & (u < 0.06)] = np.nan
        lengths = np.full((4,), 12, np.int32)
        assert_same(run_jax(probs, lengths, thr), run_torch(probs, lengths, thr))


def test_plain_engine_equals_interpret_pallas():
    # the JAX package's own CPU form of the fused kernel (interpret mode)
    probs, lengths, thr, K, collapse = _case("ragged")
    ref = jax_beam_pallas.beam_search_pallas_batch(
        probs, lengths, np.float32(thr), beam_size=K,
        collapse_repeats=collapse, interpret=True,
    )
    assert_same({k: np.asarray(v) for k, v in ref.items()},
                run_torch(probs, lengths, thr, K, collapse))


def test_t1000_oracle_sequences():
    B, T = 4, 1000
    rng = np.random.RandomState(123)
    probs = rng.rand(B, T, 5).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    out = run_torch(probs, np.full((B,), T, np.int32), 0.1)
    for i in range(B):
        assert out["err"][i] == 0
        n = int(out["count"][i])
        seq = "".join("NACGT"[int(l) + 1] for l in out["labels_rev"][i, :n][::-1])
        want, _ = oracle.beam_search(probs[i], "NACGT", 5, 0.1)
        assert seq == want, i


def test_kernel_wrapper_on_cpu_runs_plain_version():
    probs, lengths, thr, K, collapse = _case("ragged")
    before = dict(beam_cuda.launches)
    got = beam_cuda.beam_search_kernel_batch(
        torch.from_numpy(probs), torch.from_numpy(lengths), thr,
        beam_size=K, collapse_repeats=collapse,
    )
    assert beam_cuda.launches == before  # nothing launched on the CPU
    assert_same(run_torch(probs, lengths, thr, K, collapse),
                {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize(
    "kwargs, exc",
    [
        (dict(beam_size=17), ValueError),  # past the kernel's beam bound
        (dict(beam_size=0), ValueError),
        (dict(dtype=torch.float64), TypeError),
    ],
)
def test_kernel_wrapper_rejects_out_of_bounds(kwargs, exc):
    probs = torch.from_numpy(rand_batch(2, 8, 5, 0)).to(kwargs.get("dtype", torch.float32))
    with pytest.raises(exc):
        beam_cuda.beam_search_kernel_batch(
            probs, torch.full((2,), 8, dtype=torch.int32), 0.1,
            beam_size=kwargs.get("beam_size", 5),
        )


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from fast_ctc_decode_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
