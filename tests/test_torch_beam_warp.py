"""The beam wrapper's two version-2 designs, the warp-per-read kernel's
arguments and bounds, and the kernel probe, on the CPU.

On a CPU tensor every design runs the plain engine, so these tests hold the
wrapper's routing rule, its argument checks and its bounds, and one routed
call against the JAX package's scan engine.  The kernel bodies are held to
the plain engines through a host shim (``test_torch_beam_shim.py``) and on
the card (``chip_smoke.py``).
"""

import os

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu.ops import beam_fast as jax_beam_fast
from fast_ctc_decode_tpu_torch.ops import beam_cuda, beam_exact_cuda, beam_fast

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(beam_cuda.__file__), os.pardir, "csrc")
FIELDS = ("labels_rev", "times_rev", "count", "err")
# (KMAX, AMAX) of the kernels' instances, narrowest first
INSTANCES = ((5, 4), (16, 7))


def rand_batch(B, T, A1, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=-1, keepdims=True)


def crf_batch(B, T, S, A1, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, S, A1).astype(np.float32)
    x /= x.sum(-1, keepdims=True)
    return x, rng.rand(B, S).astype(np.float32)


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_design_routing_threshold():
    t = beam_cuda.THREAD_MIN_B
    # <5, 4>: routed by B alone, at its every (K, A)
    for K, A in ((5, 4), (1, 1), (3, 4), (5, 2)):
        assert beam_cuda.instance(K, A) == INSTANCES[0]
        assert [beam_cuda.design_for(b, K, A) for b in (0, 1, t - 1, t, 32768)] == [
            "warp", "warp", "warp", "thread", "thread"]
    # <16, 7>: the warp design at every B (the probe's wide sweep)
    for K, A in ((16, 7), (8, 4), (6, 4), (5, 5), (1, 7)):
        assert beam_cuda.instance(K, A) == INSTANCES[1]
        assert {beam_cuda.design_for(b, K, A) for b in (0, 1, t - 1, t, 32768, 2**31 - 1)} == {
            "warp"}
    assert beam_cuda.INSTANCES == INSTANCES
    assert beam_cuda.DESIGNS == ("thread", "warp")


def test_cpu_routing_equals_jax_and_launches_nothing():
    B, T = 6, 30
    x = rand_batch(B, T, 5, 3)
    lengths = np.array([30, 0, 17, 30, 1, 30], np.int32)
    before = dict(beam_cuda.launches)
    got = beam_cuda.beam_search_kernel_batch(
        torch.from_numpy(x), torch.from_numpy(lengths), 0.1, beam_size=5)
    want = jax_beam_fast.beam_search_fast_batch(x, lengths, np.float32(0.1), beam_size=5)
    for f in FIELDS:
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    # raw=True stops after the beam kernel, 1D and CRF
    c, init = crf_batch(3, 16, 8, 5, 7)
    args = (torch.from_numpy(c), torch.from_numpy(init), torch.tensor([16, 9, 0], dtype=torch.int32))
    raw = beam_cuda.crf_beam_search_kernel_batch(*args, 0.05, beam_size=5, raw=True)
    assert sorted(raw) == ["err", "fin", "ids_log"] and tuple(raw["ids_log"].shape) == (16, 5, 3)
    raw = beam_cuda.beam_search_kernel_batch(
        torch.from_numpy(x), torch.from_numpy(lengths), 0.1, beam_size=5, raw=True)
    assert sorted(raw) == ["err", "fin", "ids_log"] and tuple(raw["ids_log"].shape) == (T, 5, B)
    assert beam_cuda.launches == before  # nothing launched on the CPU


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(design="bogus"),
        dict(design="warp", version=1),
        dict(design="thread", version=3),
        dict(version=4),
    ],
)
def test_design_and_version_arguments_raise(kwargs):
    x = torch.from_numpy(rand_batch(2, 8, 5, 0))
    with pytest.raises(ValueError):
        beam_cuda.beam_ids_kernel(x, torch.full((2,), 8, dtype=torch.int32), 0.1,
                                  beam_size=5, **kwargs)


@pytest.mark.parametrize("rpb", [0, 9, True, 2.0, "4", -1])
def test_reads_per_block_out_of_range_raises(rpb):
    x = torch.from_numpy(rand_batch(2, 8, 5, 0))
    ln = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="reads_per_block"):
        beam_cuda.beam_ids_kernel(x, ln, 0.1, beam_size=5, reads_per_block=rpb)
    c, init = crf_batch(2, 8, 4, 5, 1)
    with pytest.raises(ValueError, match="reads_per_block"):
        beam_cuda.crf_beam_ids_kernel(torch.from_numpy(c), torch.from_numpy(init), ln, 0.1,
                                      beam_size=5, reads_per_block=rpb)


@pytest.mark.parametrize("K, A1", [(1, 2), (5, 5), (6, 5), (5, 6), (16, 8)])
def test_instances_just_fit_the_wrapper(K, A1):
    # each instance's edges pass the wrapper (the shim runs them through the bodies)
    x = torch.from_numpy(rand_batch(2, 10, A1, K))
    ln = torch.full((2,), 10, dtype=torch.int32)
    for design in beam_cuda.DESIGNS:
        assert tuple(beam_cuda.beam_ids_kernel(x, ln, 0.0, beam_size=K, design=design)[0].shape) == (
            10, K, 2)
    c, init = crf_batch(2, 10, 4, A1, K)
    got = beam_cuda.crf_beam_ids_kernel(torch.from_numpy(c), torch.from_numpy(init), ln, 0.0,
                                        beam_size=K)
    assert tuple(got[0].shape) == (10, K, 2)


@pytest.mark.parametrize("K, A1", [(17, 5), (5, 9), (17, 9), (0, 5), (5, 1)])
def test_instances_just_miss(K, A1):
    x = torch.from_numpy(rand_batch(2, 6, max(A1, 2), 0))[..., :A1].contiguous()
    ln = torch.full((2,), 6, dtype=torch.int32)
    for design in beam_cuda.DESIGNS:
        with pytest.raises(ValueError):
            beam_cuda.beam_ids_kernel(x, ln, 0.0, beam_size=K, design=design)
    c, init = crf_batch(2, 6, 4, max(A1, 2), 0)
    with pytest.raises(ValueError):
        beam_cuda.crf_beam_ids_kernel(torch.from_numpy(c[..., :A1].copy()), torch.from_numpy(init),
                                      ln, 0.0, beam_size=K)


def test_node_id_bound_just_fits_and_misses():
    K, A = 5, 4
    T = beam_fast._I32_MAX // (K * A)
    beam_cuda._bounds(T, K, A)  # T*K*A <= 2**31 - 1
    with pytest.raises(ValueError, match="int32 node ids"):
        beam_cuda._bounds(T + 1, K, A)


def test_instances_and_bounds_match_the_sources():
    warp = _source("beam_warp_kernel.cu")
    thread = _source("beam_kernel.cu")
    for kmax, amax in INSTANCES:
        guard = f"if (K <= {kmax} && A <= {amax})"
        assert guard in warp and guard in thread, guard
        assert f"launch<{kmax}, {amax}, true>" in warp and f"launch<{kmax}, {amax}, false>" in warp
    assert INSTANCES[-1] == (beam_cuda.MAX_BEAM, beam_cuda.MAX_A1 - 1)
    assert f"constexpr int kMaxReadsPerBlock = {beam_cuda.MAX_READS_PER_BLOCK};" in warp
    assert beam_exact_cuda.MAX_READS_PER_BLOCK == beam_cuda.MAX_READS_PER_BLOCK


def test_kernel_probe_quick_runs_on_the_cpu():
    from fast_ctc_decode_tpu_torch.tools import kernel_probe

    rows = [r for _, r in kernel_probe.main(["--quick", "--device", "cpu"])]
    stages = [r["stage"] for r in rows if r["what"] == "stage"]
    assert stages == ["beam", "traceback", "whole"]
    # beam 5 at A+1 = 5, then the wide instance's two shapes, both designs at each B
    shapes = [(5, 5), *kernel_probe.WIDE_SHAPES]
    assert kernel_probe.WIDE_SHAPES == ((16, 8), (8, 5))
    assert [beam_cuda.instance(K, a1 - 1) for K, a1 in shapes] == [
        INSTANCES[0], INSTANCES[1], INSTANCES[1]]
    designs = [(r["beam"], r["A1"], r["B"], r["design"]) for r in rows if r["what"] == "design"]
    assert designs == [(K, a1, b, d) for K, a1 in shapes for b in (1, 8)
                       for d in beam_cuda.DESIGNS]
    faster = [r for r in rows if r["what"] == "faster"]
    assert [(r["beam"], r["A1"], r["B"]) for r in faster] == [
        (K, a1, b) for K, a1 in shapes for b in (1, 8)]
    assert all(r["routed"] == beam_cuda.design_for(r["B"], r["beam"], r["A1"] - 1)
               for r in faster)
    assert all(r["routed"] == "warp" for r in faster if r["beam"] == 5)
    assert [r["reads_per_block"] for r in rows if r["what"] == "reads_per_block"] == [1, 2, 4, 8]
    assert all(r["ms"] > 0 for r in rows if "ms" in r)
    lines = [line for line, r in kernel_probe.run(8, 20, device="cpu", iters=1, sweep_b=(2,),
                                                  rpb_b=2) if "ms" in r]
    assert lines and all("host clock" in line for line in lines)  # never a device time


def test_kernel_probe_quick_sweeps_the_traceback():
    from fast_ctc_decode_tpu_torch.tools import kernel_probe

    rows = [r for _, r in kernel_probe.main(["--quick", "--device", "cpu"])]
    routes = list(beam_cuda.TRACEBACK_ROUTES)
    assert [(r["B"], r["route"]) for r in rows if r["what"] == "traceback"] == [
        (b, route) for b in (1, 8) for route in routes]
    faster = [r for r in rows if r["what"] == "traceback_faster"]
    assert [r["B"] for r in faster] == [1, 8] and all(r["routed"] == "sweep" for r in faster)
    blocks = [(r["route"], r["warps"], r["steps"]) for r in rows if r["what"] == "traceback_block"]
    # the steps a tile that fit (T = 50 at --quick), once each, then the walk, per block size
    fit = lambda w: sorted({beam_cuda.traceback_route(50, 5, warps=w, steps=st)[1]
                            for st in (4, 32)})
    assert fit(1) == [4, 32] and fit(4)[0] == 4 and fit(4)[1] < 32
    assert blocks == [(route, w, st) for w in (1, 4)
                      for route, st in [("sweep", st) for st in fit(w)] + [("walk", 0)]]
    assert all(r["B"] == 8 and r["ms"] > 0 for r in rows if r["what"] == "traceback_block")
