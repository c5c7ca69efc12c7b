"""The PyTorch port's exact tree engine (1D and CRF) against the JAX package.

``fast_ctc_decode_tpu_torch.ops.beam`` / ``ops.crf`` must reproduce
``fast_ctc_decode_tpu.ops.beam.beam_search_device_batch`` /
``ops.crf.crf_beam_search_device`` bit for bit: labels_rev, times_rev,
count and err (int32, tolerance 0), on the kinds of input of
tests/test_pallas_exact_beam.py (ragged, tie-heavy, all-pruned, NaN, node
overflow).  The JAX package's fused kernel is matched once per form in
interpret mode.  The wrapper of the CUDA kernel (``ops/beam_exact_cuda.py``)
runs the plain engine on CPU tensors and refuses shapes beyond its bounds;
the kernel build compiles one source per nvcc process and raises without
nvcc.
"""

import os
import stat

import jax
import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu.ops import beam as jax_beam
from fast_ctc_decode_tpu.ops import beam_exact_pallas as jax_bxp
from fast_ctc_decode_tpu.ops import crf as jax_crf
from fast_ctc_decode_tpu_torch import errors
from fast_ctc_decode_tpu_torch.ops import _build
from fast_ctc_decode_tpu_torch.ops import beam as port_beam
from fast_ctc_decode_tpu_torch.ops import beam_exact_cuda
from fast_ctc_decode_tpu_torch.ops import crf as port_crf

torch.set_num_threads(1)

FIELDS = ("labels_rev", "times_rev", "count", "err")


def rand_batch(B, T, A1, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def crf_batch(B, T, S, seed, A1=5):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, S, A1).astype(np.float32)
    x /= x.sum(axis=-1, keepdims=True)
    init = rng.rand(B, S).astype(np.float32)
    return x, init / init.sum(axis=1, keepdims=True)


def assert_same(want, got):
    for k in FIELDS:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.dtype == np.int32 and g.dtype == np.int32, k
        assert np.array_equal(w, g), k


def run_port(x, lengths, thr, K, collapse, N):
    out = port_beam.beam_search_device_batch(
        torch.from_numpy(x), torch.from_numpy(lengths), thr, beam_size=K,
        collapse_repeats=collapse, max_nodes=N,
    )
    return {k: v.numpy() for k, v in out.items()}


def check_1d(x, lengths, thr, K=5, collapse=True, N=None):
    N = N or jax_beam.default_max_nodes(x.shape[1], K, x.shape[2] - 1)
    want = jax_beam.beam_search_device_batch(
        x, lengths, np.float32(thr), beam_size=K, collapse_repeats=collapse, max_nodes=N
    )
    got = run_port(x, lengths, thr, K, collapse, N)
    assert_same(want, got)
    return got


@pytest.mark.parametrize("collapse", [True, False])
@pytest.mark.parametrize("thr", [0.0, 0.1])
def test_exact_equals_jax_ragged(collapse, thr):
    x = rand_batch(4, 40, 5, 11)
    lengths = np.array([40, 1, 0, 27], np.int32)
    got = check_1d(x, lengths, thr, collapse=collapse)
    assert list(got["err"]) == [0] * 4 and got["count"][2] == 0


def test_exact_tie_heavy_and_all_pruned():
    rng = np.random.RandomState(3)
    ties = (rng.rand(4, 40, 5) > 0.5).astype(np.float32) * 0.9 + 0.05
    lengths = np.full((4,), 40, np.int32)
    check_1d(ties, lengths, 0.0)
    got = check_1d(np.full((4, 40, 5), 0.05, np.float32), lengths, 0.1)
    assert list(got["err"]) == [errors.RAN_OUT_OF_BEAM] * 4


def test_exact_nan_and_inf():
    x = rand_batch(4, 16, 5, 5)
    x[0, 4, 2] = np.nan
    x[1, 0, 0] = np.nan
    x[2, 3, 1] = np.inf
    x[3, 6, 0] = -np.inf
    got = check_1d(x, np.full((4,), 16, np.int32), 0.0)
    assert got["err"][0] == errors.INCOMPARABLE_VALUES


@pytest.mark.parametrize("N", [8, 37])
def test_exact_node_overflow(N):
    x = rand_batch(3, 30, 5, 9)
    got = check_1d(x, np.array([30, 12, 30], np.int32), 0.0, N=N)
    assert errors.NODE_OVERFLOW in list(got["err"])


@pytest.mark.parametrize("K, A1", [(8, 5), (16, 8)])
def test_exact_wide_beams(K, A1):
    check_1d(rand_batch(2, 24, A1, 12), np.array([24, 17], np.int32), 0.0, K=K)


def check_crf(x, init, lengths, thr, K=5, N=None):
    B, T = x.shape[:2]
    N = N or jax_beam.default_max_nodes(T, K, x.shape[3] - 1)
    got = port_crf.crf_beam_search_device_batch(
        torch.from_numpy(x), torch.from_numpy(init), torch.from_numpy(lengths), thr,
        beam_size=K, max_nodes=N,
    )
    fn = jax.vmap(
        lambda p, s, n: jax_crf.crf_beam_search_device(
            p, s, n, np.float32(thr), beam_size=K, max_nodes=N
        )
    )
    assert_same(fn(x, init, lengths), {k: v.numpy() for k, v in got.items()})
    return got


@pytest.mark.parametrize("case", ["ragged_S8", "ties_S9", "nan_and_pruned", "overflow", "beam8"])
def test_exact_crf_equals_jax(case):
    lengths = np.full((3,), 20, np.int32)
    thr, K, N = 0.0, 5, None
    if case == "ragged_S8":
        x, init = crf_batch(3, 20, 8, 17)
        lengths = np.array([20, 6, 0], np.int32)
        thr = 0.05
    elif case == "ties_S9":
        x, init = crf_batch(3, 20, 9, 18, A1=4)
        x = (x > 0.2).astype(np.float32) * 0.9 + 0.05
    elif case == "nan_and_pruned":
        x, init = crf_batch(3, 20, 8, 19)
        x[0, 3, :, 2] = np.nan
        x[1] = 0.01
        thr = 0.19
    elif case == "overflow":
        x, init = crf_batch(3, 20, 8, 20)
        N = 12
    else:
        x, init = crf_batch(3, 20, 16, 21)
        K = 8
    got = check_crf(x, init, lengths, thr, K=K, N=N)
    if case == "nan_and_pruned":
        assert got["err"].tolist()[:2] == [errors.INCOMPARABLE_VALUES, errors.RAN_OUT_OF_BEAM]
    if case == "overflow":
        assert errors.NODE_OVERFLOW in got["err"].tolist()


def test_exact_equals_interpret_pallas_once():
    # the JAX package's own CPU form of the fused tree kernel, both forms
    x = rand_batch(2, 8, 5, 23)
    lengths = np.array([8, 5], np.int32)
    want = jax_bxp.beam_search_exact_pallas_batch(
        x, lengths, np.float32(0.0), beam_size=5, collapse_repeats=True,
        max_nodes=168, interpret=True,
    )
    assert_same(want, run_port(x, lengths, 0.0, 5, True, 168))
    c, init = crf_batch(2, 6, 4, 24)
    want = jax_bxp.crf_beam_search_exact_pallas_batch(
        c, init, lengths - 2, np.float32(0.0), beam_size=5, max_nodes=128, interpret=True
    )
    got = port_crf.crf_beam_search_device_batch(
        torch.from_numpy(c), torch.from_numpy(init), torch.from_numpy(lengths - 2), 0.0,
        beam_size=5, max_nodes=128,
    )
    assert_same(want, {k: v.numpy() for k, v in got.items()})


def test_kernel_wrappers_on_cpu_run_plain_versions():
    x = rand_batch(3, 20, 5, 25)
    lengths = torch.tensor([20, 9, 20], dtype=torch.int32)
    before = dict(beam_exact_cuda.launches)
    got = beam_exact_cuda.beam_search_exact_kernel_batch(
        torch.from_numpy(x), lengths, 0.1, beam_size=5
    )
    want = run_port(x, lengths.numpy(), 0.1, 5, True, port_beam.default_max_nodes(20, 5, 4))
    assert_same(want, {k: v.numpy() for k, v in got.items()})
    c, init = crf_batch(3, 20, 9, 26, A1=4)
    got = beam_exact_cuda.crf_beam_search_exact_kernel_batch(
        torch.from_numpy(c), torch.from_numpy(init), lengths, 0.0, beam_size=5, max_nodes=30
    )
    assert_same(check_crf(c, init, lengths.numpy(), 0.0, N=30), got)
    assert beam_exact_cuda.launches == before  # nothing launched on the CPU


@pytest.mark.parametrize(
    "kwargs, exc",
    [
        (dict(beam_size=17), ValueError),  # past the kernel's beam bound
        (dict(A1=9), ValueError),  # past the kernel's label bound
        (dict(max_nodes=0), ValueError),
        (dict(max_nodes=2**31), ValueError),  # node ids are int32
        (dict(dtype=torch.float64), TypeError),
        (dict(crf=True, beam_size=17), ValueError),
        (dict(crf=True, A1=9), ValueError),
    ],
)
def test_kernel_wrappers_refuse_out_of_bounds(kwargs, exc):
    A1, K = kwargs.get("A1", 5), kwargs.get("beam_size", 5)
    lengths = torch.full((2,), 6, dtype=torch.int32)
    with pytest.raises(exc):
        if kwargs.get("crf"):
            c, init = crf_batch(2, 6, 4, 0, A1=A1)
            beam_exact_cuda.crf_beam_search_exact_kernel_batch(
                torch.from_numpy(c), torch.from_numpy(init), lengths, 0.0, beam_size=K
            )
        else:
            x = torch.from_numpy(rand_batch(2, 6, A1, 0)).to(kwargs.get("dtype", torch.float32))
            beam_exact_cuda.beam_search_exact_kernel_batch(
                x, lengths, 0.0, beam_size=K, max_nodes=kwargs.get("max_nodes")
            )


def test_kernel_wrappers_take_the_widest_instance():
    # just fits: beam 16 over A+1 = 8 (the <16, 7> instance), plain on the CPU
    x = rand_batch(2, 10, 8, 27)
    lengths = torch.full((2,), 10, dtype=torch.int32)
    got = beam_exact_cuda.beam_search_exact_kernel_batch(
        torch.from_numpy(x), lengths, 0.0, beam_size=16
    )
    assert list(got["err"]) == [0, 0]
    c, init = crf_batch(2, 10, 4, 28, A1=8)
    got = beam_exact_cuda.crf_beam_search_exact_kernel_batch(
        torch.from_numpy(c), torch.from_numpy(init), lengths, 0.0, beam_size=16
    )
    assert list(got["err"]) == [0, 0]


@pytest.mark.parametrize("rpb, ok", [(1, True), (4, True), (8, True), (0, False), (9, False),
                                     (2.0, False), (True, False)])
def test_reads_per_block_bounds(rpb, ok):
    """The warp-per-read kernel takes 1..8 reads (warps) a block; the
    wrappers check that on every device, then run the plain version here."""
    x = torch.from_numpy(rand_batch(2, 8, 5, 29))
    lengths = torch.full((2,), 8, dtype=torch.int32)
    c, init = crf_batch(2, 8, 4, 30)
    calls = [
        lambda: beam_exact_cuda.beam_search_exact_kernel_batch(
            x, lengths, 0.0, beam_size=5, reads_per_block=rpb),
        lambda: beam_exact_cuda.crf_beam_search_exact_kernel_batch(
            torch.from_numpy(c), torch.from_numpy(init), lengths, 0.0, beam_size=5,
            reads_per_block=rpb),
    ]
    for call in calls:
        if ok:
            assert call()["err"].tolist() == [0, 0]
        else:
            with pytest.raises(ValueError, match="reads_per_block"):
                call()


def test_scratch_stride_layout_and_overflow_check():
    """One read's tree: N int4 records then the (N+1)*A child table, rounded
    up to whole records (16-byte aligned reads); the byte offsets of B such
    slabs must fit int64, to the read."""
    src = open(os.path.join(_build.CSRC, "exact_beam_kernel.cu")).read()
    assert f"constexpr int kRecWords = {beam_exact_cuda.REC_WORDS};" in src
    assert f"constexpr int kMaxReadsPerBlock = {beam_exact_cuda.MAX_READS_PER_BLOCK};" in src
    for N, A in ((1, 1), (7, 4), (20008, 4), (10, 7), (2**31 - 2, 7)):
        stride = beam_exact_cuda.scratch_stride(N, A)
        need = 4 * N + (N + 1) * A
        assert stride % 4 == 0 and need <= stride < need + 4
    N, A = 2**31 - 2, 7
    b_max = (2**63 - 1) // (4 * beam_exact_cuda.scratch_stride(N, A))
    beam_exact_cuda._bounds(b_max, 10, 16, A, N)  # just fits
    with pytest.raises(ValueError, match="int64"):
        beam_exact_cuda._bounds(b_max + 1, 10, 16, A, N)


def test_exact_probe_quick_runs_on_the_cpu():
    from fast_ctc_decode_tpu_torch.tools import exact_probe

    rows = exact_probe.main(["--quick", "--device", "cpu"])
    got = [(r["max_nodes"], r["reads_per_block"]) for _, r in rows]
    worst = port_beam.default_max_nodes(50, 5, 4)
    assert got == [(N, 4) for N in exact_probe.BUDGETS] + [(worst, r) for r in (1, 2, 4, 8)]
    assert all(r["max_err"] in (0, errors.NODE_OVERFLOW) and r["ms"] > 0 for _, r in rows)
    assert all("host clock" in line for line, _ in rows)  # never a device time


def test_kernel_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    # a stand-in nvcc records its command lines and writes its -o output
    bindir = tmp_path / "bin"
    bindir.mkdir()
    calls = tmp_path / "calls.txt"
    fake = bindir / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then touch "$2"; fi; shift; done\n'
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    res = _build.build()
    assert os.path.exists(res.path) and res.seconds > 0
    lines = calls.read_text().splitlines()
    srcs = sorted(os.path.basename(p) for p in _build._sources()[0])
    assert {"exact_beam_kernel.cu", "crf_beam_kernel.cu", "beam_kernel.cu"} <= set(srcs)
    compiled = sorted(os.path.basename(l.split()[-1]) for l in lines if " -c " in l)
    assert compiled == srcs  # one nvcc per source
    assert "-fmad=false" in lines[0] and "--use_fast_math" not in " ".join(lines)
    assert "-shared" in lines[-1] and " -c " not in lines[-1]  # then one link
    assert _build.build().seconds == 0.0  # cached by content


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        beam_exact_cuda._build.build()
