"""The port's measurement tools against the JAX package's: ``bench_torch.py``
(``bench.py``) and ``fast_ctc_decode_tpu_torch.tools.benchmark``
(``tests/benchmark.py``), with the helpers the new tools share
(``tools/workloads.py``), each new module's default device, and a check
that none of them imports jax.

Everything runs on the CPU (``device="cpu"`` / ``BENCH_DEVICE=cpu``), where
the tools check themselves and measure nothing.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from fast_ctc_decode_tpu.ops import beam_fast as jax_beam_fast
from fast_ctc_decode_tpu.ops import duplex_fast as jax_duplex_fast
from fast_ctc_decode_tpu_torch.tools import bench_exact_duplex, scaling_bench, workloads
from fast_ctc_decode_tpu_torch.tools import benchmark as port_benchmark

import duplex_helpers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("labels_rev", "times_rev", "count", "err")
CPU_ENV = {"BENCH_DEVICE": "cpu", "BENCH_ENGINE": "fast", "BENCH_BATCH": "16",
           "BENCH_T": "60", "BENCH_ITERS": "1"}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# tests/benchmark.py imports jax only inside main: its helpers load alone
jax_benchmark = _load("jax_tests_benchmark", "tests/benchmark.py")


def test_make_inputs_equal_bench_py():
    B, T = 9, 37
    # bench.py:32-34
    rng = np.random.RandomState(42)
    probs = rng.rand(B, T, 5).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    lengths = np.full((B,), T, np.int32)
    got_p, got_l = bench_torch.make_inputs(B, T, 42)
    assert got_p.dtype == probs.dtype and got_p.tobytes() == probs.tobytes()
    assert got_l.dtype == lengths.dtype and np.array_equal(got_l, lengths)


@pytest.fixture(scope="module")
def fast_run():
    probs, lengths = bench_torch.make_inputs(16, 60, 42)
    return probs, lengths, bench_torch.run("fast", "cpu", probs, lengths)


def test_fast_run_equals_jax_and_passes_the_gate(fast_run):
    probs, lengths, out = fast_run
    want = jax_beam_fast.beam_search_fast_batch(
        probs, lengths, np.float32(0.1), beam_size=5, collapse_repeats=True)
    for f in FIELDS:
        w = np.asarray(want[f])
        assert out[f].dtype == w.dtype and np.array_equal(out[f], w), f
    bench_torch.gate(probs, out, 8)


@pytest.mark.parametrize("fault", ["label", "status"])
def test_gate_fails_on_a_wrong_read(fast_run, fault):
    probs, _, out = fast_run
    bad = {k: v.copy() for k, v in out.items()}
    i = 15  # the last read, which the gate samples
    if fault == "label":
        bad["labels_rev"][i, 0] = (bad["labels_rev"][i, 0] + 1) % 4
    else:
        bad["err"][3] = 1
    with pytest.raises(AssertionError):
        bench_torch.gate(probs, bad, 8)


def test_main_prints_one_json_line_with_a_null_baseline(capsys):
    row = bench_torch.main(dict(CPU_ENV))
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == row
    assert {"metric", "value", "unit", "vs_baseline"} <= last.keys()
    assert last["metric"] == "beam_search_reads_per_sec_per_chip" and last["unit"] == "reads/s"
    assert last["vs_baseline"] is None and last["value"] > 0
    assert (last["device"], last["engine"], last["B"], last["T"]) == ("cpu", "fast", 16, 60)
    assert last["kernels_ms"] is None and last["decode_ms"] > 0


def test_cuda_engine_needs_the_card():
    probs, lengths = bench_torch.make_inputs(2, 5)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        bench_torch.run("cuda", "cpu", probs, lengths)
    with pytest.raises(ValueError, match="BENCH_ENGINE"):
        bench_torch.main({"BENCH_DEVICE": "cpu", "BENCH_ENGINE": "pallas"})


TINY = ["--T", "20", "--reads-per-dev", "4", "--reads-per-host", "2"]
DEFAULT_DEVICE = {
    "bench_torch": lambda: bench_torch.main({"BENCH_ENGINE": "fast", "BENCH_BATCH": "4",
                                             "BENCH_T": "10"}),
    "benchmark": lambda: port_benchmark.main(["--quick"]),
    "bench_exact_duplex": lambda: bench_exact_duplex.main(["2"]),
    "scaling_bench hosts": lambda: scaling_bench.main(["hosts", "--nproc", "1", *TINY]),
    "scaling_bench overhead": lambda: scaling_bench.main(["overhead", *TINY]),
    "basecall_demo_torch": lambda: _load("demo_torch", "examples/basecall_demo_torch.py").run(
        4, 30),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE))
def test_new_modules_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        DEFAULT_DEVICE[name]()


def test_benchmark_cpu_prints_every_non_kernel_row(capsys):
    rows = port_benchmark.main(["--quick", "--full", "--device", "cpu"])
    out = capsys.readouterr().out
    # the rows tests/benchmark.py prints off the TPU, at its --quick shapes;
    # its XLA "fast" duplex engine is the port's plain slot engine
    W = jax_duplex_fast._prep_envelope_fast(jax_benchmark.diag_env(60, 60, 8), 60).W
    want = [
        "viterbi python argmax+groupby",
        "viterbi_search (this repo)",
        "beam_search single read (exact engine)",
        "beam_search single read (fast engine)",
        "1D beam fast x64",
        "CRF beam fast x32 (S=8)",
        f"duplex banded fast(plain) x16 (W={W})",
        "duplex banded exact single pair",
        "duplex banded exact batched x16",
    ]
    assert [r[0] for r in rows] == want
    assert not any(r[3] for r in rows)
    for name in want:
        assert name in out
    for word in ("cuda", "kernel"):
        assert not any(word in line for line in out.splitlines()[1:]), out
    assert all(np.isfinite(r[1]) and r[1] > 0 for r in rows)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_helpers_equal_the_jax_benchmarks(seed):
    x = workloads.norm_batch(3, 17, 5, seed)
    assert x.tobytes() == jax_benchmark.norm_batch(3, 17, 5, seed).tobytes()
    for T1, T2, w in ((500, 500, 40), (60, 60, 8), (37, 91, 3 + seed), (120, 45, seed)):
        env = workloads.diag_env(T1, T2, w)
        assert env.dtype == np.int64
        assert np.array_equal(env, jax_benchmark.diag_env(T1, T2, w))
        assert np.array_equal(env, duplex_helpers.diag_env(T1, T2, w))

    # the CRF root-gap loop of tests/benchmark.py (--full, the CRF duplex row)
    rng = np.random.RandomState(seed)
    Bx, Sx, A1, Wr = 4, 16, 5, 23
    c2 = rng.rand(Bx, 30, Sx, A1).astype(np.float32)
    c2 /= c2.sum(-1, keepdims=True)
    cl2 = np.log(c2).astype(np.float32)
    crg = np.zeros((Bx, Wr), np.float32)
    st = np.zeros((Bx,), np.int64)
    cur = np.zeros((Bx,), np.float32)
    for i in range(Wr - 1):
        cur = cur + cl2[np.arange(Bx), i, st, 0]
        crg[:, i + 1] = cur
        st = (st * (A1 - 1)) % Sx
    assert workloads.crf_root_gaps(cl2, Wr, Sx, A1).tobytes() == crg.tobytes()


def test_new_modules_and_chip_smoke_import_no_jax():
    code = (
        "import sys, importlib.util\n"
        "import bench_torch, chip_smoke\n"
        "from fast_ctc_decode_tpu_torch.tools import benchmark, bench_exact_duplex\n"
        "from fast_ctc_decode_tpu_torch.tools import scaling_bench, workloads\n"
        "spec = importlib.util.spec_from_file_location('demo', 'examples/basecall_demo_torch.py')\n"
        "demo = importlib.util.module_from_spec(spec); spec.loader.exec_module(demo)\n"
        "bench_torch.main({'BENCH_DEVICE': 'cpu', 'BENCH_ENGINE': 'fast', 'BENCH_BATCH': '4',"
        " 'BENCH_T': '12', 'BENCH_ITERS': '1', 'BENCH_PARITY_READS': '2'})\n"
        "benchmark.main(['--quick', '--device', 'cpu'])\n"
        "inp = bench_exact_duplex.make_inputs(2, T=12, w=3)\n"
        "assert (bench_exact_duplex.decode(inp, 'cpu')()['err'] == 0).all()\n"
        "scaling_bench.main(['overhead', '--device', 'cpu', '--reads-per-dev', '2', '--T', '12'])\n"
        "demo.run(4, 30, 'cpu')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'fast_ctc_decode_tpu')]\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LEAKED []" in proc.stdout
