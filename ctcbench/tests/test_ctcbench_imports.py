"""No file of the benchmark imports JAX or the JAX package (top-level names
compared whole); the reference imports nothing of the program, its tests or
JAX; a run without a card fails and prints no result."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from ctcbench import run, spec

HERE = os.path.join(spec.ROOT, "ctcbench")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, 0) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "", node.level)


@pytest.mark.parametrize("modules, bad", [
    (["fast_ctc_decode_tpu_torch", "fast_ctc_decode_tpu_torch.serve", "numpy"], []),
    (["fast_ctc_decode_tpu", "fast_ctc_decode_tpu_torch"], ["fast_ctc_decode_tpu"]),
    (["fast_ctc_decode_tpu.ops.beam"], ["fast_ctc_decode_tpu"]),
    (["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"], ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, bad):
    assert run.forbidden_modules(modules) == bad


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True)
    assert len(files) > 20
    for path in files:
        for name, level in _imports(path):
            if level == 0:
                assert name.split(".")[0] not in run.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        for name, level in _imports(path):
            assert level == 1 or name in ("__future__", "numpy"), (path, name)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "ctcbench.run", "--workload", "ctc.stream", "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert "CUDA card" in out.stderr


def test_a_run_loads_no_jax(tmp_path):
    """The modules a tiny run loads (the port, the drivers, the reference's
    workers) hold no forbidden top-level name."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from ctcbench.tests import tiny; from ctcbench import run;"
            "r, c = tiny.run('ctc.stream'); assert r['correct'];"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, spec.ROOT], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
