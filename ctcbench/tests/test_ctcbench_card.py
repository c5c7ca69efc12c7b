"""On the card: every cell of ``BENCHMARK.json`` runs briefly through the
command the check runs, and comes out correct with its metrics."""

import json
import subprocess
import sys

import pytest

from ctcbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "-m", "ctcbench.run", "--workload", workload, "--seed",
         str(2**31 + 101), "--seconds", "2", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    cell = spec.resolve(workload)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= names and result["metrics"]
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    else:
        assert set(result["metrics"]) == names
