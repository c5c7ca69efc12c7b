"""``BENCHMARK.json``: its shape, and every cell resolving to its files by
name; a cell, a configuration, a traffic mix and a metric added as new files
and entries alone."""

import hashlib
import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from ctcbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load_benchmark()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["ctcbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ctcbench/") and NAME.match(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = spec.resolve(workload)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                       if w["name"] == workload)
    driver = cell.driver()
    assert hasattr(driver, "Driver") and hasattr(driver, "control_jobs")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]).read)


def test_roofline_metrics_follow_the_contract_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def _digest(root):
    h = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                h[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return h


def test_a_cell_is_added_by_new_files_and_entries_alone(tmp_path):
    """A throwaway configuration, traffic mix and metric, added beside a copy
    of the benchmark: no file that is there changes, and the new cell
    resolves and reads its metric."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "ctcbench"), root / "ctcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digest(root / "ctcbench")

    cfg = json.load(open(root / "ctcbench/configs/ctc_nacgt_b5.json"))
    cfg["name"], cfg["decode"]["beam_size"] = "ctc_nacgt_b8", 8
    (root / "ctcbench/configs/ctc_nacgt_b8.json").write_text(json.dumps(cfg))
    (root / "ctcbench/traffic/stream_small.json").write_text(json.dumps(
        {"kind": "stream", "pool_reads": 64, "call_reads": 16, "keep_per_call": 1,
         "check_reads": 4}))
    (root / "ctcbench/metrics/window_len.py").write_text(
        "def read(name, view):\n    return view.window_s\n")
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["configs"].append({"name": "ctc_nacgt_b8", "source": "https://example.org",
                             "file": "ctcbench/configs/ctc_nacgt_b8.json", "reduced": [],
                             "why": "throwaway"})
    bench["workloads"].append({"name": "ctc.small", "config": "ctc_nacgt_b8",
                               "traffic": "stream_small", "chips": 1, "why": "throwaway"})
    next(m for m in bench["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append(
        "ctc.small")
    bench["per_layer"].append({"name": "window_len.small", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "pipeline",
                               "moves": "frames_per_s", "workloads": ["ctc.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1]);"
        "from ctcbench import spec;"
        "from ctcbench.harness import LayerView;"
        "c = spec.resolve('ctc.small', root=sys.argv[1]);"
        "assert c.config['decode']['beam_size'] == 8 and c.traffic['pool_reads'] == 64;"
        "assert c.driver().__name__ == 'ctcbench.drivers.stream';"
        "names = [m['name'] for m in c.per_layer];"
        "assert 'window_len.small' in names and 'frames_per_s' in [m['name'] for m in c.end_to_end];"
        "v = LayerView(2.5, {}, {}, {}, {}, None);"
        "print(json.dumps({n: spec.metric_reader(n).read(n, v) for n in names}))"
    )
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True,
                         text=True, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["window_len.small"] == 2.5
    after = _digest(root / "ctcbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_driver_modules_share_one_interface():
    for kind in ("stream", "pairs"):
        mod = importlib.import_module(f"ctcbench.drivers.{kind}")
        for method in ("setup", "window", "counters", "release", "check", "close"):
            assert callable(getattr(mod.Driver, method))
        assert isinstance(mod.Driver.roles, dict)
