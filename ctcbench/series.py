"""Run one cell several times, each run a process of its own as the check
runs it, and report each metric's median and spread.

    python3 -m ctcbench.series --workload <cell> --seeds 11 12 13 --seconds 20 \
        [--trace 0|1] [--out chiprun_out/series.jsonl]

Each run's result line (with its seed, exit code and the end of its
standard error) is appended to ``--out``.  The spread of a metric is the
distance between the first and third quartiles of its runs
(``statistics.quantiles(values, n=4)``) over their median, as the bounds
in ``BENCHMARK.json`` are set from.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values):
    """(median, interquartile range over the median) of ``values``."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m ctcbench.series")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    values = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", f"{__package__}.run", "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)],
            cwd=root, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = run.stdout.strip().splitlines()
        result = json.loads(lines[-1]) if run.returncode == 0 and lines else None
        row = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": run.returncode,
               "wall_s": wall, "result": result, "stderr_tail": run.stderr[-3000:]}
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        brief = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": run.returncode, "wall_s": round(wall, 1),
                          "correct": result and result["correct"], **brief}), flush=True)
        if result is None:
            print(run.stderr[-2000:], file=sys.stderr, flush=True)
            continue
        for k, v in result["metrics"].items():
            values.setdefault(k, []).append(v["value"])
    for k, vs in values.items():
        med, s = spread(vs)
        print(json.dumps({"metric": k, "n": len(vs), "median": med, "spread": s,
                          "values": vs}), flush=True)


if __name__ == "__main__":
    main()
