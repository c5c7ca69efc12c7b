"""The precision control of a cell: the reference put in the program's place
and computed in bfloat16, the nearest precision below the float32 that the
configurations state, compared with the float32 reference by the cell's own
numbers.  It has to come out as not correct.

    python3 -m ctcbench.control --workload <cell> --seeds 1 2 3

runs it at the cell's own size (the sample a run checks, drawn from the
pool of each seed) and prints each seed's numbers as one JSON line.  For a
duplex cell the line also holds the numbers of two faults planted in the
float32 reference's answers: half of them blanked (empty, status 0) and a
base of every one changed.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _blank_half(answers, seed):
    """Half of the answers, drawn from ``seed``, made empty with status 0."""
    rng = np.random.default_rng([seed, 0xB1A4])
    gone = set(rng.choice(len(answers), size=len(answers) // 2, replace=False).tolist())
    return [(0, "") if i in gone else a for i, a in enumerate(answers)]


def _alter_base(answers, seed):
    """The first base of every answer changed."""
    return [(s, ("C" if q[:1] == "A" else "A") + q[1:]) for s, q in answers]


def readings(cell, seed, device):
    """The cell's compared numbers with the bfloat16 reference as the
    program, and for a duplex cell also with two faults planted in the
    float32 reference's answers: ``{name: value}``."""
    from . import checks

    fn, jobs = cell.driver().control_jobs(cell, seed, device)
    sizes = [len(j[0]) for j in jobs]
    want = checks.run_all(fn, [(*j, "float32") for j in jobs], sizes)
    got = checks.run_all(fn, [(*j, "bfloat16") for j in jobs], sizes)
    if fn is checks.ref_duplex:
        out = {"checked": len(jobs)}
        for name, answers in (("bfloat16", got), ("blank_half", _blank_half(want, seed)),
                              ("alter_base", _alter_base(want, seed))):
            status, differing, edits, bases = checks.duplex_numbers(
                [(q, s) for s, q in answers], want)
            out[name] = {"status_mismatch": status, "differing_pairs": differing,
                         "edit_share": edits / max(bases, 1), "bases": bases}
        return out
    n = checks.compare_beam([(seq, latest, status) for status, seq, _, latest in got], want)
    return {"status_mismatch": n["status"], "seq_mismatch": n["seq"],
            "path_mismatch": n["path"], "checked": len(jobs)}


def main(argv=None):
    import torch

    from . import spec

    p = argparse.ArgumentParser(prog="python3 -m ctcbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.resolve(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        out = readings(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": "bfloat16", **out}),
              flush=True)


if __name__ == "__main__":
    main()
