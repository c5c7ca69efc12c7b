"""The precision control of a CRF cell (``ctcbench.control``'s readings for
a cell whose reference ``checks.run_all``'s workers do not know): the
reference put in the program's place and computed in bfloat16, the nearest
precision below the float32 that the configuration states, and a fault
planted in the float32 reference's answers (a base of every answer
changed), each compared with the float32 reference by the cell's own
numbers.  Both have to come out as not correct.

    python3 -m ctcbench.control_crf --workload crf.stream --seeds 1 2

runs it at the cell's own size (the sample a run checks, drawn from the
pool of each seed, made on the card where there is one) and prints each
seed's numbers as one JSON line.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json


def _alter_base(answers):
    """The first base of every answer changed."""
    return [(status, ("C" if seq[:1] == "A" else "A") + seq[1:], first, latest)
            for status, seq, first, latest in answers]


def readings(cell, seed, device):
    """The cell's compared numbers of the bfloat16 reference and of the
    planted fault: ``{"checked": n, name: {number: value}}``."""
    from . import checks
    from .drivers.crf_chunks import run_reference

    _, jobs = cell.driver().control_jobs(cell, seed, device)
    want = run_reference([(*j, "float32") for j in jobs])
    got = run_reference([(*j, "bfloat16") for j in jobs])
    out = {"checked": len(jobs)}
    for name, answers in (("bfloat16", got), ("alter_base", _alter_base(want))):
        n = checks.compare_beam([(seq, latest, status) for status, seq, _, latest in answers],
                                want)
        out[name] = {"status_mismatch": n["status"], "seq_mismatch": n["seq"],
                     "path_mismatch": n["path"]}
    return out


def main(argv=None):
    import torch

    from . import spec

    p = argparse.ArgumentParser(prog="python3 -m ctcbench.control_crf")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.resolve(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        out = readings(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, **out}), flush=True)


if __name__ == "__main__":
    main()
