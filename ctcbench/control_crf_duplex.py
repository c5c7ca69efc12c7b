"""The precision control of the CRF duplex cell (``ctcbench.control``'s
readings for a cell whose reference ``checks.run_all``'s workers do not
know): the reference put in the program's place and computed in bfloat16,
the nearest precision below the float32 that the configuration states, and
two faults planted in the float32 reference's answers (half of them blanked,
empty with status 0; a base of every one changed), each compared with the
float32 reference by the cell's own checks (``checks.duplex_checks``, as
``drivers/crf_pairs.py``'s check calls them).  Each has to come out as not
correct.

    python3 -m ctcbench.control_crf_duplex --workload crf_duplex.pairs --seeds 1 2

runs it at the cell's own size (the sample a run checks, drawn from the
pool of each seed, made on the card where there is one) and prints each
seed's numbers as one JSON line.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import time

from .control import _alter_base, _blank_half


def readings(cell, seed, device):
    """The cell's compared numbers of the bfloat16 reference and of the
    planted faults, and whether the checks pass on them: ``{"checked": n,
    "seconds": s, name: {number: value, "correct": bool}}``."""
    from . import checks
    from .drivers.crf_pairs import run_reference

    _, jobs = cell.driver().control_jobs(cell, seed, device)
    t0 = time.perf_counter()
    want = run_reference([(*j, "float32") for j in jobs])
    got = run_reference([(*j, "bfloat16") for j in jobs])
    out = {"checked": len(jobs), "seconds": time.perf_counter() - t0}
    for name, answers in (("bfloat16", got), ("blank_half", _blank_half(want, seed)),
                          ("alter_base", _alter_base(want, seed))):
        got = [(q, s) for s, q in answers]
        _, _, _, bases = checks.duplex_numbers(got, want)
        found = checks.duplex_checks(got, want, 0)
        out[name] = {**{c.name: c.value for c in found}, "bases": bases,
                     "correct": all(c.ok for c in found)}
    return out


def main(argv=None):
    import torch

    from . import spec

    p = argparse.ArgumentParser(prog="python3 -m ctcbench.control_crf_duplex")
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
