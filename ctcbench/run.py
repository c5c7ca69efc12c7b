"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m ctcbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, and prints no result, when there is no CUDA card (or fewer
than the cell asks for), when the run fails, or when JAX or the JAX package
is loaded once the window has closed.  The numbers that decide ``correct``
are the last lines on standard error and the last key of the result.

Only the standard library is imported at the top: worker processes started
by ``spawn`` import this module again.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

#: top-level module names that no run may load (compared whole: the port's
#: ``fast_ctc_decode_tpu_torch`` is not ``fast_ctc_decode_tpu``)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fast_ctc_decode_tpu"})

#: the program's build caches, at a fixed path inside the checkout (the
#: kernels already build under ``fast_ctc_decode_tpu_torch/_build``)
CACHE_DIR = ".ctcbench_cache"


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default: loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def _log(msg):
    print(f"[ctcbench] {msg}", file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m ctcbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from . import spec

    os.environ["XDG_CACHE_HOME"] = os.path.join(spec.ROOT, CACHE_DIR)
    cell = spec.resolve(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f"{cell.name} needs {cell.chips} CUDA card(s), found {n}: no result")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    from .harness import execute

    result, checks = execute(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                             _log)
    from .cardinfo import card_info

    _log(f"card: {card_info(device)}")
    bad = forbidden_modules()
    if bad:
        _log(f"forbidden modules loaded: {bad}: no result")
        return 3
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        _log(f"check {c.name} {c.value} limit {c.limit}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
