"""Tiny copies of the benchmark's cells for the CPU tests."""

import time

import torch

from ctcbench import spec
from ctcbench.harness import execute

#: every answer kept is checked, so a fault in any part of a batch shows
TRAFFIC = {
    "ctc.stream": {"pool_reads": 24, "call_reads": 8, "check_reads": 48},
    "duplex.pairs": {"pool_pairs": 6, "call_pairs": 2, "check_pairs": 48, "keep_per_call": 1},
}
LENGTHS = {"median": 40, "sigma": 0.5, "min": 12, "max": 120}


def cell(name):
    c = spec.resolve(name)
    c.traffic.update(TRAFFIC[name])
    c.config["lengths"] = dict(LENGTHS)
    return c


def run(name, seed=2**31 + 11, seconds=0.5, trace=False):
    """One run of the tiny cell on the CPU: (result, checks)."""
    return execute(cell(name), seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                   lambda msg: None)
