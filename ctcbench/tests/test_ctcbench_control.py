"""The bfloat16 control of each cell comes out as not correct, and so do
the faults planted in the duplex reference's answers: the cell's own
numbers against its own limits, at a size the CPU holds (reads of ~1,500
frames, pairs of ~700).  ``python3 -m ctcbench.control`` reads the same at
the cell's own size on the card."""

import pytest
import torch

from ctcbench import checks, control

from . import tiny

SIZES = {
    "ctc.stream": ({"median": 1500, "sigma": 0.3},
                   {"pool_reads": 16, "call_reads": 8, "check_reads": 8}),
    "duplex.pairs": ({"median": 700, "sigma": 0.3},
                     {"pool_pairs": 8, "call_pairs": 4, "check_pairs": 6, "keep_per_call": 2}),
}


def _cell(name):
    c = tiny.cell(name)
    c.config["lengths"], traffic = SIZES[name]
    c.traffic.update(traffic)
    return c


def _duplex_fails(n):
    return (n["status_mismatch"] > 0 or n["differing_pairs"] > checks.DIFFERING_PAIRS_LIMIT
            or n["edit_share"] > checks.EDIT_SHARE_LIMIT)


@pytest.mark.parametrize("seed", [1, 2])
def test_beam_control_is_not_correct(seed):
    r = control.readings(_cell("ctc.stream"), seed, torch.device("cpu"))
    assert r["checked"] == 8
    assert r["status_mismatch"] + r["seq_mismatch"] + r["path_mismatch"] > 0, r


@pytest.mark.parametrize("seed", [1, 2])
def test_duplex_control_and_planted_faults_are_not_correct(seed):
    r = control.readings(_cell("duplex.pairs"), seed, torch.device("cpu"))
    assert r["checked"] == 6
    for name in ("bfloat16", "blank_half", "alter_base"):
        assert _duplex_fails(r[name]), (name, r)
