"""A run with the timed path broken underneath comes out not correct.

Each tiny cell runs on the CPU (the harness's look for a card skipped) with
its entry point replaced by one that is wrong in one way the cell can be:
an answer altered where it is produced, half of the batch left out (its
answers dropped, or kept in place but blank with status 0), or the previous
call's answers returned again (a step that leaves its state unchanged).  The sound run of each cell is correct.  There is no exchange
between chips: every cell runs on one."""

import pytest

import fast_ctc_decode_tpu_torch as port

from . import tiny


def _alter(res):
    """One base of every answer changed (a fault where answers are made)."""
    return [(("C" if r[0][:1] == "A" else "A") + r[0][1:],) + tuple(r[1:]) for r in res]


def _half(res):
    return list(res)[: len(res) // 2]


def _blank(res):
    """The second half of the batch answered with empty sequences and paths,
    status 0: as many answers as asked for, half of them never decoded."""
    res = list(res)
    h = len(res) // 2
    return res[:h] + [("",) + tuple([] for _ in r[1:-1]) + (0,) for r in res[h:]]


class _Stale:
    def __init__(self):
        self.last = None

    def __call__(self, res):
        out, self.last = (self.last if self.last is not None else res), res
        return out


def _wrap(fault):
    if fault == "stale":
        return _Stale()
    return {"altered": _alter, "half": _half, "blank": _blank}[fault]


def _patch_entry(monkeypatch, name, fault):
    fix = _wrap(fault)
    attr = "decode_many" if name == "ctc.stream" else "decode_many_duplex"
    real = getattr(port, attr)
    monkeypatch.setattr(port, attr, lambda *a, **k: fix(real(*a, **k)))


CELLS = ["ctc.stream", "duplex.pairs"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, checks = tiny.run(name)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


FAULTS = [(n, f) for n in CELLS for f in ("altered", "half", "blank", "stale")]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _patch_entry(monkeypatch, name, fault)
    # long enough that most answers kept for the check come after the first
    # call, whose stale answers are the warm-up's, hence right
    result, checks = tiny.run(name, seconds=6.0 if fault == "stale" else 1.0)
    assert not result["correct"], checks
