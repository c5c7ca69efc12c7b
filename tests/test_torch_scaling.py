"""``fast_ctc_decode_tpu_torch.tools.scaling_bench``, the port's
counterpart of ``tools/scaling_bench.py``, checked on the CPU: ``hosts``
over Gloo worker processes, ``overhead`` in a process group of one, the
rule that a run needing more cards than the machine has is reported and not
made, and the JAX tool's ``devices`` mode, which has no counterpart.
"""

import json

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu.ops import beam_fast as jax_beam_fast
from fast_ctc_decode_tpu_torch.tools import scaling_bench

torch.set_num_threads(1)

FIELDS = ("labels_rev", "times_rev", "count", "err")


def test_hosts_two_processes_over_gloo(capsys):
    rows = scaling_bench.main(["hosts", "--nproc", "2", "--device", "cpu",
                               "--reads-per-host", "4", "--T", "30"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows and [r["n"] for r in rows] == [1, 2]
    for row in rows:
        assert row["mode"] == "hosts" and row["reads"] == 4 * row["n"]
        # every worker saw the all-reduced totals [B, 0] (the tool checks they agree)
        assert row["totals"] == [row["reads"], 0]
        assert row["reads_per_s"] > 0 and row["device"] == "cpu" and "unmeasured" not in row
    assert rows[0]["efficiency"] == 1.0 and rows[1]["efficiency"] > 0


def test_overhead_gives_two_equal_dicts():
    row, plain, shard = scaling_bench.bench_overhead(8, 30, reps=1, engine="fast", device="cpu")
    assert not torch.distributed.is_initialized()  # the tool's own group is gone
    assert (row["mode"], row["n"], row["reads"], row["backend"]) == ("overhead", 1, 8, "gloo")
    assert row["reads_per_s_plain"] > 0 and row["reads_per_s_sharded_psum"] > 0
    assert row["efficiency"] == row["reads_per_s_sharded_psum"] / row["reads_per_s_plain"]
    probs = scaling_bench._rand_reads(8, 30, 5)
    want = jax_beam_fast.beam_search_fast_batch(
        probs, np.full((8,), 30, np.int32), np.float32(0.1), beam_size=5, collapse_repeats=True)
    for f in FIELDS:
        assert np.array_equal(plain[f], shard[f]), f
        assert np.array_equal(plain[f], np.asarray(want[f])), f


def test_hosts_past_the_cards_is_not_run(monkeypatch, capsys):
    # a machine with one card: n=1 runs, n=2 is reported unmeasured and no
    # two ranks share the card
    made = []

    def fake_workers(n, reads_per_host, T, device):
        made.append((n, device.type))
        return [{"rank": 0, "dt": 0.5, "B": reads_per_host, "totals": [reads_per_host, 0],
                 "launches": {"beam_warp": 4}}]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(scaling_bench, "card_info", lambda dev: ("a card", "700.00 W"))
    monkeypatch.setattr(scaling_bench, "_run_workers", fake_workers)
    rows = scaling_bench.main(["hosts", "--nproc", "2", "--reads-per-host", "64"])
    assert made == [(1, "cuda")]
    assert rows[0]["reads_per_s"] == 128.0 and rows[0]["launches"] == {"beam_warp": 4}
    assert rows[1] == {"mode": "hosts", "n": 2, "reads": 128, "reads_per_s": None,
                       "efficiency": None, "unmeasured": "needs 2 CUDA cards, found 1"}
    assert len(capsys.readouterr().out.splitlines()) == 2


def test_devices_mode_is_not_offered(capsys):
    with pytest.raises(SystemExit):
        scaling_bench.main(["devices", "--device", "cpu"])
    assert "invalid choice: 'devices'" in capsys.readouterr().err
