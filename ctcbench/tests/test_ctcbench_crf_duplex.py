"""The CRF duplex cell ``crf_duplex.pairs``: its entries, generator, work
count and readers, its run on the CPU at a tiny size (sound, and broken
underneath), its reference against the repository's oracle, and its
precision control.

Tiny copies of the cell keep every width (1,024 states, 5 labels, the
envelope's half-width) and cut the reads to tens of frames and the pool to
a few pairs."""

import time

import numpy as np
import pytest
import torch

from ctcbench import control_crf_duplex, roofline, roofline_crf_duplex, spec
from ctcbench.drivers import crf_pairs
from ctcbench.drivers.common import generator
from ctcbench.gen import crf_pairs as gen
from ctcbench.gen.posteriors import frame_rows
from ctcbench.harness import LayerView, execute
from ctcbench.reference.crf_duplex import search
from ctcbench.trace import TraceSummary

from .test_ctcbench_faults import _wrap
from .test_ctcbench_spec import BENCH

import fast_ctc_decode_tpu_torch as port

#: the accepted duplex metrics whose readers serve the cell as they are
SHARED = ["pad_share.pairs", "device_stage_share.pairs", "device_idle.pairs"]
NAMES = SHARED + ["detok_share.crf_pairs", "crf_duplex_stage.prep", "crf_duplex_stage.size",
                  "crf_duplex_stage.wait", "crf_duplex_pad.batch_frames_per_frame",
                  "crf_duplex_roofline"]
SEED = 2**31 + 11
LENGTHS = {"median": 40, "sigma": 0.5, "min": 12, "max": 120}


def cell(**traffic):
    """The cell at reads of tens of frames, a pool of 4 pairs, 2 a call,
    every answer kept and checked."""
    c = spec.resolve("crf_duplex.pairs")
    c.config["lengths"] = dict(LENGTHS)
    c.traffic.update({"pool_pairs": 4, "call_pairs": 2, "keep_per_call": 2, "check_pairs": 48,
                      **traffic})
    return c


def run(seconds=0.5, trace=False):
    return execute(cell(), SEED, seconds, trace, torch.device("cpu"), time.perf_counter(),
                   lambda msg: None)


def pool(t1=(30, 45, 20), t2=(32, 41, 22), seed=SEED):
    c = cell().config
    return gen.crf_duplex_pairs(t1, t2, 1024, c["posteriors"], c["envelope"],
                                generator(seed, "cpu"), "cpu")


def test_entries_roles_and_files():
    for method in ("setup", "window", "counters", "release", "check", "close"):
        assert callable(getattr(crf_pairs.Driver, method))
    assert callable(crf_pairs.control_jobs)
    assert crf_pairs.Driver.roles == {"pad": "decode_many_crf_duplex.pad",
                                      "device": "crf_duplex.device", "detok": "crf_duplex.detok"}
    c = spec.resolve("crf_duplex.pairs")
    assert c.driver() is crf_pairs and c.chips == 1
    assert c.config["decode"] == {"alphabet": "NACGT", "beam_size": 5,
                                  "beam_cut_threshold": 0.01, "n_state": 1024}
    assert c.config["lengths"] == {"median": 1800, "sigma": 0.8}
    assert c.config["read2_ratio"] == [0.9, 1.1]
    assert c.config["envelope"] == {"half_width": 40, "jitter": 4}
    assert c.traffic == {"kind": "crf_pairs", "pool_pairs": 256, "call_pairs": 64,
                         "keep_per_call": 3, "check_pairs": 12}
    assert {m["name"] for m in c.end_to_end} == {"pairs_per_s", "setup_s"}
    assert [m["name"] for m in c.per_layer] == NAMES
    for m in c.per_layer:
        assert m["workloads"] == (["duplex.pairs", "crf_duplex.pairs"] if m["name"] in SHARED
                                  else ["crf_duplex.pairs"])
        assert m["moves"] == "pairs_per_s"
        assert callable(spec.metric_reader(m["name"]).read)
    conf = next(x for x in BENCH["configs"] if x["name"] == "crf_duplex_sup_s1024_b5")
    assert conf["reduced"] == [] and conf["file"] == "ctcbench/configs/crf_duplex_sup_s1024_b5.json"
    assert len(conf["source"]) <= 200


def test_both_reads_read_out_one_sequence_through_the_true_states():
    pairs, hidden = pool()
    S, A = 1024, 4
    for (n1, i1, n2, i2, env), bases, start, st1, st2 in zip(
            pairs, hidden["bases"], hidden["start"], hidden["states1"], hidden["states2"]):
        assert int(i1.argmax()) == start == int(i2.argmax())
        for net, states in ((n1, st1), (n2, st2)):
            assert torch.allclose(net.sum(-1), torch.ones(net.shape[:2]), atol=1e-6, rtol=0)
            # the true rows name the bases in order: a base where the state moves
            rows = net[torch.arange(len(states)), torch.as_tensor(states)]
            assert states[0] == start
            moved = np.flatnonzero(states[1:] != states[:-1])
            assert len(moved) <= len(bases)
            walk = [start]
            for b in bases:
                walk.append((walk[-1] * A) % S + b - 1)
            assert set(states.tolist()) <= set(walk)
            assert rows.shape == (len(states), 5)
        # the envelope holds the upstream validity rules
        lo, hi = env[:, 0], env[:, 1]
        assert (np.diff(lo) >= 0).all() and (np.diff(hi) >= 0).all() and (hi > lo).all()
        assert lo[0] == 0 and (lo[1:] <= hi[:-1]).all() and hi[-1] <= n2.shape[0]


def test_true_rows_hold_the_confidence_law_and_the_pool_is_made_from_the_seed():
    a, ha = pool()
    b, _ = pool()
    c, _ = pool(seed=SEED + 1)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert (torch.equal(u, v) if isinstance(u, torch.Tensor) else np.array_equal(u, v))
    assert not torch.equal(a[0][0], c[0][0])
    # a confident true row's top label is its frame's target: a base where
    # the next frame's state moved, stay elsewhere
    net, states = a[0][0], ha["states1"][0]
    rows = net[torch.arange(len(states)), torch.as_tensor(states)]
    assert (rows.max(-1).values >= 0.7).float().mean() > 0.5


def test_crf_duplex_work_hand_count():
    # 2 pairs, 100 frames of read 1, 8,000 band cells, 60 bases, beam 5, 5 labels
    nbytes, ops = roofline_crf_duplex.crf_duplex_work(frames1=100, band_cells=8000, pairs=2,
                                                      bases=60, K=5, A1=5, S=1024)
    assert nbytes == (100 * 5 * 5 * 4 + 8000 * 5 * 5 * 4 + 2 * 2 * 1024 * 4 + 100 * 8 + 2 * 4
                      + 60 * 4 + 2 * 8)
    assert ops == 8000 * (5 + 5 * 4) * 10
    # the plain duplex count of the same work reads one row a frame of each read
    assert nbytes > roofline.duplex_work(100, 110, 8000, 2, 60, 5, 5)[0]


def test_check_draws_distinct_pairs_and_holds_every_kept_answer():
    t1 = np.array([50, 90, 20, 70, 60, 30])
    kept = [1, 1, 3, 0, 3, 5, 1, 2, 4, 4]
    which = crf_pairs.checked_pairs(kept, t1, 3, SEED)
    assert len(which) == 3 and which == sorted(set(which)) and 1 in which
    assert crf_pairs.checked_pairs(kept, t1, 12, SEED) == [0, 1, 2, 3, 4, 5]
    want = (0, "ACGT")
    assert crf_pairs.furthest([("ACGT", 0), ("ACGA", 0), ("AC", 0)], want) == ("AC", 0)
    assert crf_pairs.furthest([("AC", 0), ("ACGT", 3)], want) == ("ACGT", 3)
    assert crf_pairs.furthest([("ACGT", 3), None], want) is None
    assert crf_pairs.furthest([("ACGT", 0), ("ACGT", 0)], want) == ("ACGT", 0)


def view(stages=None, counters=None, work=None, trace=None, window_s=40.0):
    return LayerView(window_s, stages or {}, {}, counters or {}, work or {}, trace)


def read(name, v):
    return spec.metric_reader(name).read(name, v)


def test_readers_and_silence_where_nothing_was_recorded():
    trace = TraceSummary(window_s=40.0, busy_s=30.0, kernel_s=0.1)
    assert read("crf_duplex_roofline", view(work={"crf_duplex": (3.35e9, 0)}, trace=trace)) == \
        pytest.approx(1.0)
    assert read("crf_duplex_roofline", view(work={"duplex": (3.35e9, 0)}, trace=trace)) is None
    for stage in ("prep", "size", "wait"):
        name = f"crf_duplex_stage.{stage}"
        assert read(name, view({f"crf_duplex.{stage}": 10.0, "duplex.wait": 1.0})) == \
            pytest.approx(25.0)
        assert read(name, view({f"duplex.{stage}": 1.0})) is None  # a program without it
    counts = {"decode_many_crf_duplex.frames": 400, "decode_many_crf_duplex.batch_frames": 600}
    assert read("crf_duplex_pad.batch_frames_per_frame", view(counters=counts)) == 1.5
    assert read("crf_duplex_pad.batch_frames_per_frame", view()) is None


def test_reference_equals_the_oracle_and_rounds_in_bfloat16():
    import sys

    sys.path.insert(0, str(spec.ROOT) + "/tests")
    import oracle

    pairs, _ = pool()
    d = cell().config["decode"]
    for n1, i1, n2, i2, env in pairs:
        args = [x.numpy() for x in (n1, i1, n2, i2)]
        want = oracle.crf_beam_search_duplex(*args, d["alphabet"], envelope=env,
                                             beam_size=d["beam_size"],
                                             beam_cut_threshold=d["beam_cut_threshold"])
        assert search(*args, env, d) == (0, want)
        assert search(*args, env, d, "bfloat16")[0] == 0


def test_sound_run_is_correct_and_a_traced_run_reads_every_metric():
    result, checks = run()
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {c.name for c in checks} == {"missing_answers", "status_mismatch", "differing_pairs",
                                        "edit_share"}
    result, checks = run(trace=True)
    assert result["correct"], checks
    assert set(result["metrics"]) == set(NAMES) - {"crf_duplex_roofline"}  # no kernel on the CPU
    assert result["metrics"]["crf_duplex_pad.batch_frames_per_frame"]["value"] >= 1


@pytest.mark.parametrize("fault", ["altered", "half", "blank", "stale"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    fix = _wrap(fault)
    real = port.decode_many_crf_duplex
    monkeypatch.setattr(port, "decode_many_crf_duplex", lambda *a, **k: fix(real(*a, **k)))
    result, checks = run(seconds=4.0 if fault == "stale" else 0.5)
    assert not result["correct"], checks


def test_a_program_without_the_entry_point_fails_in_setup(monkeypatch):
    monkeypatch.delattr(port, "decode_many_crf_duplex")
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        run()
    assert time.perf_counter() - t0 < 5


def test_control_and_planted_faults_are_not_correct():
    # reads of hundreds of frames: at tens, bfloat16 steps still give
    # float32's sequences
    c = cell(pool_pairs=4, call_pairs=2, check_pairs=4)
    c.config["lengths"] = {"median": 300, "sigma": 0.3, "min": 150, "max": 600}
    r = control_crf_duplex.readings(c, 1, torch.device("cpu"))
    assert r["checked"] == 4
    for name in ("bfloat16", "blank_half", "alter_base"):
        assert r[name]["differing_pairs"] > 0 and not r[name]["correct"], (name, r)
