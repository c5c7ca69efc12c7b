"""The CRF cell ``crf.stream``: its driver, generator, work count and
readers, its run on the CPU at a tiny size (sound, and broken underneath),
and its precision control.

Tiny copies of the cell keep every width (1,024 states, 5 labels) and cut
the chunk to tens of frames and the pool to a few chunks."""

import time

import numpy as np
import pytest
import torch

from ctcbench import control_crf, roofline, roofline_crf, spec
from ctcbench.drivers import crf_chunks
from ctcbench.drivers.common import generator
from ctcbench.gen import crf as gen
from ctcbench.gen.posteriors import frame_rows
from ctcbench.harness import LayerView, execute
from ctcbench.trace import TraceSummary

from .test_ctcbench_faults import _wrap
from .test_ctcbench_spec import BENCH

import fast_ctc_decode_tpu_torch as port

NAMES = ["detok_share.crf", "pad_share.crf", "device_stage_share.crf", "device_idle.crf",
         "crf_stage.wait", "crf_copy.bytes_per_frame", "crf_roofline"]
SEED = 2**31 + 11


def cell(T=40, **traffic):
    """The cell at chunks of ``T`` frames, a pool of 6 chunks, 3 a call, every
    answer kept and checked."""
    c = spec.resolve("crf.stream")
    c.config["chunk_frames"] = T
    c.traffic.update({"pool_chunks": 6, "call_chunks": 3, "keep_per_call": 3,
                      "check_chunks": 48, **traffic})
    return c


def run(seconds=0.5, trace=False):
    return execute(cell(), SEED, seconds, trace, torch.device("cpu"), time.perf_counter(),
                   lambda msg: None)


def pool(n=4, T=30, seed=SEED):
    c = cell(T)
    return gen.crf_chunks(n, T, c.config["decode"]["n_state"], c.config["posteriors"],
                          generator(seed, "cpu"), "cpu")


def test_driver_interface_roles_and_entries():
    for method in ("setup", "window", "counters", "release", "check", "close"):
        assert callable(getattr(crf_chunks.Driver, method))
    assert callable(crf_chunks.control_jobs)
    assert crf_chunks.Driver.roles == {"detok": "crf.detok", "pad": "decode_many_crf.pad",
                                       "device": "crf.device"}
    c = spec.resolve("crf.stream")
    assert c.driver() is crf_chunks and c.chips == 1
    assert c.config["decode"] == {"alphabet": "NACGT", "beam_size": 5,
                                  "beam_cut_threshold": 0.0, "n_state": 1024}
    assert c.config["chunk_frames"] == 2000 and c.config["reduced"] == []
    assert c.traffic == {"kind": "crf_chunks", "pool_chunks": 512, "call_chunks": 256,
                         "keep_per_call": 2, "check_chunks": 32}
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "setup_s"}
    assert [m["name"] for m in c.per_layer] == NAMES
    for m in c.per_layer:
        assert m["workloads"] == ["crf.stream"] and m["moves"] == "frames_per_s"
        assert callable(spec.metric_reader(m["name"]).read)
    conf = next(x for x in BENCH["configs"] if x["name"] == "crf_sup_s1024_b5")
    assert conf["reduced"] == [] and conf["file"] == "ctcbench/configs/crf_sup_s1024_b5.json"


def test_hidden_state_follows_the_decoders_register():
    _, _, targets, start, states = pool()
    S = 1024
    assert torch.equal(states[:, 0], start)
    b = targets[:, :-1]
    nxt = torch.where(b > 0, (states[:, :-1] * 4) % S + b - 1, states[:, :-1])
    assert torch.equal(states[:, 1:], nxt)
    assert torch.equal(targets[:, 0] > 0, torch.ones(4, dtype=torch.bool))  # a chunk starts a base
    assert ((targets >= 0) & (targets <= 4)).all()


def test_rows_sum_to_one_and_the_true_row_holds_the_confidence_law():
    probs, _, targets, _, states = pool()
    n, T = targets.shape
    assert torch.allclose(probs.sum(-1), torch.ones(n, T, 1024), atol=1e-6, rtol=0)
    assert (probs >= 0).all()
    # the same generator's draws in the same order: the hidden paths, then the rows
    g = generator(SEED, "cpu")
    c = cell(T)
    gen.hidden_paths(n, T, 1024, c.config["posteriors"], g, "cpu")
    rows = frame_rows(targets.reshape(-1), c.config["posteriors"], g).reshape(n, T, 5)
    k, t = torch.arange(n)[:, None], torch.arange(T)[None, :]
    assert torch.equal(probs[k, t, states], rows)
    # a confident true row's top label is the frame's target
    confident = rows.max(-1).values >= 0.7
    assert torch.equal(rows.argmax(-1)[confident], targets[confident])


def test_init_state_holds_its_maximum_on_the_true_start_state():
    _, init, _, start, _ = pool()
    assert torch.allclose(init.sum(1), torch.ones(4), atol=1e-6, rtol=0)
    assert torch.equal(init.argmax(1), start)
    top2 = init.topk(2, dim=1).values
    assert (top2[:, 0] > top2[:, 1]).all()


def test_the_pool_is_made_from_the_seed_alone():
    a, b, c = pool(), pool(), pool(seed=SEED + 1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    out = torch.empty_like(a[0])
    got = gen.crf_chunks(4, 30, 1024, cell(30).config["posteriors"], generator(SEED, "cpu"),
                         "cpu", out=out)
    assert got[0] is out and torch.equal(out, a[0])


def test_crf_work_hand_count():
    # 2 reads of 100 frames, 1024 states, 60 bases emitted, beam 5, 5 labels
    nbytes, ops = roofline_crf.crf_work(frames=200, reads=2, bases=60, K=5, A1=5, S=1024)
    assert nbytes == 200 * 5 * 5 * 4 + 2 * 1024 * 4 + 2 * 4 + 60 * 8 + 2 * 8
    assert ops == 200 * roofline.beam_step_ops(5, 4) == 200 * 200
    # the whole [S, A+1] frame a read-step would be 20,480 bytes: not counted
    assert nbytes < 200 * 1024 * 5 * 4


def view(stages=None, counters=None, work=None, trace=None, window_s=40.0):
    return LayerView(window_s, stages or {}, {}, counters or {}, work or {}, trace)


def read(name, v):
    return spec.metric_reader(name).read(name, v)


def test_readers_and_silence_where_nothing_was_recorded():
    trace = TraceSummary(window_s=40.0, busy_s=30.0, kernel_s=0.1)
    assert read("crf_roofline", view(work={"crf": (3.35e9, 0)}, trace=trace)) == \
        pytest.approx(1.0)
    assert read("crf_roofline", view(work={"beam": (3.35e9, 0)}, trace=trace)) is None
    assert read("crf_roofline", view(work={"crf": (3.35e9, 0)})) is None
    assert read("crf_stage.wait", view({"crf.wait": 10.0, "beam.wait": 1.0})) == \
        pytest.approx(25.0)
    assert read("crf_stage.wait", view({"beam.wait": 1.0})) is None
    assert read("crf_stage.wait", view({"crf.wait": 1.0}, window_s=0.0)) is None
    counts = {"decode_many_crf.frames": 2000, "decode_many_crf.moved_bytes": 20480 * 2000 + 4096}
    assert read("crf_copy.bytes_per_frame", view(counters=counts)) == pytest.approx(20482.048)
    assert read("crf_copy.bytes_per_frame", view()) is None  # a program without the counters
    assert read("crf_copy.bytes_per_frame",
                view(counters={"decode_many_crf.frames": 5})) is None


def test_sound_run_is_correct_and_a_traced_run_reads_every_metric():
    result, checks = run()
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {c.name for c in checks} == {"missing_answers", "status_mismatch", "seq_mismatch",
                                        "path_mismatch"}
    result, checks = run(trace=True)
    assert result["correct"], checks
    assert set(result["metrics"]) == set(NAMES) - {"crf_roofline"}  # no kernel on the CPU
    assert result["metrics"]["crf_copy.bytes_per_frame"]["value"] == pytest.approx(
        (40 * 1024 * 5 * 4 + 1024 * 4) / 40)


@pytest.mark.parametrize("fault", ["altered", "half", "blank", "stale"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    fix = _wrap(fault)
    real = port.decode_many_crf
    monkeypatch.setattr(port, "decode_many_crf", lambda *a, **k: fix(real(*a, **k)))
    result, checks = run(seconds=2.0 if fault == "stale" else 0.5)
    assert not result["correct"], checks


@pytest.mark.parametrize("seed", [1, 2])
def test_control_and_planted_fault_are_not_correct(seed):
    c = cell(1000, pool_chunks=4, call_chunks=2, check_chunks=4)
    r = control_crf.readings(c, seed, torch.device("cpu"))
    assert r["checked"] == 4
    for name in ("bfloat16", "alter_base"):
        assert sum(r[name].values()) > 0, (name, r)
