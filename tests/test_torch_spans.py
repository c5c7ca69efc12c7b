"""The port's program spans (``utils.profiling.stage``) on each decode path.

Under a running ``torch.profiler`` every stage is a ``record_function``
range of its name, inside its parent's range; ``METRICS.stages`` holds the
same names; the children of a stage take no more time than it; with no
profiler recording, ``stage`` never enters ``record_function``; and the CRF
stream's counters hold its frames and the bytes its pad stage writes (the
CRF duplex stream's counters are held in ``test_torch_crf_duplex_many.py``).
"""

import numpy as np
import pytest
import torch

from duplex_helpers import diag_env, random_data
from fast_ctc_decode_tpu_torch import (BatchCrfDuplexDecoder, decode_many, decode_many_crf,
                                       decode_many_crf_duplex, decode_many_duplex)
from fast_ctc_decode_tpu_torch.utils import profiling

torch.set_num_threads(1)

ALPHA = "NACGT"


def run_beam():
    reads = [random_data(t, 5, 10 + i) for i, t in enumerate((30, 130, 12))]
    decode_many(reads, ALPHA, beam_size=5, beam_cut_threshold=0.1, batch_size=2, device="cpu")


def run_duplex():
    # jagged envelopes: moving windows run the tree engine, sized by duplex.size
    pairs = [(random_data(t1, 5, 20 + i), random_data(t2, 5, 40 + i), diag_env(t1, t2, 2 + i))
             for i, (t1, t2) in enumerate(((12, 14), (10, 9), (14, 16)))]
    decode_many_duplex(pairs, ALPHA, beam_size=5, beam_cut_threshold=0.0, batch_size=2,
                       device="cpu")


def crf_read(T, S, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(T, S, 5).astype(np.float32)
    return x / x.sum(-1, keepdims=True), rng.rand(S).astype(np.float32)


def run_crf():
    reads = [crf_read(T, 4, 60 + i) for i, T in enumerate((20, 9, 150))]
    decode_many_crf(reads, ALPHA, beam_size=5, beam_cut_threshold=0.05, batch_size=2,
                    device="cpu")


def run_crf_duplex():
    T1, T2 = 12, 14
    (n1, i1), (n2, i2) = crf_read(T1, 4, 80), crf_read(T2, 4, 81)
    dec = BatchCrfDuplexDecoder(ALPHA, T1=T1, T2=T2, n_state=4, device="cpu")
    dec.decode(n1[None], i1[None], n2[None], i2[None], envelopes=diag_env(T1, T2, 3))


def run_crf_duplex_many():
    # one batch of tensors (the device path) and one of host arrays
    pairs = []
    for i, (t1, t2) in enumerate(((12, 14), (10, 9), (14, 16))):
        (n1, i1), (n2, i2) = crf_read(t1, 4, 90 + i), crf_read(t2, 4, 95 + i)
        pair = (n1, i1, n2, i2, diag_env(t1, t2, 2 + i))
        pairs.append(pair if i == 2 else tuple(map(torch.as_tensor, pair[:4])) + pair[4:])
    decode_many_crf_duplex(pairs, ALPHA, batch_size=2, device="cpu")


def device_tree(path, top=None):
    """Each stage of a path's batch decode, with its parent."""
    tree = {f"{path}.device": top, f"{path}.detok": top}
    kids = ["upload", "launch", "wait", "fetch"]
    if "duplex" in path:
        kids += ["prep", "size"]
    tree.update({f"{path}.{k}": f"{path}.device" for k in kids})
    return tree


def call_tree(call, path):
    return {call: None, f"{call}.bucket": call, f"{call}.pad": call, f"{call}.checkpoint": call,
            **device_tree(path, call)}


#: path -> (a decode on the CPU, the stages it records with their parents)
PATHS = {
    "beam": (run_beam, call_tree("decode_many", "beam")),
    "duplex": (run_duplex, call_tree("decode_many_duplex", "duplex")),
    "crf": (run_crf, call_tree("decode_many_crf", "crf")),
    "crf_duplex": (run_crf_duplex, device_tree("crf_duplex")),
    "crf_duplex_many": (run_crf_duplex_many, call_tree("decode_many_crf_duplex", "crf_duplex")),
}


def profiled(run):
    """The ranges a profiled run records: name -> [(start, end)] in ns."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        ranges.setdefault(ev.name(), []).append((start, start + ev.duration_ns()))
    return ranges


@pytest.mark.parametrize("path", list(PATHS))
def test_stages_are_profiler_ranges_nested_as_the_stages(path):
    run, tree = PATHS[path]
    ranges = profiled(run)
    assert set(tree) <= set(ranges)
    for name, parent in tree.items():
        if parent is None:
            continue
        for a, b in ranges[name]:
            assert any(pa <= a and b <= pb for pa, pb in ranges[parent]), (name, parent)


@pytest.mark.parametrize("path", list(PATHS))
def test_metrics_stages_hold_the_same_names(path):
    run, tree = PATHS[path]
    stages = profiling.reset_metrics().stages
    run()
    assert set(stages) == set(tree)
    assert all(v >= 0 for v in stages.values())


@pytest.mark.parametrize("path", list(PATHS))
def test_children_take_no_more_than_their_parent(path):
    run, tree = PATHS[path]
    stages = profiling.reset_metrics().stages
    run()
    for parent in {p for p in tree.values() if p is not None}:
        kids = [n for n, p in tree.items() if p == parent]
        assert sum(stages[n] for n in kids) <= stages[parent], parent


def test_crf_stream_counts_frames_and_moved_bytes():
    counts = profiling.reset_metrics().counts
    run_crf()
    frames = 20 + 9 + 150
    assert counts == {"decode_many_crf.frames": frames,
                      "decode_many_crf.moved_bytes": 4 * (frames * 4 * 5 + 3 * 4)}
    # only the CRF stream counts
    for path in ("beam", "duplex", "crf_duplex"):
        counts = profiling.reset_metrics().counts
        PATHS[path][0]()
        assert counts == {}


class CountingRange:
    """Stands in for ``torch.profiler.record_function``; counts entries."""

    entered = 0

    def __init__(self, name, args=None):
        self.name = name

    def __enter__(self):
        CountingRange.entered += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("path", list(PATHS))
def test_no_record_function_without_a_profiler(path, monkeypatch):
    run, tree = PATHS[path]
    monkeypatch.setattr(torch.profiler, "record_function", CountingRange)
    CountingRange.entered = 0
    run()
    assert CountingRange.entered == 0
    # the stand-in is what stage() calls once a profiler records
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run()
    assert CountingRange.entered >= len(tree)
