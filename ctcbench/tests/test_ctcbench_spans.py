"""The readers of the program's stage spans (``metrics/upload_share.py``,
``wait_share.py``, ``fetch_share.py``, ``prep_share.py``): each reads its
stage's seconds over the window, by the metric's cell suffix, and nothing
where the run recorded no such stage; their entries in ``BENCHMARK.json``
hold to what every per-layer entry holds to."""

import pytest

from ctcbench import spec
from ctcbench.harness import LayerView

from .test_ctcbench_spec import BENCH, NAME, UNIT

#: metric -> the stage it reads, and its cell
SPANS = {
    "upload_share.frames": ("beam.upload", "ctc.stream"),
    "wait_share.frames": ("beam.wait", "ctc.stream"),
    "fetch_share.frames": ("beam.fetch", "ctc.stream"),
    "prep_share.pairs": ("duplex.prep", "duplex.pairs"),
    "wait_share.pairs": ("duplex.wait", "duplex.pairs"),
}


def view(stages, window_s=40.0):
    return LayerView(window_s, stages, {}, {}, {}, None)


@pytest.mark.parametrize("name", list(SPANS))
def test_reader_gives_its_stage_share_of_the_window(name):
    stage, _ = SPANS[name]
    read = spec.metric_reader(name).read
    others = {s: 1.0 for s, _ in SPANS.values() if s != stage}
    assert read(name, view({stage: 10.0, **others})) == pytest.approx(25.0)
    assert read(name, view(others)) is None  # a program without the stage
    assert read(name, view({stage: 10.0}, window_s=0.0)) is None


@pytest.mark.parametrize("name", list(SPANS))
def test_entry_holds_to_the_per_layer_rules(name):
    stage, cell = SPANS[name]
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry == {"name": name, "unit": "%", "better": "lower", "source": "program_span",
                     "layer": "ops", "moves": entry["moves"], "workloads": [cell]}
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    resolved = spec.resolve(cell)
    assert entry["moves"] in {m["name"] for m in resolved.end_to_end} - {"setup_s"}
    assert name in {m["name"] for m in resolved.per_layer}
    assert callable(spec.metric_reader(name).read)
    assert BENCH["per_layer"].index(entry) >= len(BENCH["per_layer"]) - len(SPANS)
