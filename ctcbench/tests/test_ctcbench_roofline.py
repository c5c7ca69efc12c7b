"""The roofline arithmetic against a hand count: the decode's own inputs and
final outputs, no id log and no host-derived tensor."""

import pytest

from ctcbench import roofline
from ctcbench.harness import LayerView
from ctcbench.metrics import beam_roofline, duplex_roofline
from ctcbench.trace import TraceSummary


def test_beam_step_ops_hand_count():
    # K=5, A=4: 20 + 5 + 10 + 5 + 25 + 5*25 + 10
    assert roofline.beam_step_ops(5, 4) == 200


def test_beam_work_counts_inputs_and_final_outputs_only():
    # 3 reads, 1000 frames of 5 f32, 400 bases emitted
    nbytes, ops = roofline.beam_work(frames=1000, reads=3, bases=400, K=5, A1=5)
    assert nbytes == 1000 * 5 * 4 + 3 * 4 + 400 * 8 + 3 * 8
    assert ops == 1000 * 200
    # the [T, K, B] id log of these reads at T=1000 would be 60,000 bytes: absent
    assert nbytes < 1000 * 5 * 3 * 4 + 1000 * 5 * 4


def test_duplex_work_hand_count():
    nbytes, ops = roofline.duplex_work(frames1=100, frames2=110, band_cells=1300, pairs=1,
                                       bases=50, K=5, A1=5)
    assert nbytes == (100 + 110) * 5 * 4 + 100 * 8 + 4 + 50 * 4 + 8
    assert ops == 1300 * (5 + 20) * 10


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


def test_share_over_all_kernel_time_and_silent_without_it():
    view = LayerView(1.0, {}, {}, {}, {"beam": (3.35e9, 0)},
                     TraceSummary(window_s=1.0, busy_s=0.5, kernel_s=0.1))
    assert beam_roofline.read("beam_roofline", view) == pytest.approx(1.0)
    assert duplex_roofline.read("duplex_roofline", view) is None
    view.trace = None
    assert beam_roofline.read("beam_roofline", view) is None
    view.trace = TraceSummary(window_s=1.0, busy_s=0.0, kernel_s=0.0)
    assert beam_roofline.read("beam_roofline", view) is None
