"""The seeded generators: deterministic by seed, and of the stated law."""

import numpy as np
import torch

from ctcbench.drivers import common
from ctcbench.gen import posteriors
from ctcbench.gen.pairs import duplex_pairs

PARAMS = {"alphabet_size": 5, "frames_per_base": 1.8, "ambiguous_share": 0.1,
          "confident_rest": [0.001, 0.3], "ambiguous_pair_mass": [0.8, 0.98], "max_ratio": 2.0}


def reads(seed, lengths=(300, 120, 700)):
    rows, off = posteriors.ctc_reads(np.array(lengths), PARAMS, common.generator(seed, "cpu"),
                                     "cpu")
    return rows, off


def test_reads_deterministic_by_seed():
    a, _ = reads(2**31 + 5)
    b, _ = reads(2**31 + 5)
    c, _ = reads(2**31 + 6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_rows_are_probabilities_of_the_stated_law():
    rows, off = reads(7, lengths=(4000, 4000, 4000))
    assert rows.dtype == torch.float32 and rows.shape == (12000, 5)
    assert torch.allclose(rows.sum(1), torch.ones(12000), atol=1e-6)
    assert bool((rows >= 0).all())
    s = posteriors.stats(rows, np.diff(off))
    assert abs(s["frames_per_base"] - 1.8) < 0.08
    assert 0.07 < s["ambiguous_share"] < 0.14
    # every read starts with a base
    assert all(int(rows[o].argmax()) != 0 for o in off[:-1])


def test_every_call_holds_the_same_sizes_under_every_seed():
    cfg = {"lengths": {"median": 1800, "sigma": 0.8}}
    # no clip: the quantiles' own ends
    whole = common.length_grid(cfg, 512)
    assert whole.min() == 151 and whole.max() == 21447 and abs(np.median(whole) - 1800) <= 30
    cfg["lengths"].update(min=100, max=16384)
    grid = common.length_grid(cfg, 512)
    assert grid.min() >= 100 and grid.max() == 16384
    a, b = common.deal(grid, 8, 1), common.deal(grid, 8, 2)
    assert list(a) != list(b)
    for c in range(8):
        call = slice(64 * c, 64 * (c + 1))
        assert sorted(a[call]) == sorted(b[call])
    # each call holds one of every 8 neighbouring sizes: their totals agree
    sums = [a[64 * c:64 * (c + 1)].sum() for c in range(8)]
    assert (max(sums) - min(sums)) / np.mean(sums) < 0.05


def test_pairs_deterministic_and_envelopes_valid():
    t1, t2 = np.array([200, 90, 400]), np.array([210, 85, 380])
    env = {"half_width": 6, "jitter": 4}
    p = duplex_pairs(t1, t2, PARAMS, env, common.generator(9, "cpu"), "cpu")
    q = duplex_pairs(t1, t2, PARAMS, env, common.generator(9, "cpu"), "cpu")
    for (a1, a2, ae), (b1, b2, be), T1, T2 in zip(p, q, t1, t2):
        assert np.array_equal(a1, b1) and np.array_equal(a2, b2) and np.array_equal(ae, be)
        assert a1.shape == (T1, 5) and a2.shape == (T2, 5) and ae.shape == (T1, 2)
        lo, hi = ae[:, 0], ae[:, 1]
        assert np.all(lo < hi) and np.all(lo >= 0) and np.all(hi <= T2)
        assert np.all(np.diff(lo) >= 0) and np.all(np.diff(hi) >= 0)
        assert lo[0] == 0 and np.all(lo[1:] <= hi[:-1])
        assert 2 * 2 + 1 <= (hi - lo).mean() <= 2 * 10 + 1


def test_pair_envelope_follows_the_alignment():
    """On a pair read out with equal dwells the envelope is centred on the
    diagonal."""
    base1 = np.repeat(np.arange(50), 2)
    start = np.arange(50) * 2
    dwell = np.full(50, 2)
    e = __import__("ctcbench.gen.pairs", fromlist=["envelope"]).envelope(
        base1, start, dwell, dwell, start, 100, np.full(100, 3))
    centre = (e[:, 0] + e[:, 1] - 1) / 2
    assert np.all(np.abs(centre[5:-5] - np.arange(5, 95)) <= 0.5)
