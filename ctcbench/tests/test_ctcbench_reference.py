"""The frozen reference against the port's plain engines at tiny sizes: a
test of the yardstick, not a part of it.  The port's batch decoders return
sequences equal to upstream's and, for a prefix pruned and derived again,
the frame of its latest entry into the beam: the reference's second path."""

import numpy as np
import pytest

from ctcbench.drivers import common
from ctcbench.gen.pairs import duplex_pairs
from ctcbench.reference import beam_search, beam_search_duplex, bf16

PARAMS = {"alphabet_size": 5, "frames_per_base": 1.8, "ambiguous_share": 0.1,
          "confident_rest": [0.001, 0.3], "ambiguous_pair_mass": [0.8, 0.98], "max_ratio": 2.0}


def _reads(seed, n, lo, hi):
    lengths = np.random.default_rng(seed).integers(lo, hi, n)
    reads, _ = common.host_reads(lengths, PARAMS, seed, "cpu")
    return reads


@pytest.mark.parametrize("seed, cut", [(1, 0.1), (2, 0.1), (3, 0.0)])
def test_beam_reference_equals_the_plain_batch_engine(seed, cut):
    from fast_ctc_decode_tpu_torch import decode_many

    reads = _reads(seed, 24, 20, 160)
    got = decode_many(reads, "NACGT", beam_size=5, beam_cut_threshold=cut, device="cpu")
    for read, (seq, path, err) in zip(reads, got):
        want_seq, first, latest = beam_search(read, "NACGT", 5, cut)
        assert err == 0 and seq == want_seq and path == latest
        assert len(first) == len(latest) == len(seq)


def test_beam_reference_first_path_is_upstreams():
    """The first-creation path is the repository's test oracle's."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "tests"))
    import oracle

    for read in _reads(4, 8, 30, 120):
        seq, first, _ = beam_search(read, "NACGT", 5, 0.1)
        assert (seq, first) == oracle.beam_search(read, "NACGT", 5, 0.1)


def test_duplex_reference_equals_the_plain_tree_engine():
    from fast_ctc_decode_tpu_torch import decode_many_duplex

    t1 = np.array([40, 64, 90, 30])
    t2 = np.array([42, 60, 95, 31])
    pairs = duplex_pairs(t1, t2, PARAMS, {"half_width": 6, "jitter": 4},
                         common.generator(5, "cpu"), "cpu")
    got = decode_many_duplex(pairs, "NACGT", beam_size=5, beam_cut_threshold=0.1, device="cpu")
    for (n1, n2, env), (seq, err) in zip(pairs, got):
        assert err == 0 and seq == beam_search_duplex(n1, n2, "NACGT", env, 5, 0.1)


def test_bf16_rounds_to_nearest_even():
    assert bf16(np.float32(1.0)) == 1.0
    assert bf16(np.float32(1.0 + 2**-9)) == 1.0  # a tie rounds to even
    assert bf16(np.float32(1.0 + 3 * 2**-9)) == np.float32(1.0 + 2**-7)
    assert bf16(np.float32(0.1)) == np.float32(0.10009765625)


def _plain_edit_distance(a, b):
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (ca != cb))
    return row[-1]


def test_edit_distance_equals_the_plain_table():
    from ctcbench.checks import edit_distance

    rng = np.random.default_rng(3)
    cases = [("", ""), ("", "ACG"), ("ACGT", "ACGT"), ("ACGT", "AGT"), ("kitten", "sitting")]
    for _ in range(200):
        a = "".join(rng.choice(list("ACGT"), rng.integers(0, 30)))
        b = list(a) if rng.random() < 0.5 else list(rng.choice(list("ACGT"), rng.integers(0, 30)))
        for _ in range(rng.integers(0, 4)):
            k = int(rng.integers(0, len(b) + 1))
            b[k:k + int(rng.integers(0, 2))] = list(rng.choice(list("ACGT"), rng.integers(0, 2)))
        cases.append((a, "".join(b)))
    for a, b in cases:
        assert edit_distance(a, b) == _plain_edit_distance(a, b) == edit_distance(b, a)


@pytest.mark.parametrize("broken, failing", [
    (lambda s, k: s, set()),
    # one base off in one long answer: a near tie that rounding decides
    (lambda s, k: s[:-1] if k == 0 else s, set()),
    (lambda s, k: "A" + s[1:] if s[0] != "A" else "C" + s[1:], {"differing_pairs"}),
    (lambda s, k: "" if k % 2 else s, {"differing_pairs", "edit_share"}),
    (lambda s, k: "" if k == 11 else s, {"edit_share"}),
])
def test_duplex_checks_catch_what_rounding_does_not(broken, failing):
    """Twelve answers of 1,000-9,000 bases: rounding's one base passes; a base
    changed in every answer, half blanked or one blanked fails."""
    from ctcbench.checks import duplex_checks

    rng = np.random.default_rng(5)
    want = [(0, "".join(rng.choice(list("ACGT"), n)))
            for n in [9000] + [1000 + 200 * k for k in range(11)]]
    got = [(broken(s, k), 0) for k, (_, s) in enumerate(want)]
    checks = duplex_checks(got, want, 0)
    assert {c.name for c in checks if not c.ok} == failing
