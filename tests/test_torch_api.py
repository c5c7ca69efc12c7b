"""The PyTorch port's single-read API against the JAX package's and the reference fixtures.

``fast_ctc_decode_tpu_torch.api`` must give the JAX ``api``'s results on the
fixtures of tests/test_parity_reference.py (the Rust viterbi matrix, the
WASM beam golden "GAGAG", the CRF fixture), the same exception types and
messages on the error probes, and tests/oracle.py's sequences and paths
with the exact engines.  ``BatchBeamDecoder(engine="exact")`` and
``decode_many(engine="exact")`` equal the single-read API.
"""

import numpy as np
import pytest
import torch

import oracle
from fast_ctc_decode_tpu import api as jax_api
from fast_ctc_decode_tpu_torch import api as port_api
from fast_ctc_decode_tpu_torch.ops import beam as port_beam
from fast_ctc_decode_tpu_torch.parallel import pipeline as port_pipeline

torch.set_num_threads(1)

ALPHABET = "NACGT"


def random_data(samples=100, alphabet=ALPHABET, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(samples, len(alphabet)).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=1, keepdims=True)


def outcome(fn, *args, **kwargs):
    """(result) or (exception class name, is a RuntimeError, message)."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # the probes compare whatever is raised
        return (type(e).__name__, isinstance(e, RuntimeError), str(e))


RUST_VITERBI = np.array(
    [
        [0.0, 0.4, 0.6], [0.0, 0.3, 0.7], [0.3, 0.3, 0.4], [0.4, 0.3, 0.3],
        [0.4, 0.3, 0.3], [0.3, 0.3, 0.4], [0.1, 0.4, 0.5], [0.1, 0.5, 0.4],
        [0.8, 0.1, 0.1], [0.1, 0.1, 0.8],
    ],
    np.float32,
)
BLANK_BOUNDS = np.concatenate(
    [np.array([[0.6, 0.2, 0.2], [0.6, 0.2, 0.2]], np.float32), RUST_VITERBI,
     np.array([[0.4, 0.3, 0.3]], np.float32)]
)


def crf_fixture():
    x = np.zeros((7, 4, 5), np.float32)
    x[0, 2, 0] = 1.0
    x[1, 2, 2] = 0.9
    x[2, 1, 4] = 0.7
    x[3, 3, 0] = 1.0
    x[4, 3, 1] = 0.99
    x[5, 0, 1] = 0.9
    x[6, 0, 3] = 0.999
    return x, np.array([0.0, 0.0, 1.0, 0.0, 0.0], np.float32)


def test_rust_viterbi_fixtures():
    assert port_api.viterbi_search(RUST_VITERBI, "NAG", False, 1.0, 0.0, True, device="cpu") == ("GGAG", [0, 5, 7, 9])
    assert port_api.viterbi_search(RUST_VITERBI, "NAG", True, 1.0, 0.0, True, device="cpu") == ("GGAG%$$(", [0, 5, 7, 9])
    for qstring in (False, True):
        for collapse in (True, False):
            args = (BLANK_BOUNDS, "NAG", qstring, 1.0, 0.0, collapse)
            assert port_api.viterbi_search(*args, device="cpu") == jax_api.viterbi_search(*args)
    assert port_api.viterbi_search(BLANK_BOUNDS, "NAG", True, 1.0, 0.0, False, device="cpu") == (
        "GGGGGAG%&##$$(", [2, 3, 4, 7, 8, 9, 11]
    )


@pytest.mark.parametrize("engine", ["exact", "fast"])
def test_wasm_beam_golden(engine):
    assert port_api.beam_search(BLANK_BOUNDS, "NAG", 5, 0.0, True, engine=engine, device="cpu")[0] == "GAGAG"
    assert port_api.beam_search(BLANK_BOUNDS, "NAG", 5, 0.0, False, engine=engine, device="cpu")[0] == "GGGAGAG"
    for collapse in (True, False):
        args = (BLANK_BOUNDS, "NAG", 5, 0.0, collapse)
        assert port_api.beam_search(*args, engine=engine, device="cpu") == jax_api.beam_search(*args, engine=engine)


def test_crf_fixture():
    x, init = crf_fixture()
    assert port_api.crf_greedy_search(x, init, ALPHABET, False, 1.0, 0.0, device="cpu") == ("CTAAG", [1, 2, 4, 5, 6])
    assert port_api.crf_greedy_search(x, init, ALPHABET, True, 1.0, 0.0, device="cpu") == ("CTAAG+&5+?", [1, 2, 4, 5, 6])
    assert port_api.crf_beam_search(x, init, ALPHABET, 5, 0.01, device="cpu") == ("CTAAG", [1, 2, 4, 5, 6])
    for engine in ("exact", "fast"):
        assert port_api.crf_beam_search(x, init, ALPHABET, 5, 0.01, engine=engine, device="cpu") == jax_api.crf_beam_search(
            x, init, ALPHABET, 5, 0.01, engine=engine
        )


def test_reference_path_fixtures():
    w = 20
    x = np.zeros((w, 5), np.float32)
    x[:, 0] = 0.5
    for idx in (6, 13, 18):
        x[idx, 0] = 0.0
        x[idx, 1] = 1.0
    assert port_api.beam_search(x, ALPHABET, 5, 0.1, device="cpu") == ("AAA", [6, 13, 18])
    assert port_api.viterbi_search(x, ALPHABET, qstring=True, device="cpu") == ("AAAIII", [6, 13, 18])
    multi = ["N", "AAA", "CCC", "GGG", "TTTT"]
    y = np.zeros((w, 5), np.float32)
    y[:, 0] = 0.5
    for i, idx in enumerate((6, 13, 18)):
        y[idx, 0] = 0.0
        y[idx, 1 + i] = 1.0
    assert port_api.beam_search(y, multi, 5, 0.1, device="cpu") == ("AAACCCGGG", [6, 13, 18])
    w = 400
    z = np.zeros((w, 5), np.float32)
    z[:, 0] = 0.5
    emit = np.arange(0, w, 4)
    for base, pos in enumerate(emit):
        z[pos, base % 4 + 1] = 1.0
    assert port_api.beam_search(z, ALPHABET, 5, 0.1, device="cpu")[1] == emit.tolist()


def _nan_data():
    x = random_data()
    x.fill(np.nan)
    return x


PROBES = [
    ("beam_search", (random_data(), ALPHABET, 0, 0.1), {}),
    ("beam_search", (random_data(), ALPHABET, 5, -0.1), {}),
    ("beam_search", (random_data(), ALPHABET, 5, 0.2), {}),
    ("beam_search", (random_data(), ALPHABET, 5, 1.1), {}),
    ("beam_search", (random_data(), "NAGC", 5, 0.1), {}),
    ("beam_search", (random_data(), "NAGCTX", 5, 0.1), {}),
    ("beam_search", (_nan_data(), ALPHABET), {}),
    ("beam_search", (_nan_data(), ALPHABET), {"engine": "fast"}),
    ("beam_search", (random_data().astype(np.float64), ALPHABET), {}),
    ("beam_search", (random_data()[None], ALPHABET), {}),
    ("beam_search", (random_data().tolist(), ALPHABET), {}),
    ("beam_search", (random_data(), ALPHABET), {"engine": "pallas"}),
    ("beam_search", (random_data(), ALPHABET), {"engine": "fast", "max_nodes": 10}),
    ("beam_search", (random_data(), ALPHABET, 5, 0.0), {"max_nodes": 8}),
    ("beam_search", (random_data()[:0], ALPHABET), {}),
    ("viterbi_search", (random_data(), "NACG"), {}),
    ("viterbi_search", (random_data(), "NACGTR"), {}),
    ("viterbi_search", (random_data()[:, :0], []), {}),
    ("viterbi_search", (random_data()[:0], ALPHABET), {}),
    ("viterbi_search", (random_data().astype(np.float16), ALPHABET), {}),
    ("crf_greedy_search", (crf_fixture()[0], crf_fixture()[1], "NACG"), {}),
    ("crf_greedy_search", (crf_fixture()[0][:0], crf_fixture()[1], ALPHABET), {}),
    ("crf_greedy_search", (crf_fixture()[0], crf_fixture()[1][None], ALPHABET), {}),
    ("crf_beam_search", (crf_fixture()[0], crf_fixture()[1], ALPHABET, 0), {}),
    ("crf_beam_search", (crf_fixture()[0], crf_fixture()[1], "NACGTX"), {}),
    ("crf_beam_search", (crf_fixture()[0][:0], crf_fixture()[1], ALPHABET), {}),
    ("crf_beam_search", (crf_fixture()[0], crf_fixture()[1].astype(np.float64), ALPHABET), {}),
    ("crf_beam_search", (crf_fixture()[0], crf_fixture()[1], ALPHABET), {"engine": "bogus"}),
    ("crf_beam_search", (crf_fixture()[0], crf_fixture()[1], ALPHABET, 5, 0.0), {"max_nodes": 3}),
    ("crf_beam_search", (crf_fixture()[0], crf_fixture()[1], ALPHABET, 5, 0.0),
     {"engine": "fast", "max_nodes": 3}),
]


@pytest.mark.parametrize("i", range(len(PROBES)))
def test_error_probes_equal_jax(i):
    name, args, kwargs = PROBES[i]
    want = outcome(getattr(jax_api, name), *args, **kwargs)
    got = outcome(getattr(port_api, name), *args, **kwargs, device="cpu")
    assert got == want


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_exact_engine_equals_oracle(seed):
    x = random_data(120, seed=seed)
    for thr in (0.0, 0.1):
        for collapse in (True, False):
            want = oracle.beam_search(x, ALPHABET, 5, thr, collapse)
            assert port_api.beam_search(x, ALPHABET, 5, thr, collapse, device="cpu") == want
            assert port_api.beam_search(x, ALPHABET, 5, thr, collapse, engine="fast", device="cpu")[0] == want[0]
    rng = np.random.RandomState(seed)
    c = rng.rand(40, 16, 5).astype(np.float32)
    c /= c.sum(-1, keepdims=True)
    init = rng.rand(16).astype(np.float32)
    for thr in (0.0, 0.05):
        want = oracle.crf_beam_search(c, init, ALPHABET, 5, thr)
        assert port_api.crf_beam_search(c, init, ALPHABET, 5, thr, device="cpu") == want
        assert port_api.crf_beam_search(c, init, ALPHABET, 5, thr, engine="fast", device="cpu")[0] == want[0]


def test_long_alphabet_and_wide_beam_on_the_cpu():
    # beyond the CUDA kernels' bounds (A+1 = 12, beam 20): the CPU engines take them
    alphabet = "NABCDEFGHIJK"
    x = random_data(60, alphabet=alphabet, seed=4)
    for engine in ("exact", "fast"):
        assert port_api.beam_search(x, alphabet, 20, 0.0, engine=engine, device="cpu") == jax_api.beam_search(
            x, alphabet, 20, 0.0, engine=engine
        )


def test_batch_exact_decoder_and_decode_many_equal_the_api():
    lengths = np.array([40, 17, 0, 33], np.int32)
    probs = np.zeros((4, 40, 5), np.float32)
    for i, n in enumerate(lengths):
        probs[i, :n] = random_data(int(n), seed=10 + i)
    dec = port_pipeline.BatchBeamDecoder("NACGT", T=40, beam_size=5, beam_cut_threshold=0.1,
                                         engine="exact", device="cpu")
    # no budget given: each batch gets the worst case for its T
    assert dec.max_nodes is None and port_beam.default_max_nodes(40, 5, 4) == 40 * 5 * 4 + 8
    got = dec.decode(probs, lengths)
    want = [
        port_api.beam_search(probs[i, :n], ALPHABET, 5, 0.1, device="cpu") + (0,) if n else ("", [], 0)
        for i, n in enumerate(lengths)
    ]
    assert got == want
    reads = [probs[i, :n] for i, n in enumerate(lengths) if n]
    many = port_pipeline.decode_many(reads, ALPHABET, beam_size=5, beam_cut_threshold=0.1,
                                     engine="exact", batch_size=2, device="cpu")
    assert many == [w for w, n in zip(want, lengths) if n]
    # a budget too small for a read stops it with NODE_OVERFLOW, no re-run
    small = port_pipeline.BatchBeamDecoder("NACGT", T=40, beam_size=5, beam_cut_threshold=0.1,
                                           engine="exact", max_nodes=30, device="cpu")
    assert [r[2] for r in small.decode(probs, lengths)] == [4, 4, 0, 4]
