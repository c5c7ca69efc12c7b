"""``examples/basecall_demo_torch.py`` and
``fast_ctc_decode_tpu_torch.tools.bench_exact_duplex`` against their JAX
counterparts on the CPU: the same inputs, bit for bit, and the same decoded
outputs as the JAX package's engines.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu import beam_search_duplex as jax_beam_search_duplex
from fast_ctc_decode_tpu.ops import duplex as jax_duplex
from fast_ctc_decode_tpu.parallel.pipeline import BatchBeamDecoder as JaxBeamDecoder
from fast_ctc_decode_tpu.parallel.pipeline import BatchViterbiDecoder as JaxViterbiDecoder
from fast_ctc_decode_tpu.utils.padding import pad_batch as jax_pad_batch
from fast_ctc_decode_tpu_torch.tools import bench_exact_duplex

import duplex_helpers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHABET = "NACGT"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


demo = _load("demo_torch", "examples/basecall_demo_torch.py")
jax_demo = _load("demo_jax", "examples/basecall_demo.py")  # imports jax only inside main


@pytest.mark.parametrize("seed,n_bases,noise", [(0, 50, 0.04), (3, 12, 0.15), (9, 1, 0.5)])
def test_synth_read_equals_the_jax_demo(seed, n_bases, noise):
    got = demo.synth_read(np.random.RandomState(seed), n_bases, noise=noise)
    want = jax_demo.synth_read(np.random.RandomState(seed), n_bases, noise=noise)
    assert got[0] == want[0] and got[1].tobytes() == want[1].tobytes()


def test_demo_equals_the_jax_package():
    reads, T = 8, 60
    res = demo.run(reads, T, "cpu", log=lambda *_: None)
    assert res["engine"] == "fast" and res["design"] is None

    # the JAX demo's reads, decoded by the JAX package
    rng = np.random.RandomState(0)
    truths, reads_ = zip(*(jax_demo.synth_read(rng, T // 6) for _ in range(reads)))
    probs, lengths = jax_pad_batch(list(reads_))
    assert res["truths"] == list(truths)
    beam = JaxBeamDecoder(ALPHABET, T=probs.shape[1], beam_size=5, beam_cut_threshold=0.1,
                          engine="fast").decode(probs, lengths)
    assert [(r[0], r[1]) for r in res["beam"]] == [(r[0], list(r[1])) for r in beam]
    vit = JaxViterbiDecoder(ALPHABET, T=probs.shape[1]).decode(probs, lengths)
    assert [(r[0], r[1]) for r in res["viterbi"]] == [(r[0], list(r[1])) for r in vit]

    # examples/basecall_demo.py's duplex pair
    truth, p1 = jax_demo.synth_read(rng, 12, noise=0.15)
    _, p2 = jax_demo.synth_read(rng, 12, noise=0.15)
    p2 = p1 * 0.0
    rng2 = np.random.RandomState(1)
    p2 += rng2.rand(*p1.shape).astype(np.float32) * 0.15
    p2[:, 0] += 2.0
    for i, ch in enumerate(truth):
        p2[i * 6, ALPHABET.index(ch)] += 8.0
    p2 /= p2.sum(axis=1, keepdims=True)
    assert res["duplex_truth"] == truth
    assert res["consensus"] == jax_beam_search_duplex(p1, p2, ALPHABET)


def test_duplex_pair_equals_the_jax_demo():
    rng = np.random.RandomState(5)
    truth, p1 = jax_demo.synth_read(rng, 12, noise=0.15)
    jax_demo.synth_read(rng, 12, noise=0.15)
    p2 = p1 * 0.0
    p2 += np.random.RandomState(1).rand(*p1.shape).astype(np.float32) * 0.15
    p2[:, 0] += 2.0
    for i, ch in enumerate(truth):
        p2[i * 6, ALPHABET.index(ch)] += 8.0
    p2 /= p2.sum(axis=1, keepdims=True)
    rng_port = np.random.RandomState(5)
    got = demo.duplex_pair(rng_port)
    assert got[0] == truth and got[1].tobytes() == p1.tobytes() and got[2].tobytes() == p2.tobytes()
    assert rng_port.randint(1 << 30) == rng.randint(1 << 30)  # the same draws consumed


def _jax_tool_inputs(B, crf, T, w):
    """tools/bench_exact_duplex.py:34-64 with T and w as parameters."""
    T1 = T2 = T
    A1, S = 5, 16
    rng = np.random.RandomState(11)
    env = duplex_helpers.diag_env(T1, T2, w)
    lo_, hi_, We, Wre, ne, Wxe = jax_duplex._prep_envelope(env, T2)
    N = jax_duplex._duplex_max_nodes(T1, 5, A1 - 1, We)
    if not crf:  # the JAX tool caps both; its CRF pairs overflow the cap at T=500
        N = min(N, 4096)
    if crf:
        x1 = rng.rand(B, T1, S, A1).astype(np.float32)
        x2 = rng.rand(B, T2, S, A1).astype(np.float32)
    else:
        x1 = rng.rand(B, T1, A1).astype(np.float32)
        x2 = rng.rand(B, T2, A1).astype(np.float32)
    x1 /= np.linalg.norm(x1, ord=2, axis=-1, keepdims=True)
    x2 /= np.linalg.norm(x2, ord=2, axis=-1, keepdims=True)
    with np.errstate(divide="ignore"):
        l1 = np.log(x1).astype(np.float32)
        l2 = np.log(x2).astype(np.float32)
    rg = np.zeros((B, Wre), np.float32)
    if crf:
        st = np.zeros((B,), np.int64)
        cur = np.zeros((B,), np.float32)
        for i in range(Wre - 1):
            cur = cur + l2[np.arange(B), i, st, 0]
            rg[:, i + 1] = cur
            st = (st * (A1 - 1)) % S
    else:
        rg[:, 1:] = np.cumsum(l2[:, : Wre - 1, 0], axis=1)
    lob = np.tile(lo_, (B, 1)).astype(np.int32)
    hib = np.tile(hi_, (B, 1)).astype(np.int32)
    return dict(l1=l1, l2=l2, root_gap=rg, lo=lob, hi=hib, W=We, Wr=Wre, Wext=Wxe, N=N,
                needs_ext=ne)


@pytest.mark.parametrize("crf", [False, True], ids=["plain", "crf"])
def test_micro_bench_equals_the_jax_tool(crf):
    B, T, w = 3, 60, 8
    inp = bench_exact_duplex.make_inputs(B, crf, T=T, w=w)
    want = _jax_tool_inputs(B, crf, T, w)
    for k in ("l1", "l2", "root_gap", "lo", "hi"):
        assert inp[k].dtype == want[k].dtype and inp[k].tobytes() == want[k].tobytes(), k
    assert (inp["W"], inp["N"], inp["needs_ext"]) == (want["W"], want["N"], want["needs_ext"])

    got = bench_exact_duplex.decode(inp, "cpu", crf)()
    ref = jax_duplex.duplex_exact_batch(
        want["l1"], want["l2"], want["root_gap"], want["lo"], want["hi"], np.float32(-np.inf),
        np.zeros(B, np.int32), np.full(B, T, np.int32), beam_size=5, collapse_repeats=not crf,
        max_nodes=want["N"], W=want["W"], Wr=want["Wr"], Wext=want["Wext"],
        needs_ext=want["needs_ext"], crf=crf)
    for f in ("labels_rev", "count", "err"):
        assert np.array_equal(got[f].numpy(), np.asarray(ref[f])), f
    assert (got["err"] == 0).all() and (got["count"] > 0).all()


def test_micro_bench_budgets_at_full_width():
    # T=500: the plain run keeps the JAX tool's 4096-node cap; the CRF run
    # takes the uncapped default, since JAX's own engine overflows the cap
    # on the tool's CRF pairs
    W = jax_duplex._prep_envelope(duplex_helpers.diag_env(500, 500, 40), 500)[2]
    full = jax_duplex._duplex_max_nodes(500, 5, 4, W)
    assert full > 4096
    assert bench_exact_duplex.make_inputs(1, False)["N"] == 4096
    assert bench_exact_duplex.make_inputs(1, True)["N"] == full
