"""``decode_many_crf_duplex``: the CRF duplex stream over pairs of varied
lengths.

Its sequences and statuses equal, pair for pair, the JAX package's
``BatchCrfDuplexDecoder`` (engine ``exact``), ``tests/oracle.py`` and the
benchmark's plain reference (``ctcbench/reference/crf_duplex.py``), on
jagged envelopes over two (T1, T2) buckets at S = 16 and 64.  Pairs given as
tensors on the decoding device take the device path (the logs and the pad
written there, ``prep_duplex_batch`` on ``LogScores``): its prepared batch
equals the host path's (``lo``, ``hi``, ``W`` and ``init_states``
exactly; ``l1``/``l2`` within 1 ulp of the correctly rounded log, which the
host path takes too, and bit for bit the host's on the CPU; ``root_gap``
bit for bit what the host sums from the same logs) and its results equal
the host path's, also on a pair of 600 frames whose two reads read out one
sequence (its logs compared at the cell's longest read, 18,107 frames).  A
half-written checkpoint resumes to the same rows, the two counters hold the
real and the bucket-padded frames.  The ``card`` case holds the CRF tree
kernel to the plain engine at S = 1,024 on the same log inputs, bit for bit,
and the on-card prep to the host prep; its skip lives in this file, so it
runs on a card's machine without the JAX package's conftest:

    python -m pytest tests/test_torch_crf_duplex_many.py -q                          # here
    python -m pytest --noconftest tests/test_torch_crf_duplex_many.py -q -m card     # on a card
"""

import json

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu_torch import decode_many_crf_duplex
from fast_ctc_decode_tpu_torch.ops import duplex_fast
from fast_ctc_decode_tpu_torch.parallel import pipeline
from fast_ctc_decode_tpu_torch.utils import profiling

torch.set_num_threads(1)

ALPHA = "NACGT"
KW = dict(beam_size=5, beam_cut_threshold=0.0)
#: (T1, T2) of the pairs: auto edges [128, 200] x [128, 190], two buckets (the
#: S = 64 case takes the middle three: [128, 150] x [128, 145])
LENGTHS = [(20, 22), (60, 57), (100, 108), (150, 145), (200, 190)]


def jagged_env(T1, T2, seed):
    """A moving envelope on the diagonal, its half-width 2-5 frames a row,
    fixed to the upstream validity rules (monotone bounds, each lower bound
    at most the previous upper one, at least one frame)."""
    rng = np.random.RandomState(seed)
    c = (np.arange(T1) * T2 / T1).astype(np.int64)
    w = rng.randint(2, 6, T1)
    lo = np.maximum.accumulate(np.maximum(c - w, 0))
    hi = np.maximum.accumulate(np.minimum(c + w + 1, T2))
    lo = np.minimum(lo, np.concatenate([[0], hi[:-1]]))
    hi = np.maximum(hi, lo + 1)
    return np.stack([lo, hi], 1)


def crf_read(rng, T, S):
    x = rng.rand(T, S, 5).astype(np.float32)
    return x / x.sum(-1, keepdims=True), rng.rand(S).astype(np.float32)


def make_pairs(S, lengths=LENGTHS, seed=0):
    rng = np.random.RandomState(seed + S)
    out = []
    for k, (t1, t2) in enumerate(lengths):
        (n1, i1), (n2, i2) = crf_read(rng, t1, S), crf_read(rng, t2, S)
        out.append((n1, i1, n2, i2, jagged_env(t1, t2, seed + k)))
    return out


def on(pairs, device):
    """The pairs' posteriors and init states as tensors on ``device``."""
    return [tuple(torch.as_tensor(x, device=device) for x in p[:4]) + tuple(p[4:])
            for p in pairs]


def decode(pairs, device="cpu", **kw):
    return decode_many_crf_duplex(pairs, ALPHA, device=device, **KW, **kw)


@pytest.fixture(scope="module")
def runs():
    """Each case's pairs and rows: the host path at S = 16 and 64, with the
    counters of its run, and the device path (CPU tensors) at S = 16."""
    out = {}
    for S, lengths in ((16, LENGTHS), (64, LENGTHS[1:4])):
        pairs = make_pairs(S, lengths)
        counts = profiling.reset_metrics().counts
        out[S] = dict(pairs=pairs, host=decode(pairs), counts=dict(counts))
    out[16]["device"] = decode(on(out[16]["pairs"], "cpu"))
    return out


def padded(pairs, T1, T2):
    """The pairs zero-padded to one ``[B, T1|T2, S, A+1]`` batch, envelope
    rows past read 1 repeating its last, and read 1's lengths."""
    B, S = len(pairs), pairs[0][0].shape[1]
    n1, n2 = np.zeros((B, T1, S, 5), np.float32), np.zeros((B, T2, S, 5), np.float32)
    envs = np.zeros((B, T1, 2), np.int64)
    for b, (x1, _, x2, _, env) in enumerate(pairs):
        n1[b, : len(x1)], n2[b, : len(x2)] = x1, x2
        envs[b, : len(x1)], envs[b, len(x1):] = env, env[-1]
    i1 = np.stack([p[1] for p in pairs])
    i2 = np.stack([p[3] for p in pairs])
    return n1, i1, n2, i2, envs, np.array([len(p[0]) for p in pairs], np.int32)


def test_equals_the_jax_batch_decoder(runs):
    from fast_ctc_decode_tpu.parallel.pipeline import BatchCrfDuplexDecoder as JaxDecoder

    pairs = runs[16]["pairs"]
    T1, T2 = max(p[0].shape[0] for p in pairs), max(p[2].shape[0] for p in pairs)
    n1, i1, n2, i2, envs, lengths = padded(pairs, T1, T2)
    want = JaxDecoder(ALPHA, T1=T1, T2=T2, n_state=16, engine="exact", **KW).decode(
        n1, i1, n2, i2, envelopes=envs, lengths=lengths)
    assert [tuple(w) for w in want] == runs[16]["host"] == runs[16]["device"]


@pytest.mark.parametrize("S", [16, 64])
def test_equals_the_oracle_and_the_benchmark_reference(runs, S):
    import oracle
    from ctcbench.reference.crf_duplex import search

    pairs, got = runs[S]["pairs"], runs[S]["host"]
    want = [oracle.crf_beam_search_duplex(*p[:4], ALPHA, envelope=p[4], **KW) for p in pairs]
    assert [g[0] for g in got] == want and all(g[1] == 0 for g in got)
    decode_settings = dict(alphabet=ALPHA, **KW)
    assert [search(*p, decode_settings) for p in pairs] == [(e, s) for s, e in got]


def test_device_path_decodes_as_the_host_path(runs):
    assert runs[16]["device"] == runs[16]["host"]


def test_batches_on_the_device_are_log_scores_and_others_host_arrays():
    pairs = make_pairs(16, LENGTHS[:3])
    dev = pipeline._pad_crf_duplex(torch.device("cpu"), on(pairs, "cpu"), [0, 1, 2], (128, 128))
    assert isinstance(dev[0], pipeline.LogScores) and isinstance(dev[2], pipeline.LogScores)
    assert dev[0].logs.shape == (3, 128, 16, 5) and dev[2].logs.shape == (3, 128, 16, 5)
    assert torch.isneginf(dev[0].logs[0, 20:]).all() and torch.isneginf(dev[2].logs[1, 57:]).all()
    # one pair on the host makes the whole batch a host batch
    mixed = on(pairs, "cpu")
    mixed[1] = pairs[1]
    host = pipeline._pad_crf_duplex(torch.device("cpu"), mixed, [0, 1, 2], (128, 128))
    assert all(isinstance(x, np.ndarray) for x in host)
    assert host[0].shape == (3, 128, 16, 5) and (host[0][0, 20:] == 0).all()


def ulps(a, b):
    """Largest distance of two float32 arrays in units in the last place
    (``-inf`` where both are ``-inf`` counts 0)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    keep = ~np.isneginf(a)
    ia = a[keep].view(np.int32).astype(np.int64)
    ib = b[keep].view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max(initial=0))


def exact_log(x):
    """float32 ``log`` correctly rounded (computed in float64)."""
    with np.errstate(divide="ignore"):
        return np.log(np.asarray(x, np.float64)).astype(np.float32)


def preps(pairs, device, edges):
    """The padded arguments and prepared batch of ``pairs`` by the device
    path (tensors on ``device``) and by the host path."""
    idx = list(range(len(pairs)))
    got = []
    for ps in (on(pairs, device), pairs):
        args = pipeline._pad_crf_duplex(torch.device(device), ps, idx, edges)
        n1, i1, n2, i2, envs, lengths = args
        got.append((args, pipeline.prep_duplex_batch(
            n1, n2, envs, lengths, 0.01, T1=edges[0], T2=edges[1], init1=i1, init2=i2)))
    return got


def assert_same_prep(device_prep, host_prep):
    """The two preparations agree: envelopes, lengths, init states and
    static arguments equal; the host's logs the correctly rounded log, the
    device's within 1 ulp of it (two float64 logs may differ in their last
    bit), and its root bands those ``crf_root_gap_host`` sums from them.
    Returns the largest ulp distance of the two paths' logs."""
    (_, dev), ((h1, i1, h2, i2, envs, _), host) = device_prep, host_prep
    assert isinstance(dev.l1, torch.Tensor) and isinstance(host.l1, np.ndarray)
    for f in ("lo", "hi", "lengths"):
        np.testing.assert_array_equal(getattr(dev, f), getattr(host, f), err_msg=f)
    np.testing.assert_array_equal(dev.init_states.cpu().numpy(), host.init_states)
    assert (dev.W, dev.thr, dev.needs_ext, dev.tree_needs_ext) == \
        (host.W, host.thr, host.needs_ext, host.tree_needs_ext)
    l1, l2 = dev.l1.cpu().numpy(), dev.l2.cpu().numpy()
    assert np.array_equal(host.l1, exact_log(h1)) and np.array_equal(host.l2, exact_log(h2))
    assert ulps(l1, host.l1) <= 1 and ulps(l2, host.l2) <= 1
    wr_b = duplex_fast.prep_envelopes(envs, h2.shape[1]).Wr
    np.testing.assert_array_equal(
        dev.root_gap, duplex_fast.crf_root_gap_host(l2, i2, wr_b, dev.root_gap.shape[1]))
    assert dev.root_gap.shape == host.root_gap.shape
    return max(ulps(l1, host.l1), ulps(l2, host.l2))


@pytest.mark.parametrize("S", [16, 64])
def test_device_prep_equals_host_prep(S):
    pairs = make_pairs(S, LENGTHS[:4], seed=7)
    dev, host = preps(pairs, "cpu", (150, 256))
    assert assert_same_prep(dev, host) == 0
    np.testing.assert_array_equal(dev[1].root_gap, host[1].root_gap)
    dev, host = dev[1], host[1]
    # nothing of a batch on the device is copied, nor counted as still to come
    args = dev.tensors("cpu")
    assert args[0] is not dev.l1 and args[0].data_ptr() == dev.l1.data_ptr()
    assert dev.nbytes("cpu") == sum(x.nbytes for x in (dev.root_gap, dev.lo, dev.hi,
                                                       dev.lengths)) + 2 * 4 * 4 * (150 + 2)
    assert host.nbytes("cpu") == host.nbytes()


def test_a_long_pair_decodes_alike_on_both_paths():
    from ctcbench import spec
    from ctcbench.drivers.common import generator
    from ctcbench.gen import crf_pairs

    c = spec.resolve("crf_duplex.pairs").config
    pairs, hidden = crf_pairs.crf_duplex_pairs(
        [18107, 600], [18502, 661], 16, c["posteriors"], {"half_width": 4, "jitter": 2},
        generator(2**31 + 5, "cpu"), "cpu")
    host = [tuple(x.numpy() if isinstance(x, torch.Tensor) else x for x in p) for p in pairs]
    # the cell's longest read: both paths hand the decoder the same logs
    dev, hp = preps(host[:1], "cpu", (32768, 32768))
    assert assert_same_prep(dev, hp) == 0
    np.testing.assert_array_equal(dev[1].root_gap, hp[1].root_gap)
    # a pair of 600 frames decodes alike, to about its hidden sequence
    kw = dict(beam_size=5, beam_cut_threshold=0.01, device="cpu")
    got = decode_many_crf_duplex(host[1:], ALPHA, **kw)
    assert got == decode_many_crf_duplex(pairs[1:], ALPHA, **kw)
    assert got[0][1] == 0 and len(got[0][0]) > 0.9 * len(hidden["bases"][1])


def test_counters_hold_real_and_bucket_padded_frames(runs):
    pairs = runs[16]["pairs"]
    real = sum(p[0].shape[0] + p[2].shape[0] for p in pairs)
    # buckets (128, 128) of 3 pairs and (200, 190) of 2
    assert runs[16]["counts"] == {"decode_many_crf_duplex.frames": real,
                                  "decode_many_crf_duplex.batch_frames": 3 * 256 + 2 * 390}


def test_half_written_checkpoint_resumes_to_the_same_rows(tmp_path, runs):
    pairs = runs[16]["pairs"][:2]
    ck = str(tmp_path / "ck.jsonl")
    full = decode(pairs, batch_size=1, checkpoint_path=ck)
    assert full == runs[16]["host"][:2]
    lines = open(ck).read().splitlines()
    meta = json.loads(lines[0])["meta"]
    assert meta == {"duplex": True, "crf": True, "n_state": 16, "bucket_edges": [[60], [57]],
                    "beam_size": 5, "beam_cut_threshold": 0.0, "collapse_repeats": False,
                    "engine": None}
    # the first batch written whole, the second cut mid-line
    open(ck, "w").write("\n".join(lines[:2]) + "\n" + lines[2][:10])
    counts = profiling.reset_metrics().counts
    assert decode(on(pairs, "cpu"), batch_size=1, checkpoint_path=ck) == full
    assert counts["decode_many_crf_duplex.frames"] == sum(
        p[0].shape[0] + p[2].shape[0] for p in pairs[1:])
    with pytest.raises(ValueError, match="different decode parameters"):
        decode_many_crf_duplex(pairs, ALPHA, beam_size=4, device="cpu", checkpoint_path=ck)


@pytest.fixture
def card():
    """The CUDA card, decided inside the test (every worker collects the same
    tests); skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the test runs only on one")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_tree_kernel_at_sup_width_equals_the_plain_engine(card):
    from fast_ctc_decode_tpu_torch.ops import duplex_exact_cuda

    S = 1024
    pairs = make_pairs(S, [(40, 44), (64, 60), (90, 96)], seed=3)
    dev, host = preps(pairs, card, (128, 128))
    print(f"largest ulp distance of the card's logs from numpy's: {assert_same_prep(dev, host)}")
    dev = dev[1]
    K = 5
    N = dev.max_nodes(K)
    kw = dict(beam_size=K, collapse_repeats=False, max_nodes=N, W=dev.W,
              needs_ext=dev.tree_needs_ext, crf=True)
    got = duplex_exact_cuda.duplex_exact_kernel_batch(*dev.tensors(card), **kw)
    want = duplex_exact_cuda.duplex_exact_plain(*dev.tensors("cpu"), **kw)
    for k in ("labels_rev", "count", "err"):
        assert torch.equal(got[k].cpu(), want[k]), k
    assert decode(on(pairs, card), device=card) == decode(pairs, device=card)
