"""The PyTorch port's CRF fast engine and CRF pipeline against the JAX package.

``fast_ctc_decode_tpu_torch.ops.beam_fast.crf_beam_search_fast_batch`` must
reproduce ``fast_ctc_decode_tpu.ops.beam_fast.crf_beam_search_fast_batch``
bit for bit (labels_rev, times_rev, count, err; int32, tolerance 0) with S
of 8, 9 (over three labels, so that every state (s*A) % S + a stays below
S) and 16 and -0.0 entries (the JAX engine picks each tip's row by a
one-hot masked sum, which turns -0.0 into +0.0; the port adds +0.0 to its
gathered row).  The fused Pallas kernel is matched once in interpret mode,
on an input where it agrees with its scan engine: on a few reads with a
cut above 0 it does not, and there the port follows the scan engine and
tests/oracle.py.
``BatchCrfBeamDecoder`` gives equal sequences across engines and equals the
JAX decoder; ``decode_many_crf`` resumes, from a JAX-written checkpoint too.
"""

import json

import numpy as np
import pytest
import torch

import oracle

from fast_ctc_decode_tpu.ops import beam_fast as jax_beam_fast
from fast_ctc_decode_tpu.ops import beam_pallas as jax_beam_pallas
from fast_ctc_decode_tpu.parallel import pipeline as jax_pipeline
from fast_ctc_decode_tpu_torch import errors
from fast_ctc_decode_tpu_torch.ops import beam_cuda
from fast_ctc_decode_tpu_torch.ops import beam_fast as port_beam_fast
from fast_ctc_decode_tpu_torch.parallel import pipeline as port_pipeline

torch.set_num_threads(1)

FIELDS = ("labels_rev", "times_rev", "count", "err")


def crf_batch(B, T, S, seed, A1=5):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, S, A1).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    init = rng.rand(B, S).astype(np.float32)
    return x, init / init.sum(axis=1, keepdims=True)


def run_port(x, init, lengths, thr, K=5):
    out = port_beam_fast.crf_beam_search_fast_batch(
        torch.from_numpy(x), torch.from_numpy(init), torch.from_numpy(lengths), thr,
        beam_size=K,
    )
    return {k: v.numpy() for k, v in out.items()}


def assert_same(want, got):
    for k in FIELDS:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.dtype == np.int32 and g.dtype == np.int32, k
        assert np.array_equal(w, g), k


def _case(name):
    """(probs, init, lengths, thr, beam_size) of one parity case."""
    full = lambda B, T: np.full((B,), T, np.int32)
    if name == "ragged_S8":
        x, init = crf_batch(4, 30, 8, 1)
        return x, init, np.array([30, 17, 4, 30], np.int32), 0.1, 5
    if name == "S9":
        x, init = crf_batch(3, 24, 9, 2, A1=4)
        return x, init, full(3, 24), 0.0, 5
    if name == "S16_neg_zero":
        x, init = crf_batch(3, 24, 16, 3)
        x[np.random.RandomState(4).rand(*x.shape) < 0.2] = -0.0
        init[:, 2] = -0.0
        return x, init, full(3, 24), 0.0, 5
    if name == "nan_and_empty":
        x, init = crf_batch(3, 20, 8, 5)
        x[1, 5, :, 2] = np.nan
        x[2] = 0.01  # all under the cut
        return x, init, full(3, 20), 0.19, 5
    if name == "zero_lengths":
        x, init = crf_batch(4, 16, 8, 6)
        return x, init, np.array([0, 16, 0, 5], np.int32), 0.1, 5
    if name.startswith("beam"):
        x, init = crf_batch(3, 20, 16, 7)
        return x, init, full(3, 20), 0.0, int(name[4:])
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["ragged_S8", "S9", "S16_neg_zero", "nan_and_empty", "zero_lengths", "beam8", "beam16"]
)
def test_crf_fast_equals_jax(name):
    x, init, lengths, thr, K = _case(name)
    want = jax_beam_fast.crf_beam_search_fast_batch(x, init, lengths, np.float32(thr), beam_size=K)
    got = run_port(x, init, lengths, thr, K)
    assert_same(want, got)
    if name == "nan_and_empty":
        assert list(got["err"]) == [0, errors.INCOMPARABLE_VALUES, errors.RAN_OUT_OF_BEAM]


def test_crf_fast_equals_interpret_pallas_once():
    # the JAX package's own CPU form of the fused CRF kernel
    x, init = crf_batch(3, 12, 9, 8, A1=4)
    lengths = np.array([12, 7, 12], np.int32)
    want = jax_beam_pallas.crf_beam_search_pallas_batch(
        x, init, lengths, np.float32(0.05), beam_size=5, block_t=8, block_b=8, interpret=True
    )
    assert_same(want, run_port(x, init, lengths, 0.05))


def test_crf_fast_follows_the_oracle_where_the_pallas_kernel_differs():
    # read 1 of this batch: the JAX Pallas CRF kernel (interpret mode)
    # decodes another sequence than its scan engine and the oracle
    rng = np.random.RandomState(1)
    x = rng.rand(3, 16, 8, 5).astype(np.float32)
    x /= x.sum(-1, keepdims=True)
    init = rng.rand(3, 8).astype(np.float32)
    lengths = np.full((3,), 16, np.int32)
    got = run_port(x, init, lengths, 0.1)
    assert_same(jax_beam_fast.crf_beam_search_fast_batch(x, init, lengths, np.float32(0.1), beam_size=5), got)
    n = got["count"][1]
    seq = "".join("NACGT"[l + 1] for l in got["labels_rev"][1, :n][::-1])
    assert seq == oracle.crf_beam_search(x[1], init[1], "NACGT", 5, 0.1)[0]
    pallas = jax_beam_pallas.crf_beam_search_pallas_batch(
        x, init, lengths, np.float32(0.1), beam_size=5, block_t=8, block_b=8, interpret=True
    )
    assert not np.array_equal(np.asarray(pallas["labels_rev"])[1], got["labels_rev"][1])


def test_crf_kernel_wrapper_on_cpu_runs_plain_version():
    x, init, lengths, thr, K = _case("S9")
    before = dict(beam_cuda.launches)
    got = beam_cuda.crf_beam_search_kernel_batch(
        torch.from_numpy(x), torch.from_numpy(init), torch.from_numpy(lengths), thr, beam_size=K
    )
    assert beam_cuda.launches == before  # nothing launched on the CPU
    assert_same(run_port(x, init, lengths, thr, K), got)
    ids, fin, err = beam_cuda.crf_beam_ids_kernel(
        torch.from_numpy(x), torch.from_numpy(init), torch.from_numpy(lengths), thr, beam_size=K
    )
    assert ids.shape == (24, K, 3) and fin.dtype == torch.int32 and err.tolist() == [0, 0, 0]


@pytest.mark.parametrize(
    "kwargs, exc",
    [
        (dict(beam_size=16), None),  # just fits: the widest instance
        (dict(beam_size=17), ValueError),  # just misses
        (dict(A1=8), None),
        (dict(A1=9), ValueError),
        (dict(init_dtype=torch.float64), TypeError),
    ],
)
def test_crf_kernel_wrapper_bounds(kwargs, exc):
    x, init = crf_batch(2, 6, 4, 9, A1=kwargs.get("A1", 5))
    args = (
        torch.from_numpy(x),
        torch.from_numpy(init).to(kwargs.get("init_dtype", torch.float32)),
        torch.full((2,), 6, dtype=torch.int32),
        0.0,
    )
    K = kwargs.get("beam_size", 5)
    if exc is None:
        assert beam_cuda.crf_beam_search_kernel_batch(*args, beam_size=K)["err"].tolist() == [0, 0]
    else:
        with pytest.raises(exc):
            beam_cuda.crf_beam_search_kernel_batch(*args, beam_size=K)


def test_batch_crf_decoder_engines_and_jax():
    B, T, S = 8, 16, 8
    x, init = crf_batch(B, T, S, 10)
    lengths = np.random.RandomState(11).randint(0, T + 1, size=B).astype(np.int32)
    lengths[[0, 3]] = T
    x[3, 2, :, 1] = np.nan  # one read errors, the batch goes on
    kw = dict(T=T, n_state=S, beam_size=5, beam_cut_threshold=0.05)
    want = jax_pipeline.BatchCrfBeamDecoder("NACGT", engine="fast", **kw).decode(x, init, lengths)
    fast = port_pipeline.BatchCrfBeamDecoder("NACGT", device="cpu", **kw)
    assert fast.engine == "fast"
    got = fast.decode(x, init, lengths)
    assert got == want
    assert got[3][2] == errors.INCOMPARABLE_VALUES
    exact = port_pipeline.BatchCrfBeamDecoder("NACGT", engine="exact", device="cpu", **kw)
    got_x = exact.decode(x, init, lengths)
    want_x = jax_pipeline.BatchCrfBeamDecoder("NACGT", engine="exact", **kw).decode(x, init, lengths)
    assert got_x == want_x
    # never equal paths across engines: only sequences and status codes
    assert [(s, e) for s, _, e in got_x] == [(s, e) for s, _, e in got]
    with pytest.raises(ValueError):
        port_pipeline.BatchCrfBeamDecoder("NACGT", engine="cuda", device="cpu", **kw)


def _crf_reads(n, S=4, seed=12):
    rng = np.random.RandomState(seed)
    reads = []
    for i, T in enumerate(rng.randint(3, 40, size=n)):
        x, init = crf_batch(1, int(T), S, 100 + i)
        reads.append((x[0], init[0]))
    return reads


def test_decode_many_crf_equals_jax_and_resumes(tmp_path):
    reads = _crf_reads(10)
    kw = dict(beam_size=5, beam_cut_threshold=0.05, batch_size=8)
    want = jax_pipeline.decode_many_crf(reads, "NACGT", engine="fast", **kw)
    got = port_pipeline.decode_many_crf(reads, "NACGT", device="cpu", **kw)
    assert got == want
    ckpt = str(tmp_path / "port.jsonl")
    reads[0] = reads[int(np.argmax([r[0].shape[0] for r in reads]))]  # same bucket edges
    full = port_pipeline.decode_many_crf(reads, "NACGT", device="cpu", **kw)
    port_pipeline.decode_many_crf(reads[:4], "NACGT", device="cpu", checkpoint_path=ckpt, **kw)
    assert port_pipeline.decode_many_crf(
        reads, "NACGT", device="cpu", checkpoint_path=ckpt, **kw
    ) == full


def test_decode_many_crf_resumes_a_jax_checkpoint(tmp_path):
    reads = _crf_reads(12, seed=13)
    reads[0] = reads[int(np.argmax([r[0].shape[0] for r in reads]))]  # same bucket edges
    kw = dict(beam_size=5, beam_cut_threshold=0.05, batch_size=8)
    ckpt = str(tmp_path / "run.jsonl")
    full = jax_pipeline.decode_many_crf(reads, "NACGT", engine="fast", **kw)
    # preempted JAX run: the first reads land in the checkpoint
    jax_pipeline.decode_many_crf(reads[:5], "NACGT", engine="fast", checkpoint_path=ckpt, **kw)
    with open(ckpt) as f:
        lines_before = len(f.read().splitlines())
    resumed = port_pipeline.decode_many_crf(
        reads, "NACGT", engine="fast", device="cpu", checkpoint_path=ckpt, **kw
    )
    assert resumed == full
    with open(ckpt) as f:
        lines = f.read().splitlines()
    assert json.loads(lines[0])["meta"]["engine"] == "fast"
    assert len(lines) > lines_before  # the port decoded only the rest
    done = [i for line in lines[lines_before:] for i in json.loads(line)["i"]]
    assert sorted(done) == list(range(5, 12))


def test_decode_many_crf_resumes_a_jax_auto_checkpoint(tmp_path):
    # JAX's decode_many_crf writes the engine as given: null for auto; the
    # port writes the engine it resolves ("fast" here) and still resumes it
    reads = _crf_reads(10, seed=17)
    reads[0] = reads[int(np.argmax([r[0].shape[0] for r in reads]))]  # same bucket edges
    kw = dict(beam_size=5, beam_cut_threshold=0.05, batch_size=4)
    ckpt = str(tmp_path / "run.jsonl")
    full = jax_pipeline.decode_many_crf(reads, "NACGT", **kw)
    jax_pipeline.decode_many_crf(reads[:4], "NACGT", checkpoint_path=ckpt, **kw)
    with open(ckpt) as f:
        assert json.loads(f.readline())["meta"]["engine"] is None
    resumed = port_pipeline.decode_many_crf(reads, "NACGT", device="cpu", checkpoint_path=ckpt, **kw)
    assert resumed == full
    with pytest.raises(ValueError, match="different decode"):
        port_pipeline.decode_many_crf(reads, "NACGT", engine="exact", device="cpu",
                                      checkpoint_path=ckpt, **kw)
