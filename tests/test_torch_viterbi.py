"""The PyTorch port's viterbi, phred and CRF greedy decoders against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tokens, paths and counts must be equal (tolerance 0); phred integers are
equal on these seeds (both sides round f32 ``log10`` results, which agree
here; a last-ulp difference could move a value sitting on a .5 boundary).
"""

import jax
import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu import api as jax_api
from fast_ctc_decode_tpu.ops import crf as jax_crf
from fast_ctc_decode_tpu.ops import phred as jax_phred
from fast_ctc_decode_tpu.ops import viterbi as jax_viterbi
from fast_ctc_decode_tpu.parallel import pipeline as jax_pipeline
from fast_ctc_decode_tpu_torch import api as port_api
from fast_ctc_decode_tpu_torch.ops import crf as port_crf
from fast_ctc_decode_tpu_torch.ops import phred as port_phred
from fast_ctc_decode_tpu_torch.ops import viterbi as port_viterbi
from fast_ctc_decode_tpu_torch.parallel import pipeline as port_pipeline

torch.set_num_threads(1)


def rand_batch(B, T, A1, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=-1, keepdims=True)


def ragged_lengths(B, T, seed):
    lengths = np.random.RandomState(seed).randint(0, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return lengths


@pytest.mark.parametrize("qscale, qbias", [(1.0, 0.0), (0.7, 2.5)])
def test_phred_twins_equal_jax(qscale, qbias):
    rng = np.random.RandomState(0)
    p = rng.rand(4096).astype(np.float32)
    p[:8] = [0.0, 1.0, 0.9999, 0.99995, 0.5, 1e-7, 0.999, 0.9]
    want = np.asarray(jax_phred.phred_int(p, qscale, qbias))
    got = port_phred.phred_int(torch.from_numpy(p), qscale, qbias).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(port_phred.phred_int_np(p, qscale, qbias), jax_phred.phred_int_np(p, qscale, qbias))
    assert port_phred.phred_char(0.99) == jax_phred.phred_char(0.99)


def test_viterbi_core_first_max_and_nan():
    x = rand_batch(1, 64, 5, 1)[0]
    x[3] = [0.2, 0.4, 0.4, 0.1, 0.0]  # tie: the first max wins
    x[7, 2] = np.nan  # a NaN counts as the maximum
    x[9] = [0.3, 0.3, 0.3, 0.3, 0.3]
    want_l, want_p = jax_viterbi.viterbi_core(x)
    got_l, got_p = port_viterbi.viterbi_core(torch.from_numpy(x))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))
    assert np.array_equal(got_p.numpy(), np.asarray(want_p), equal_nan=True)


@pytest.mark.parametrize("collapse", [True, False])
def test_viterbi_device_batch_equals_jax(collapse):
    B, T = 8, 50
    x = rand_batch(B, T, 5, 2)
    x[:, ::3, 0] += 0.5  # blank runs between emits
    x[2, 10:14] = x[2, 10]  # a collapsed repeat run
    lengths = ragged_lengths(B, T, 3)
    fn = jax.vmap(
        lambda p, n: jax_viterbi.viterbi_device(
            p, n, np.float32(0.8), np.float32(1.5), collapse_repeats=collapse
        )
    )
    want = {k: np.asarray(v) for k, v in fn(x, lengths).items()}
    got = port_viterbi.viterbi_device_batch(
        torch.from_numpy(x), torch.from_numpy(lengths), 0.8, 1.5, collapse_repeats=collapse
    )
    for k in ("tokens", "path", "n"):
        assert got[k].dtype == torch.int32, k
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert np.array_equal(got["qints"].numpy(), want["qints"].astype(np.int64))


def long_run_batch(B, T, seed, run=(20, 60)):
    """Posteriors whose argmax keeps one label for long stretches (collapsed
    runs of 20-60 frames) with blank frames sprinkled in, ragged lengths."""
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, 5).astype(np.float32) * 0.2
    for b in range(B):
        t = 0
        while t < T:
            n = rng.randint(*run)
            x[b, t:t + n, rng.randint(1, 5)] += 1.0
            t += n
        x[b, rng.rand(T) < 0.1, 0] += 2.0  # a blank inside a run does not end it
    return x / np.linalg.norm(x, ord=2, axis=-1, keepdims=True), ragged_lengths(B, T, seed + 1)


def sequential_run_means(labels, pmax, seg):
    """Each segment's f32 sum of non-blank frames added left to right from 0,
    over its non-blank count (at least 1): the reference's order."""
    B, T = labels.shape
    out = np.zeros((B, T), np.float32)
    for b in range(B):
        sums = np.zeros(T, np.float32)
        cnts = np.zeros(T, np.float32)
        for t in range(T):
            g = max(int(seg[b, t]), 0)
            if labels[b, t] != 0:
                sums[g] = np.float32(sums[g] + pmax[b, t])
                cnts[g] = np.float32(cnts[g] + np.float32(1.0))
        out[b] = sums / np.maximum(cnts, np.float32(1.0))
    return out


@pytest.mark.parametrize("collapse", [True, False])
def test_run_means_add_in_frame_order(collapse):
    """``viterbi_cuda.run_means`` (the CUDA kernel's plain version on the
    CPU) sums every run left to right, bit for bit: equal to a sequential
    f32 loop and to JAX's ``segment_sum`` on ragged reads with long collapsed
    runs.  (``np.add.reduceat`` is no reference for this: it does not add an
    f32 run left to right once the run has 3 or more terms.)"""
    from fast_ctc_decode_tpu_torch.ops import viterbi_cuda

    x, lengths = long_run_batch(6, 300, 11)
    labels, pmax, emit, seg = port_viterbi.frame_runs(
        torch.from_numpy(x), torch.from_numpy(lengths), collapse_repeats=collapse)
    got = viterbi_cuda.run_means(labels, pmax, *port_viterbi.emit_path(emit, seg)).numpy()
    L, Pm, S = labels.numpy(), pmax.numpy(), seg.numpy()
    want = sequential_run_means(L, Pm, S)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    nz = L != 0
    for b in range(L.shape[0]):
        contrib = np.where(nz[b], Pm[b], np.float32(0))
        g = np.maximum(S[b], 0)
        sums = np.asarray(jax.ops.segment_sum(contrib, g, num_segments=L.shape[1]))
        cnts = np.asarray(jax.ops.segment_sum(nz[b].astype(np.float32), g, num_segments=L.shape[1]))
        assert np.array_equal(got[b].view(np.int32),
                              (sums / np.maximum(cnts, np.float32(1))).view(np.int32))
    assert int((L != 0).sum(1).max()) > 100  # long runs were there to sum


def test_viterbi_qints_equal_jax_on_long_runs():
    x, lengths = long_run_batch(5, 240, 21)
    fn = jax.vmap(lambda p, n: jax_viterbi.viterbi_device(p, n, np.float32(1.0), np.float32(0.0)))
    want = {k: np.asarray(v) for k, v in fn(x, lengths).items()}
    got = port_viterbi.viterbi_device_batch(torch.from_numpy(x), torch.from_numpy(lengths), 1.0, 0.0)
    for k in ("tokens", "path", "n"):
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert np.array_equal(got["qints"].numpy(), want["qints"].astype(np.int64))


@pytest.mark.parametrize("qstring", [False, True])
def test_batch_viterbi_decoder_equals_jax(qstring):
    B, T = 8, 40
    x = rand_batch(B, T, 5, 4)
    lengths = ragged_lengths(B, T, 5)
    want = jax_pipeline.BatchViterbiDecoder("NACGT", T=T).decode(x, lengths, qstring=qstring)
    got = port_pipeline.BatchViterbiDecoder("NACGT", T=T, device="cpu").decode(
        x, lengths, qstring=qstring
    )
    assert got == want


def _crf_inputs(B, T, S, seed, Si=None):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, S, 5).astype(np.float32)
    x /= x.sum(axis=-1, keepdims=True)
    init = rng.rand(B, S if Si is None else Si).astype(np.float32)
    return x, init


@pytest.mark.parametrize("case", ["ragged_S8", "nan_and_state_out_of_range"])
def test_crf_greedy_batch_equals_jax(case):
    B, T = 4, 30
    if case == "ragged_S8":
        x, init = _crf_inputs(B, T, 8, 6)
        lengths = ragged_lengths(B, T, 7)
    else:
        x, init = _crf_inputs(B, T, 8, 8, Si=11)
        init[1, 9] = 5.0  # argmax 9 >= S: the JAX take reads a NaN row
        x[2, 4, :, 1] = np.nan
        lengths = np.full((B,), T, np.int32)
    got = port_crf.crf_greedy_batch(
        torch.from_numpy(x), torch.from_numpy(init), torch.from_numpy(lengths), 0.9, 0.5
    )
    for b in range(B):
        want = jax_crf.crf_greedy_device(
            x[b], init[b], np.int32(lengths[b]), np.float32(0.9), np.float32(0.5)
        )
        for k in ("tokens", "path", "n", "qints"):
            assert np.array_equal(got[k][b].numpy(), np.asarray(want[k]).astype(got[k].numpy().dtype)), (b, k)
        assert np.array_equal(got["pvals"][b].numpy(), np.asarray(want["pvals"]), equal_nan=True), b


@pytest.mark.parametrize("alphabet", ["NACGT", ["N", "AAA", "CCC", "GGG", "TTTT"]])
def test_api_viterbi_and_crf_greedy_equal_jax(alphabet):
    x = rand_batch(1, 100, 5, 9)[0]
    for qstring in (False, True):
        for collapse in (True, False):
            kw = dict(qstring=qstring, qscale=0.9, qbias=0.3, collapse_repeats=collapse)
            assert port_api.viterbi_search(x, alphabet, **kw, device="cpu") == jax_api.viterbi_search(
                x, alphabet, **kw)
    c, init = _crf_inputs(1, 40, 16, 10)
    for qstring in (False, True):
        assert port_api.crf_greedy_search(c[0], init[0], alphabet, qstring, device="cpu") == jax_api.crf_greedy_search(
            c[0], init[0], alphabet, qstring
        )
