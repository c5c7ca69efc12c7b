"""The PyTorch port's band-reuse (exact) duplex tree engine, plain and CRF,
against the JAX package.

Contract: ``fast_ctc_decode_tpu_torch.ops.duplex.duplex_exact_batch`` equals
``fast_ctc_decode_tpu.ops.duplex.duplex_exact_batch`` bit for bit on the
whole output dict (labels_rev, count, err; int32, tolerance 0): both build
band cells sequentially in the reference's order, so the values are the
same and so is every decision.  Cases: the full range, diagonal, dipping
and non-monotone envelopes, per-pair envelopes, an invalid envelope,
zero-probability rows, a NaN, ragged and zero lengths, beam 1, a small
``max_nodes`` (NODE_OVERFLOW), CRF with S=16 and S=9 (three labels).  The
engine also equals ``tests/oracle.py`` on every envelope the oracle accepts
(it asserts a growing band end, so not the dipping upper bound), and the JAX
package's Pallas tree kernel, run once in interpret mode, gives the same
sequences.  The wrapper of the CUDA tree kernel (``ops/duplex_exact_cuda.py``)
runs the plain engine on CPU tensors and refuses inputs beyond its bounds.
"""

import numpy as np
import pytest
import torch

import oracle
from duplex_helpers import diag_env, random_data
from fast_ctc_decode_tpu.ops import duplex as jax_dx
from fast_ctc_decode_tpu.ops import duplex_exact_pallas as jax_dxp
from fast_ctc_decode_tpu_torch import errors
from fast_ctc_decode_tpu_torch.ops import duplex as port_dx
from fast_ctc_decode_tpu_torch.ops import duplex_exact_cuda
from fast_ctc_decode_tpu_torch.ops import duplex_fast as port_df

torch.set_num_threads(1)

T1, T2, B = 16, 18, 3
ALPHA = "NACGT"
FIELDS = ("labels_rev", "count", "err")


def pairs(seed, A1=5, b=B):
    n1 = np.stack([random_data(T1, A1, seed * 10 + i) for i in range(b)])
    n2 = np.stack([random_data(T2, A1, 700 + seed * 10 + i) for i in range(b)])
    return n1, n2


def crf_pairs(seed, S, A1, b=B, t1=12, t2=14):
    rng = np.random.RandomState(seed)
    n1 = rng.rand(b, t1, S, A1).astype(np.float32)
    n2 = rng.rand(b, t2, S, A1).astype(np.float32)
    n1 /= n1.sum(-1, keepdims=True)
    n2 /= n2.sum(-1, keepdims=True)
    return n1, rng.rand(b, S).astype(np.float32), n2, rng.rand(b, S).astype(np.float32)


def full_env(t1=T1, t2=T2):
    return np.stack([np.zeros(t1, np.int64), np.full(t1, t2, np.int64)], 1)


def prepared(n1, n2, envs, thr, crf_inits=None, K=5, N=None):
    """Both engines' inputs, as the JAX pipeline's ``_exact_engine_out``."""
    b, t1 = n1.shape[:2]
    t2 = n2.shape[1]
    envs = np.broadcast_to(envs, (b, t1, 2)) if envs.ndim == 2 else envs
    eps = [jax_dx._prep_envelope(np.asarray(e), t2) for e in envs]
    W = max(e[2] for e in eps)
    Wr = max(e[3] for e in eps)
    l1, l2, lt = port_df.log_inputs(n1, n2, thr)
    if crf_inits is None:
        rg = port_df.root_gap_host(l2, [e[3] for e in eps], Wr)
        init = np.zeros(b, np.int32)
    else:
        rg = port_df.crf_root_gap_host(l2, crf_inits[1], [e[3] for e in eps], Wr)
        init = np.argmax(crf_inits[0], 1).astype(np.int32)
    N = N or jax_dx._duplex_max_nodes(t1, K, n1.shape[-1] - 1, W)
    static = dict(W=W, needs_ext=any(e[4] for e in eps), max_nodes=N)
    return (l1, l2, rg, np.stack([e[0] for e in eps]), np.stack([e[1] for e in eps]), lt,
            init), static, max(e[5] for e in eps), Wr


def run_both(n1, n2, envs, thr=0.0, K=5, collapse=True, lengths=None, crf_inits=None, N=None):
    args, static, Wext, Wr = prepared(n1, n2, envs, thr, crf_inits, K, N)
    b = n1.shape[0]
    lengths = np.full((b,), n1.shape[1], np.int32) if lengths is None else np.asarray(lengths, np.int32)
    crf = crf_inits is not None
    want = jax_dx.duplex_exact_batch(
        *args, lengths, beam_size=K, collapse_repeats=collapse, Wr=Wr, Wext=Wext, crf=crf,
        **static,
    )
    T = torch.from_numpy
    targs = [T(x) if isinstance(x, np.ndarray) else x for x in args]
    got = port_dx.duplex_exact_batch(
        *targs, T(lengths), beam_size=K, collapse_repeats=collapse, crf=crf, **static
    )
    for k in FIELDS:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert w.dtype == g.dtype == np.int32, k
        assert np.array_equal(w, g), k
    return got


def seqs(out):
    return [
        ("".join(ALPHA[int(l) + 1] for l in np.asarray(out["labels_rev"][b])[: int(out["count"][b])][::-1]),
         int(out["err"][b]))
        for b in range(len(out["count"]))
    ]


def dipping_env():
    env = diag_env(T1, T2, 3)
    env[6:9, 1] -= 2
    env[:, 1] = np.maximum(env[:, 1], env[:, 0] + 1)
    return env


def nonmonotone_env():
    env = diag_env(T1, T2, 4)
    env[9, 0] = max(env[9, 0] - 2, 0)
    return env


@pytest.mark.parametrize(
    "name,env",
    [
        ("full", full_env()),
        ("diag", diag_env(T1, T2, 3)),
        ("dipping_upper", dipping_env()),
        ("nonmonotone_lower", nonmonotone_env()),
    ],
)
def test_exact_equals_jax_and_oracle(name, env):
    n1, n2 = pairs(1)
    got = seqs(run_both(n1, n2, env))
    if name == "dipping_upper":
        return  # the oracle asserts a growing band end (cur_end < hi) there
    for b in range(B):
        assert got[b] == (oracle.beam_search_duplex(n1[b], n2[b], ALPHA, envelope=env), 0)


def test_exact_equals_jax_edge_inputs():
    n1, n2 = pairs(2)
    n1[0, 3:5] = 0.0  # zero-probability rows keep the beam
    n2[1, 5:8] = 0.0
    n1[2, 6, 2] = np.nan
    got = seqs(run_both(n1, n2, diag_env(T1, T2, 3)))
    assert got[0][1] == errors.OK and got[1][1] == errors.OK
    assert got[2][1] == errors.INCOMPARABLE_VALUES
    assert got[0] == (oracle.beam_search_duplex(n1[0], n2[0], ALPHA, envelope=diag_env(T1, T2, 3)), 0)


def test_exact_equals_jax_invalid_ragged_per_pair_beam1():
    n1, n2 = pairs(3)
    bad = diag_env(T1, T2, 3)
    bad[5, 1] = bad[5, 0]
    envs = np.stack([bad, diag_env(T1, T2, 2), diag_env(T1, T2, 5)])
    got = seqs(run_both(n1, n2, envs, thr=0.05, collapse=False, lengths=[16, 0, 9]))
    assert got[0][1] == errors.INVALID_ENVELOPE and got[1] == ("", errors.OK)
    got = seqs(run_both(n1, n2, diag_env(T1, T2, 3), K=1))
    assert {e for _, e in got} == {errors.OK}


def test_exact_equals_jax_node_overflow():
    n1, n2 = pairs(4)
    got = run_both(n1, n2, diag_env(T1, T2, 3), N=20)
    assert set(got["err"].tolist()) == {errors.NODE_OVERFLOW}


@pytest.mark.parametrize("S,A1", [(16, 5), (9, 4)])
def test_crf_exact_equals_jax_and_oracle(S, A1):
    n1, i1, n2, i2 = crf_pairs(5 + S, S, A1)
    env = diag_env(12, 14, 3)
    got = seqs(run_both(n1, n2, env, crf_inits=(i1, i2)))
    for b in range(B):
        want = oracle.crf_beam_search_duplex(n1[b], i1[b], n2[b], i2[b], ALPHA[:A1], envelope=env)
        assert got[b] == (want, 0)


def test_jax_pallas_tree_kernel_interpret_equals_port():
    n1, n2 = pairs(6)
    env = diag_env(T1, T2, 3)
    args, static, _, _ = prepared(n1, n2, env, 0.0)
    lengths = np.full((B,), T1, np.int32)
    po = jax_dxp.duplex_exact_pallas_batch(
        *args, lengths, beam_size=5, collapse_repeats=True, max_nodes=static["max_nodes"],
        crf=False, needs_ext=static["needs_ext"], interpret=True,
    )
    T = torch.from_numpy
    targs = [T(x) if isinstance(x, np.ndarray) else x for x in args]
    got = duplex_exact_cuda.duplex_exact_kernel_batch(
        *targs, T(lengths), beam_size=5, collapse_repeats=True, crf=False, **static
    )
    assert seqs({k: v.numpy() for k, v in got.items()}) == seqs(po)


def test_kernel_wrapper_runs_plain_on_cpu_and_checks_bounds():
    n1, n2 = pairs(7)
    args, static, _, _ = prepared(n1, n2, diag_env(T1, T2, 3), 0.0)
    T = torch.from_numpy
    targs = [T(x) if isinstance(x, np.ndarray) else x for x in args]
    lengths = T(np.array([16, 5, 0], np.int32))
    duplex_exact_cuda.reset_launches()
    got = duplex_exact_cuda.duplex_exact_kernel_batch(
        *targs, lengths, beam_size=5, collapse_repeats=True, crf=False, **static
    )
    want = port_dx.duplex_exact_batch(
        *targs, lengths, beam_size=5, collapse_repeats=True, crf=False, **static
    )
    assert all(torch.equal(got[k], want[k]) for k in FIELDS)
    assert set(duplex_exact_cuda.launches.values()) == {0}
    kw = dict(collapse_repeats=True, crf=False, W=static["W"], needs_ext=static["needs_ext"])
    with pytest.raises(ValueError, match="must be in"):
        duplex_exact_cuda.duplex_exact_kernel_batch(*targs, lengths, beam_size=9, max_nodes=64, **kw)
    with pytest.raises(ValueError, match="max_nodes"):
        duplex_exact_cuda.duplex_exact_kernel_batch(*targs, lengths, beam_size=5, max_nodes=2**31, **kw)
    assert duplex_exact_cuda.scratch_stride(10, 4, 7) == 5 * 10 + 11 * 4 + 2 * 10 * 7
