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

import os
import re

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
    assert duplex_exact_cuda.scratch_stride(10, 5, 4, 7) == 6 * 10 + 11 * 4 + 2 * 10 * 7 + 2 * 5 * 7


# ---- the tree kernel's scratch and stage arithmetic, and the hoisted bases ----

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "fast_ctc_decode_tpu_torch", "csrc")


def test_tree_kernel_constants_equal_the_source():
    src = open(os.path.join(CSRC, "duplex_exact_kernel.cu")).read()
    limit = eval(re.search(r"kStageSmemLimit = ([\d* ]+);", src).group(1))
    assert limit == duplex_exact_cuda.STAGE_SMEM_LIMIT
    stride = re.search(r"ctc_duplex_exact_stride\([^)]*\)\s*\{\s*return (.*?);", src, re.S).group(1)
    stride = re.sub(r"\(long long\)", "", re.sub(r"(\d+)LL", r"\1", stride))
    for N, K, A, W in ((10, 5, 4, 7), (20008, 5, 4, 83), (1, 1, 1, 1), (64, 8, 4, 1102)):
        assert eval(stride, dict(N=N, K=K, A=A, W=W)) == \
            duplex_exact_cuda.scratch_stride(N, K, A, W)
    assert "2LL * K * W * (long long)sizeof(float)" in src and "bytes <= kStageSmemLimit" in src


@pytest.mark.parametrize("K,fits", [(8, 1024), (5, 1638), (1, 8192), (32, 256)])
def test_tree_kernel_stage_rows_just_fit_and_just_miss(K, fits):
    assert 2 * K * fits * 4 <= 64 * 1024 < 2 * K * (fits + 1) * 4
    assert duplex_exact_cuda.stage_in_shared_memory(K, fits)
    assert not duplex_exact_cuda.stage_in_shared_memory(K, fits + 1)
    # either way the width is taken: past the limit the rows live in the
    # scratch buffer, whose stride has room for them
    for W in (fits, fits + 1):
        duplex_exact_cuda._bounds(4, K, 1, 100, W, 1, False)
        assert duplex_exact_cuda.scratch_stride(100, K, 1, W) - \
            duplex_exact_cuda.scratch_stride(100, 0, 1, W) == 2 * K * W


def test_tree_kernel_wrapper_takes_a_band_past_the_shared_stage_rows_on_cpu():
    # beam 8 at W > 1024: the case the kernel stages in its scratch buffer
    rng = np.random.RandomState(31)
    n1 = rng.rand(1, 3, 5).astype(np.float32)
    n2 = rng.rand(1, 1100, 5).astype(np.float32)
    n1 /= n1.sum(-1, keepdims=True)
    n2 /= n2.sum(-1, keepdims=True)
    env = np.stack([np.zeros(3, np.int64), np.array([600, 1100, 1100], np.int64)], 1)
    args, static, _, _ = prepared(n1, n2, env, 0.0, K=8)
    assert not duplex_exact_cuda.stage_in_shared_memory(8, static["W"])
    T = torch.from_numpy
    targs = [T(x) if isinstance(x, np.ndarray) else x for x in args]
    lengths = torch.full((1,), 3, dtype=torch.int32)
    got = duplex_exact_cuda.duplex_exact_kernel_batch(
        *targs, lengths, beam_size=8, collapse_repeats=True, crf=False, **static)
    assert got["err"].tolist() == [errors.OK] and int(got["count"][0]) >= 1


def special_bands(seed, shape):
    """Band values with -inf, NaN and -0.0 cells among ordinary log probs."""
    rng = np.random.RandomState(seed)
    x = np.log(rng.rand(*shape).astype(np.float32))
    kind = rng.rand(*shape)
    x[kind < 0.15] = -np.inf
    x[(kind >= 0.15) & (kind < 0.2)] = np.nan
    x[(kind >= 0.2) & (kind < 0.25)] = -0.0
    return x


def bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("crf", [False, True])
def test_tree_bands_equal_a_chain_that_computes_its_base_per_cell(crf):
    # duplex._build_bands (the tip's total for the whole window at once)
    # against a cell-by-cell chain with the base inside the loop, to the bit
    Bn, K, A, N, W, T2n, S = 2, 3, 4, 6, 9, 20, 4
    dev = torch.device("cpu")
    c = port_dx._init_carry(Bn, K, N, A, W, torch.zeros(Bn, dtype=torch.int32), dev)
    c = c._replace(
        node=torch.tensor([[-1, 2, 4], [1, 5, -2]], dtype=torch.int32),
        state=torch.tensor([[0, 3, 1], [2, 0, 0]]),
        blab=torch.from_numpy(special_bands(7, (Bn, N + 1, W))),
        bgap=torch.from_numpy(special_bands(8, (Bn, N + 1, W))),
        boff=torch.tensor([[0, 3, 2, 0, 4, 1, 0], [1, 3, 0, 0, 2, 5, 0]]),
        blen=torch.tensor([[0, 5, 9, 0, 7, 3, 0], [2, 8, 0, 0, 1, 6, 0]]),
    )
    lo, hi, wc = torch.tensor([4, 5]), torch.tensor([13, 11]), 9
    shape = (Bn, T2n, S, A + 1) if crf else (Bn, T2n, A + 1)
    l2 = torch.from_numpy(special_bands(9, shape))
    root_gap = torch.from_numpy(special_bands(10, (Bn, 8)))
    rep = torch.from_numpy(np.random.RandomState(11).rand(Bn, K, A) < 0.3)
    is_rep = torch.zeros_like(rep) if crf else rep
    lab, gap, mx_all = port_dx._build_bands(c, l2, root_gap, lo, hi, wc, is_rep, crf)
    NEG = torch.tensor(float("-inf"))
    # the CRF engine's logsumexp takes exp and log1p correctly rounded
    ls_add = port_df.ls_add_cr if crf else port_df.ls_add
    for b in range(Bn):
        for k in range(K):
            node = int(c.node[b, k])
            for a in range(A):
                last_lab = last_tot = mx = NEG
                for i in range(wc):
                    t2 = int(lo[b]) + i
                    pv = t2 - 1
                    if node < 0:
                        par_lab = NEG
                        par_gap = root_gap[b, pv + 1] if 0 <= pv + 1 < 8 else NEG
                    else:
                        n0 = min(max(node, 0), N - 1)
                        idx = pv - int(c.boff[b, n0])
                        ok = 0 <= idx < int(c.blen[b, n0])
                        col = min(max(idx, 0), W - 1)
                        par_lab = c.blab[b, n0, col] if ok else NEG
                        par_gap = c.bgap[b, n0, col] if ok else NEG
                    base = par_gap if bool(is_rep[b, k, a]) else ls_add(par_lab, par_gap)
                    tt = min(t2, T2n - 1)
                    r = l2[b, tt, int(c.state[b, k])] if crf else l2[b, tt]
                    gap_n = last_tot + r[0]
                    lab_n = r[1 + a] + ls_add(last_lab, base)
                    tot = ls_add(lab_n, gap_n)
                    assert torch.equal(bits(lab[b, k, a, i]), bits(lab_n)), (b, k, a, i)
                    assert torch.equal(bits(gap[b, k, a, i]), bits(gap_n)), (b, k, a, i)
                    if i < int(hi[b] - lo[b]) and bool(mx < tot):
                        mx = tot
                    last_lab, last_tot = lab_n, tot
                assert torch.equal(bits(mx_all[b, k, a]), bits(mx)), (b, k, a)
