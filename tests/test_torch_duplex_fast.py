"""The PyTorch port's slot-band duplex engine (plain and CRF) against the JAX package.

Contract: ``fast_ctc_decode_tpu_torch.ops.duplex_fast.duplex_fast_batch``
builds band cells one after another in the reference's order, where the JAX
package's ``duplex_fast_batch`` uses an associative scan, so the two meet at
the level of the engine's contract: every pair's sequence
(``labels_rev[:count]``) and status code are equal (tolerance: none), on
each envelope class of the JAX engine (static full range, window-relative
monotone lower bounds, general circular), with dipping upper bounds, invalid
envelopes, zero-probability rows, ragged and zero lengths.  On constant
windows the port also equals ``tests/oracle.py``.  The JAX package's Pallas
slot kernel runs once in interpret mode and gives the same sequences.  The
wrapper of the CUDA slot kernel (``ops/duplex_cuda.py``) runs the plain
engine on CPU tensors, refuses inputs outside its bounds, and the 1D
beam's traceback walks its id log at the widths it admits.
"""

import os
import re

import numpy as np
import pytest
import torch

import oracle
from duplex_helpers import diag_env, random_data
from fast_ctc_decode_tpu.ops import duplex as jax_dx
from fast_ctc_decode_tpu.ops import duplex_fast as jax_df
from fast_ctc_decode_tpu.ops import duplex_pallas as jax_dp
from fast_ctc_decode_tpu.parallel import pipeline as jax_pipeline
from fast_ctc_decode_tpu_torch import errors
from fast_ctc_decode_tpu_torch.ops import beam_cuda, duplex_cuda
from fast_ctc_decode_tpu_torch.ops import duplex as port_dx
from fast_ctc_decode_tpu_torch.ops import duplex_fast as port_df
from fast_ctc_decode_tpu_torch.parallel import pipeline as port_pipeline

torch.set_num_threads(1)

T1, T2, B = 16, 18, 3
ALPHA = "NACGT"


def pairs(seed, A1=5, b=B, t1=T1, t2=T2):
    n1 = np.stack([random_data(t1, A1, seed * 10 + i) for i in range(b)])
    n2 = np.stack([random_data(t2, A1, 500 + seed * 10 + i) for i in range(b)])
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


def prepared(n1, n2, envs, thr, crf_inits=None):
    """Inputs of both engines, as the JAX pipeline prepares them."""
    b, t1 = n1.shape[:2]
    t2 = n2.shape[1]
    envs = np.broadcast_to(envs, (b, t1, 2)) if envs.ndim == 2 else envs
    eps = [jax_df._prep_envelope_fast(np.asarray(e), t2) for e in envs]
    l1, l2, lt = port_df.log_inputs(n1, n2, thr)
    Wr = max(e.Wr for e in eps)
    if crf_inits is None:
        rg = port_df.root_gap_host(l2, [e.Wr for e in eps], Wr)
        init = np.zeros(b, np.int32)
    else:
        rg = port_df.crf_root_gap_host(l2, crf_inits[1], [e.Wr for e in eps], Wr)
        init = np.argmax(crf_inits[0], 1).astype(np.int32)
    lo = np.stack([e.lo for e in eps])
    hi = np.stack([e.hi for e in eps])
    return eps, l1, l2, lt, rg, lo, hi, init


def seqs(out):
    res = []
    for b in range(len(out["count"])):
        n = int(out["count"][b])
        labs = np.asarray(out["labels_rev"][b])[:n]
        res.append(("".join(ALPHA[int(l) + 1] for l in labs[::-1]), int(out["err"][b])))
    return res


def run_both(n1, n2, envs, thr=0.0, K=5, collapse=True, lengths=None, crf_inits=None):
    eps, l1, l2, lt, rg, lo, hi, init = prepared(n1, n2, envs, thr, crf_inits)
    b = n1.shape[0]
    lengths = np.full((b,), n1.shape[1], np.int32) if lengths is None else np.asarray(lengths, np.int32)
    static = all(e.static_window for e in eps)
    want = jax_df.duplex_fast_batch(
        l1, l2, rg, lo, hi, lt, init, lengths, beam_size=K, collapse_repeats=collapse,
        W=max(e.W for e in eps), Wr=rg.shape[1], Wext=max(e.Wext for e in eps),
        needs_ext=any(e.needs_ext for e in eps), crf=crf_inits is not None,
        static_window=static, rel_window=all(e.rel_window for e in eps) and not static,
        D=max(e.D for e in eps),
    )
    T = torch.from_numpy
    got = port_df.duplex_fast_batch(
        T(l1), T(l2), T(rg), T(lo), T(hi), lt, T(init), T(lengths), beam_size=K,
        collapse_repeats=collapse, needs_ext=any(e.needs_ext for e in eps),
        crf=crf_inits is not None,
    )
    for k in ("labels_rev", "count", "err"):
        assert got[k].dtype == torch.int32, k
    assert tuple(got["labels_rev"].shape) == (b, n1.shape[1])
    return seqs(want), seqs({k: v.numpy() for k, v in got.items()})


def dipping_env():
    env = diag_env(T1, T2, 3)
    env[6:9, 1] -= 2  # the upper bound dips, then recovers
    env[:, 1] = np.maximum(env[:, 1], env[:, 0] + 1)
    return env


def nonmonotone_env():
    env = diag_env(T1, T2, 4)
    env[9, 0] = max(env[9, 0] - 2, 0)  # a lower bound that steps back
    return env


def invalid_env():
    env = diag_env(T1, T2, 3)
    env[5, 1] = env[5, 0]  # lo >= hi at step 5
    return env


ENVS = [
    ("full", full_env()),
    ("diag", diag_env(T1, T2, 3)),
    ("dipping_upper", dipping_env()),
    ("nonmonotone_lower", nonmonotone_env()),
    ("invalid", invalid_env()),
]


@pytest.mark.parametrize(
    "name,env",
    ENVS + [
        ("offset_window", np.stack([np.full(T1, 3), np.full(T1, 11)], 1)),
        ("past_T2", diag_env(T1, T2, 3) + [0, 9]),
        ("one_step", full_env(1, T2)),
    ],
)
def test_envelope_prep_equals_jax(name, env):
    # the fields the port reads, for the slot and the tree engines
    got, want = port_df._prep_envelope_fast(env, T2), jax_df._prep_envelope_fast(env, T2)
    for f in port_df.EnvPrep._fields:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    got, want = port_dx._prep_envelope(env, T2), jax_dx._prep_envelope(env, T2)
    for g, w in zip(got, want[:5]):
        assert np.array_equal(g, w)


# Seeded envelope makers (rng, t1, t2) -> [t1, 2] i64, t1 >= 2, for the batched
# prep: each case puts the replay's stop, growth or clamping somewhere else.
def _monotone(rng, t1, t2):
    lo = np.cumsum(np.r_[0, rng.randint(0, 2, t1 - 1)])
    return np.stack([lo, lo + rng.randint(2, 8, t1)], 1).astype(np.int64)


def _nonmonotone(rng, t1, t2):
    env = _monotone(rng, t1, t2)
    for t in {rng.randint(2, t1) for _ in range(2)} if t1 > 2 else ():
        env[t - 1, 0] += 1  # still valid; step t's lower bound falls back
    return env


def _static(rng, t1, t2):
    env = full_env(t1, t2)
    env[rng.randint(0, 2, t1) == 1, 1] += rng.randint(1, 4)  # past T2: still the full range
    return env


def _hi_le_lo_at(where):
    def make(rng, t1, t2):
        env = _monotone(rng, t1, t2)
        t = {"first": 0, "middle": t1 // 2, "last": t1 - 1}[where]
        env[t, 1] = env[t, 0] - rng.randint(0, 2)
        return env
    return make


def _lo_above_upper(rng, t1, t2):
    env = _monotone(rng, t1, t2)
    m = t1 // 2
    env[m, 0] = env[:m, 1].max() + rng.randint(1, 3)
    env[m, 1] = env[m, 0] + 3
    return env


def _out_of_range(rng, t1, t2):
    env = _monotone(rng, t1, t2)
    env[:, 0] -= rng.randint(0, 6, t1)  # below 0
    env[:, 1] += rng.randint(0, 12, t1)  # past T2
    return env


ENV_MAKERS = {
    "monotone": _monotone,
    "nonmonotone_lower": _nonmonotone,
    "static": _static,
    "hi_le_lo_first": _hi_le_lo_at("first"),
    "hi_le_lo_middle": _hi_le_lo_at("middle"),
    "hi_le_lo_last": _hi_le_lo_at("last"),
    "lo_above_upper_middle": _lo_above_upper,
    "out_of_range": _out_of_range,
}


def envelope_batch(case, seed, b=6):
    """(envelopes [b, t1, 2] i64, T2) of one case: t1 of 2 to 40, or 1 or 0."""
    rng = np.random.RandomState(seed)
    t1 = {"one_step": 1, "empty": 0}.get(case, rng.randint(2, 41))
    t2 = rng.randint(t1 + 1, t1 + 8)  # above every lower bound of _monotone
    if case == "one_step":
        envs = np.stack([rng.randint(-2, 3, (b, 1)), rng.randint(-2, t2 + 3, (b, 1))], 2)
    elif case == "empty":
        envs = np.zeros((b, 0, 2), np.int64)
    elif case == "mixed":
        makers = list(ENV_MAKERS.values())
        envs = np.stack([makers[rng.randint(len(makers))](rng, t1, t2) for _ in range(b)])
    else:
        envs = np.stack([ENV_MAKERS[case](rng, t1, t2) for _ in range(b)])
    return envs.astype(np.int64), t2


@pytest.mark.parametrize("case", [*ENV_MAKERS, "one_step", "empty", "mixed"])
def test_batched_envelope_prep_equals_jax(case):
    # the batched prep and its one-envelope wrapper, field for field, against
    # the JAX package's per-pair replay
    for seed in range(5):
        envs, t2 = envelope_batch(case, 100 * seed + len(case), b=6)
        got = port_df.prep_envelopes(envs, t2)
        assert got.lo.dtype == got.hi.dtype == np.int32
        assert got.lo.shape == got.hi.shape == envs.shape[:2]
        for b, env in enumerate(envs):
            want = jax_df._prep_envelope_fast(env, t2)
            row = port_df.EnvPrep(got.lo[b], got.hi[b], got.W[b], got.Wr[b], got.needs_ext[b])
            for one in (row, port_df._prep_envelope_fast(env, t2)):
                for f in port_df.EnvPrep._fields:
                    assert np.array_equal(getattr(one, f), getattr(want, f)), (case, seed, b, f)
            assert got.tree_needs_ext[b] == np.any(want.hi[1:] > want.hi[:-1])


def _reference_batch(n1, n2, envs, lengths, thr, t1, t2, inits=None):
    """DuplexBatch fields as the JAX pipeline's ``_prep_envelope_batch`` and
    its decoders' host code (logs, root bands) give them; except that the
    port takes CRF logs correctly rounded (in float64, rounded once to
    float32) where the JAX package takes numpy's float32 ``log``."""
    b = n1.shape[0]
    shared = envs is None or envs.ndim == 2
    envs = np.broadcast_to(full_env(t1, t2) if envs is None else envs, (b, t1, 2))
    lo, hi, eps = jax_pipeline._prep_envelope_batch(jax_df, envs, b, t1, t2, shared)
    with np.errstate(divide="ignore", invalid="ignore"):
        if inits is None:
            l1 = np.log(np.asarray(n1, np.float32), dtype=np.float32)
            l2 = np.log(np.asarray(n2, np.float32), dtype=np.float32)
            lt = np.float32(np.log(np.float32(thr)))
        else:
            l1 = np.log(np.asarray(n1, np.float32).astype(np.float64)).astype(np.float32)
            l2 = np.log(np.asarray(n2, np.float32).astype(np.float64)).astype(np.float32)
            lt = np.float32(np.log(np.float64(np.float32(thr))))
    wr_b = np.minimum(np.maximum(envs[:, 0, 1], 0), t2) + 1
    root_gap = np.full((b, int(wr_b.max())), -np.inf, np.float32)
    root_gap[:, 0] = 0.0
    if inits is None:
        for i in range(b):
            root_gap[i, 1:wr_b[i]] = np.cumsum(l2[i, : wr_b[i] - 1, 0], dtype=np.float32)
        init_states = np.zeros(b, np.int32)
    else:
        S, A = l2.shape[2], l2.shape[3] - 1
        states = np.argmax(inits[1], axis=1).astype(np.int64)
        cur = np.zeros((b,), np.float32)
        for i in range(root_gap.shape[1] - 1):
            cur = (cur + l2[np.arange(b), i, states, 0]).astype(np.float32)
            live = i + 1 < wr_b
            root_gap[live, i + 1] = cur[live]
            states = (states * A) % S
        init_states = np.argmax(inits[0], axis=1).astype(np.int32)
    return port_pipeline.DuplexBatch(
        l1, l2, root_gap, lo, hi, lt, init_states, np.asarray(lengths, np.int32),
        needs_ext=any(e.needs_ext for e in eps), W=max(e.W for e in eps),
        tree_needs_ext=any(bool(np.any(e.hi[1:] > e.hi[:-1])) for e in eps),
    )


@pytest.mark.parametrize("crf", [False, True], ids=["plain", "crf"])
@pytest.mark.parametrize("kind", ["per_pair", "shared", "none"])
def test_prep_duplex_batch_equals_jax_assembly(kind, crf):
    # a batch padded as decode_many_duplex pads one: read 1 zero past each
    # pair's length, its envelope rows there repeating the last real row
    t1, t2, b = 14, 16, 5
    rng = np.random.RandomState(11 + 2 * crf + len(kind))
    len1 = np.array([14, 9, 1, 5, 14], np.int32)
    if crf:
        n1, i1, n2, i2 = crf_pairs(12, 4, 5, b=b, t1=t1, t2=t2)
        inits = (i1, i2)
    else:
        (n1, n2), inits = pairs(12, b=b, t1=t1, t2=t2), None
    makers = list(ENV_MAKERS.values())
    envs = {"none": None, "shared": _nonmonotone(rng, t1, t2)}.get(kind)
    if kind == "per_pair":
        envs = np.stack([makers[i % len(makers)](rng, t1, t2) for i in range(b)])
    for i, n in enumerate(len1):
        n1[i, n:] = 0.0
        if kind == "per_pair":
            envs[i, n:] = envs[i, n - 1]
    kw = {} if inits is None else {"init1": inits[0], "init2": inits[1]}
    got = port_pipeline.prep_duplex_batch(n1, n2, envs, len1, 0.05, T1=t1, T2=t2, **kw)
    want = _reference_batch(n1, n2, envs, len1, 0.05, t1, t2, inits)
    for f in port_pipeline.DuplexBatch._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert type(g) is type(w), f
        if isinstance(g, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f
        assert np.array_equal(g, w), f


@pytest.mark.parametrize("name,env", ENVS)
def test_fast_equals_jax_per_envelope_class(name, env):
    want, got = run_both(*pairs(1), env)
    assert got == want
    if name == "invalid":
        assert {e for _, e in got} == {errors.INVALID_ENVELOPE}


def test_fast_equals_jax_threshold_collapse_off_ragged_per_pair():
    n1, n2 = pairs(2)
    envs = np.stack([diag_env(T1, T2, w) for w in (2, 3, 5)])
    want, got = run_both(n1, n2, envs, thr=0.05, collapse=False, lengths=[16, 0, 7])
    assert got == want
    assert got[1] == ("", errors.OK)


def test_fast_equals_jax_zero_probability_rows():
    # zero rows of either network keep the beam (valid -inf candidates stay
    # selectable); the JAX engine's own case is tests/test_fast_duplex.py
    n1, n2 = pairs(3)
    n1[0, 3:5] = 0.0
    n1[1, 2] = 0.0
    n2[2, 5:8] = 0.0
    want, got = run_both(n1, n2, full_env())
    assert got == want
    assert {e for _, e in got} == {errors.OK}


@pytest.mark.parametrize("S,A1", [(16, 5), (9, 4)])
def test_crf_fast_equals_jax(S, A1):
    n1, i1, n2, i2 = crf_pairs(4 + S, S, A1)
    for env in (full_env(12, 14), diag_env(12, 14, 3)):
        want, got = run_both(n1, n2, env, crf_inits=(i1, i2))
        assert got == want


def test_fast_equals_oracle_on_constant_windows():
    n1, n2 = pairs(5)
    offset = np.stack([np.zeros(T1, np.int64), np.full(T1, 11, np.int64)], 1)
    for env in (full_env(), offset):
        _, got = run_both(n1, n2, env)
        for b in range(B):
            assert got[b] == (oracle.beam_search_duplex(n1[b], n2[b], ALPHA, envelope=env), 0)
    n1, i1, n2, i2 = crf_pairs(6, 16, 5)
    _, got = run_both(n1, n2, full_env(12, 14), crf_inits=(i1, i2))
    for b in range(B):
        want = oracle.crf_beam_search_duplex(n1[b], i1[b], n2[b], i2[b], ALPHA)
        assert got[b] == (want, 0)


def test_jax_pallas_slot_kernel_interpret_equals_port():
    n1, n2 = pairs(7)
    env = diag_env(T1, T2, 3)
    eps, l1, l2, lt, rg, lo, hi, init = prepared(n1, n2, env, 0.0)
    ep = eps[0]
    lengths = np.full((B,), T1, np.int32)
    po = jax_dp.duplex_pallas_batch(
        l1, l2, rg, ep.lo, ep.hi, lt, lengths, beam_size=5, collapse_repeats=True,
        W=ep.W, D=ep.D, needs_ext=ep.needs_ext, block_t=8, block_b=8, interpret=True,
    )
    T = torch.from_numpy
    got = duplex_cuda.duplex_kernel_batch(
        T(l1), T(l2), T(rg), T(lo), T(hi), lt, T(lengths), beam_size=5,
        collapse_repeats=True, needs_ext=ep.needs_ext,
    )
    assert seqs({k: v.numpy() for k, v in got.items()}) == seqs(po)


def test_kernel_wrapper_runs_plain_on_cpu():
    n1, n2 = pairs(8)
    env = diag_env(T1, T2, 3)
    eps, l1, l2, lt, rg, lo, hi, init = prepared(n1, n2, env, 0.1)
    T = torch.from_numpy
    lengths = T(np.array([16, 9, 0], np.int32))
    args = (T(l1), T(l2), T(rg), T(lo), T(hi), lt)
    duplex_cuda.reset_launches()
    got = duplex_cuda.duplex_kernel_batch(*args, lengths, beam_size=4, collapse_repeats=True,
                                          needs_ext=eps[0].needs_ext)
    want = port_df.duplex_fast_batch(*args, T(init), lengths, beam_size=4, collapse_repeats=True,
                                     needs_ext=eps[0].needs_ext, crf=False)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert duplex_cuda.launches == {"duplex": 0}  # the plain version counts nothing


def test_kernel_wrapper_bounds():
    n1, n2 = pairs(9, A1=5)
    T = torch.from_numpy
    eps, l1, l2, lt, rg, lo, hi, init = prepared(n1, n2, full_env(), 0.0)
    lengths = torch.full((B,), T1, dtype=torch.int32)
    args = (T(l1), T(l2), T(rg), T(lo), T(hi), lt, lengths)
    kw = dict(collapse_repeats=True, needs_ext=False)
    # K*A <= 32: beam 8 over 4 labels is the widest, beam 9 is refused
    assert duplex_cuda.duplex_ids_kernel(*args, beam_size=8, **kw)[0].shape == (T1, 8, B)
    with pytest.raises(ValueError, match="must be in"):
        duplex_cuda.duplex_ids_kernel(*args, beam_size=9, **kw)
    # a lower bound that steps back is outside the kernel's envelope class
    _, _, _, _, _, lo2, hi2, _ = prepared(n1, n2, nonmonotone_env(), 0.0)
    with pytest.raises(ValueError, match="non-decreasing"):
        duplex_cuda.duplex_ids_kernel(T(l1), T(l2), T(rg), T(lo2), T(hi2), lt, lengths,
                                      beam_size=5, **kw)
    # bands beyond the shared memory of one block
    lo_w = torch.zeros((1, 2), dtype=torch.int32)
    hi_w = torch.full((1, 2), 2000, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        duplex_cuda.duplex_ids_kernel(torch.zeros((1, 2, 5)), torch.zeros((1, 2000, 5)),
                                      torch.zeros((1, 3)), lo_w, hi_w, 0.0,
                                      torch.ones(1, dtype=torch.int32), beam_size=5, **kw)
    with pytest.raises(TypeError):
        duplex_cuda.duplex_ids_kernel(T(l1).double(), *args[1:], beam_size=5, **kw)


def test_traceback_walks_the_duplex_id_log_at_its_widths():
    # beam 8 over A+1 = 5 and beam 2 over A+1 = 17 pass the 1D kernels'
    # bounds (16 / 8) but not K*A <= 32; the traceback takes any of them
    for K, A1 in ((8, 5), (2, 17)):
        n1, n2 = pairs(10, A1=A1)
        eps, l1, l2, lt, rg, lo, hi, init = prepared(n1, n2, diag_env(T1, T2, 3), 0.0)
        T = torch.from_numpy
        ids, fin, _ = duplex_cuda.duplex_ids_kernel(
            T(l1), T(l2), T(rg), T(lo), T(hi), lt, torch.full((B,), T1, dtype=torch.int32),
            beam_size=K, collapse_repeats=True, needs_ext=eps[0].needs_ext,
        )
        got = beam_cuda.traceback_kernel(fin, ids, T=T1, K=K, A=A1 - 1)
        want = beam_cuda.traceback_plain(fin, ids, T=T1, K=K, A=A1 - 1)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert int(got[2].min()) > 0


# ---- the slot kernel's bound arithmetic and the hoisted bases ----

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "fast_ctc_decode_tpu_torch", "csrc")


def c_return(source, function):
    """The expression a one-statement C function of ``source`` returns, as a
    Python expression (integer suffixes and casts dropped)."""
    body = re.search(function + r"\([^)]*\)\s*\{\s*return (.*?);", source, re.S).group(1)
    body = re.sub(r"\(long long\)\s*sizeof\(float\)", "4", body)
    return re.sub(r"(\d+)LL", r"\1", body)


def test_slot_kernel_constants_equal_the_source():
    src = open(os.path.join(CSRC, "duplex_kernel.cu")).read()
    assert eval(re.search(r"kSmemLimit = ([\d* ]+);", src).group(1)) == duplex_cuda.SMEM_LIMIT
    assert int(re.search(r"kLanes = (\d+);", src).group(1)) == duplex_cuda.MAX_LANES
    for K, A, Wk in ((5, 4, 502), (8, 4, 896), (1, 1, 2), (3, 7, 77)):
        env = dict(K=K, A=A, Wk=Wk)
        band_bytes = eval(c_return(src, "ctc_duplex_slot_smem_bytes"), env)
        assert duplex_cuda.fits_shared_memory(K, Wk) == (band_bytes <= duplex_cuda.SMEM_LIMIT)
        assert band_bytes == 8 * K * Wk * 4
        assert eval(c_return(src, "ctc_duplex_slot_slab_words"), env) == \
            duplex_cuda.slab_words(K, A, Wk)
    # the stage rows' test in the launch is the wrapper's
    assert "10LL * K * Wk * (long long)sizeof(float)" in src and "with_stage <= kSmemLimit" in src


@pytest.mark.parametrize("K,fits", [(8, 896), (5, 1433), (1, 7168), (32, 224)])
def test_slot_kernel_band_bound_just_fits_and_just_misses(K, fits):
    # the band bound the kernel always had, 8 * K * Wk * 4 <= 224 KiB, to the cell
    assert 8 * K * fits * 4 <= 224 * 1024 < 8 * K * (fits + 1) * 4
    assert duplex_cuda.fits_shared_memory(K, fits)
    assert not duplex_cuda.fits_shared_memory(K, fits + 1)
    # the stage rows never tighten it: they move to the slab instead
    assert not duplex_cuda.stage_in_shared_memory(K, fits)
    assert duplex_cuda.stage_in_shared_memory(K, fits * 8 // 10)
    assert not duplex_cuda.stage_in_shared_memory(K, fits * 8 // 10 + 1)
    # check_bounds takes a band of exactly that width and refuses one more cell
    lo = torch.zeros((1, 2), dtype=torch.int32)
    for Wk, ok in ((fits, True), (fits + 1, False)):
        hi = torch.full((1, 2), Wk - 2, dtype=torch.int32)
        if ok:
            assert duplex_cuda.check_bounds(lo, hi, K=K, A=1) == Wk
        else:
            with pytest.raises(ValueError, match="shared memory"):
                duplex_cuda.check_bounds(lo, hi, K=K, A=1)


def test_slot_kernel_wrapper_runs_the_widest_band_on_cpu():
    # beam 8 over 4 labels at Wk = 896: the widest band of the widest beam
    n1, n2 = pairs(12, b=1, t1=2, t2=894)
    eps, l1, l2, lt, rg, lo, hi, init = prepared(n1, n2, full_env(2, 894), 0.0)
    T = torch.from_numpy
    ids, fin, err = duplex_cuda.duplex_ids_kernel(
        T(l1), T(l2), T(rg), T(lo), T(hi), lt, torch.full((1,), 2, dtype=torch.int32),
        beam_size=8, collapse_repeats=True, needs_ext=False)
    assert ids.shape == (2, 8, 1) and err.tolist() == [errors.OK]


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


def test_hoisted_totals_equal_the_totals_computed_cell_by_cell():
    # the kernels compute ls_add(par_lab, par_gap) for a tip's whole window
    # ahead of the chains; the value must be the one a chain would compute
    # inside its own loop, cell by cell, to the bit
    lab = torch.from_numpy(special_bands(1, (3, 5, 37)))
    gap = torch.from_numpy(special_bands(2, (3, 5, 37)))
    at_once = port_df.ls_add(lab, gap)
    for i in range(lab.shape[-1]):
        one = port_df.ls_add(lab[..., i].clone(), gap[..., i].clone())
        assert torch.equal(bits(at_once[..., i]), bits(one)), i
    # operand order does not matter to the value (the chain passes (lab, gap))
    assert torch.equal(bits(at_once), bits(port_df.ls_add(gap, lab)))


@pytest.mark.parametrize("collapse", [True, False])
def test_fresh_bands_equal_a_chain_that_computes_its_base_per_cell(collapse):
    # duplex_fast._build_fresh_bands against a cell-by-cell chain written as
    # the reference writes it (duplex.rs:229-247): base inside the loop
    Bn, K, A, T2n, wc = 2, 3, 4, 20, 9
    dev = torch.device("cpu")
    c = port_df._init_carry(Bn, K, T2n + 1, torch.zeros(Bn, dtype=torch.int32), dev)
    c = c._replace(
        id=torch.tensor([[-1, 4, 9], [3, 7, -2]], dtype=torch.int32),
        blab=torch.from_numpy(special_bands(3, (Bn, K, T2n + 1))),
        bgap=torch.from_numpy(special_bands(4, (Bn, K, T2n + 1))),
        boff=torch.tensor([[0, 2, 5], [1, 6, 0]]), bend=torch.tensor([[0, 12, 9], [14, 13, 0]]),
        lastlab=torch.tensor([[-1, 2, 0], [3, 1, 0]]),
    )
    lo, hi = torch.tensor([4, 5]), torch.tensor([13, 11])
    l2 = torch.from_numpy(special_bands(5, (Bn, T2n, A + 1)))
    root_gap = torch.from_numpy(special_bands(6, (Bn, 8)))
    lbl = torch.arange(A)
    is_rep = (c.lastlab[..., None] == lbl) if collapse else torch.zeros((Bn, K, A), dtype=torch.bool)
    j = torch.arange(wc)
    rows = port_df._l2_rows(l2, (lo[:, None] + j)[:, None, :], None, False)
    lab, gap, p2m = port_df._build_fresh_bands(c, lo, hi, wc, rows, root_gap, is_rep)
    NEG = float("-inf")
    for b in range(Bn):
        for k in range(K):
            for a in range(A):
                last_lab = last_tot = torch.tensor(NEG)
                mx = torch.tensor(NEG)
                for i in range(wc):
                    t2 = int(lo[b]) + i
                    pv = t2 - 1
                    root = int(c.id[b, k]) == -1
                    t_ok = int(c.boff[b, k]) <= pv < int(c.bend[b, k])
                    par_lab = c.blab[b, k, pv] if (t_ok and not root) else torch.tensor(NEG)
                    if root:
                        par_gap = root_gap[b, pv + 1] if 0 <= pv + 1 < 8 else torch.tensor(NEG)
                    else:
                        par_gap = c.bgap[b, k, pv] if t_ok else torch.tensor(NEG)
                    base = par_gap if bool(is_rep[b, k, a]) else port_df.ls_add(par_lab, par_gap)
                    r = l2[b, min(t2, T2n - 1)]
                    gap_n = last_tot + r[0]
                    lab_n = r[1 + a] + port_df.ls_add(last_lab, base)
                    tot = port_df.ls_add(lab_n, gap_n)
                    live = i < int(hi[b] - lo[b])
                    want = (lab_n, gap_n) if live else (torch.tensor(NEG), torch.tensor(NEG))
                    assert torch.equal(bits(lab[b, k, a, i]), bits(want[0])), (b, k, a, i)
                    assert torch.equal(bits(gap[b, k, a, i]), bits(want[1])), (b, k, a, i)
                    if live and bool(mx < tot):
                        mx = tot
                    last_lab, last_tot = lab_n, tot
                assert torch.equal(bits(p2m[b, k, a]), bits(mx)), (b, k, a)
