"""The PyTorch port's duplex entry points against the JAX package and the oracle.

``fast_ctc_decode_tpu_torch.api.beam_search_duplex`` / ``crf_beam_search_duplex``
must raise the JAX ``api``'s exception types with its messages on the
error probes (envelope type, dtype, rank, shape, negative values; max_nodes
with "fast"; unknown engine; mismatched axes) and give tests/oracle.py's
sequences.  ``BatchDuplexDecoder`` / ``BatchCrfDuplexDecoder`` equal the
single-read API pair by pair, on every engine the CPU runs, and
``decode_many_duplex`` resumes a checkpoint the JAX package wrote (its meta
keys and values are the JAX package's), finishing with the JAX package's
results.
"""

import json
import os

import numpy as np
import pytest
import torch

import oracle
from duplex_helpers import diag_env, random_data
from fast_ctc_decode_tpu import api as jax_api
from fast_ctc_decode_tpu.parallel import pipeline as jax_pipeline
from fast_ctc_decode_tpu_torch import BatchCrfDuplexDecoder, BatchDuplexDecoder
from fast_ctc_decode_tpu_torch import api as port_api
from fast_ctc_decode_tpu_torch import decode_many_duplex, errors
from fast_ctc_decode_tpu_torch.ops import duplex_cuda, duplex_exact_cuda
from fast_ctc_decode_tpu_torch.parallel import pipeline as port_pipeline

torch.set_num_threads(1)

ALPHA = "NACGT"
T1, T2 = 12, 14


def pair(seed, t1=T1, t2=T2, A1=5):
    return random_data(t1, A1, seed), random_data(t2, A1, 900 + seed)


def crf_pair(seed, S=16, A1=5, t1=T1, t2=T2):
    rng = np.random.RandomState(seed)
    n1 = rng.rand(t1, S, A1).astype(np.float32)
    n2 = rng.rand(t2, S, A1).astype(np.float32)
    return (n1 / n1.sum(-1, keepdims=True), rng.rand(S).astype(np.float32),
            n2 / n2.sum(-1, keepdims=True), rng.rand(S).astype(np.float32))


def outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # the probe compares type and message
        return (type(exc).__name__, str(exc))


P1, P2 = pair(1)
C1, I1, C2, I2 = crf_pair(2)
ENV = diag_env(T1, T2, 3)

PROBES = [
    ("envelope_list", (P1, P2, ALPHA), dict(envelope=ENV.tolist())),
    ("envelope_float", (P1, P2, ALPHA), dict(envelope=ENV.astype(np.float32))),
    ("envelope_rank", (P1, P2, ALPHA), dict(envelope=ENV.reshape(-1))),
    ("envelope_rows", (P1, P2, ALPHA), dict(envelope=ENV[:-1])),
    ("envelope_cols", (P1, P2, ALPHA), dict(envelope=np.zeros((T1, 3), np.int64))),
    ("envelope_negative", (P1, P2, ALPHA), dict(envelope=ENV - 5)),
    ("max_nodes_fast", (P1, P2, ALPHA), dict(engine="fast", max_nodes=100)),
    ("unknown_engine", (P1, P2, ALPHA), dict(engine="pallas")),
    ("inner_axes", (P1, P2[:, :4], ALPHA), {}),
    ("alphabet", (P1, P2, "NACG"), {}),
    ("beam_zero", (P1, P2, ALPHA), dict(beam_size=0)),
    ("threshold", (P1, P2, ALPHA), dict(beam_cut_threshold=0.5)),
    ("f64", (P1.astype(np.float64), P2, ALPHA), {}),
]


@pytest.mark.parametrize("name,args,kw", PROBES, ids=[p[0] for p in PROBES])
def test_duplex_error_probes_match_jax(name, args, kw):
    got = outcome(port_api.beam_search_duplex, *args, **kw, device="cpu")
    want = outcome(jax_api.beam_search_duplex, *args, **kw)
    assert got[0] != "ok" and got == want


CRF_PROBES = [
    ("envelope_float", dict(envelope=ENV.astype(np.float32))),
    ("envelope_negative", dict(envelope=ENV - 5)),
    ("max_nodes_fast", dict(engine="fast", max_nodes=100)),
    ("unknown_engine", dict(engine="exact-pallas")),
    ("beam_zero", dict(beam_size=0)),
]


@pytest.mark.parametrize("name,kw", CRF_PROBES, ids=[p[0] for p in CRF_PROBES])
def test_crf_duplex_error_probes_match_jax(name, kw):
    args = (C1, I1, C2, I2, ALPHA)
    got = outcome(port_api.crf_beam_search_duplex, *args, **kw, device="cpu")
    want = outcome(jax_api.crf_beam_search_duplex, *args, **kw)
    assert got[0] != "ok" and got == want
    got = outcome(port_api.crf_beam_search_duplex, C1[:, :, :4], I1, C2, I2, ALPHA, device="cpu")
    assert got == outcome(jax_api.crf_beam_search_duplex, C1[:, :, :4], I1, C2, I2, ALPHA)


def test_invalid_envelope_raises_the_reference_error():
    bad = ENV.copy()
    bad[4, 1] = bad[4, 0]
    for engine in (None, "fast", "exact"):
        with pytest.raises(errors.SearchError, match="Invalid envelope values"):
            port_api.beam_search_duplex(P1, P2, ALPHA, envelope=bad, engine=engine, device="cpu")


def test_api_equals_oracle_on_every_engine():
    for seed in (3, 4):
        p1, p2 = pair(seed)
        want_full = oracle.beam_search_duplex(p1, p2, ALPHA)
        want_diag = oracle.beam_search_duplex(p1, p2, ALPHA, envelope=ENV)
        assert port_api.beam_search_duplex(p1, p2, ALPHA, device="cpu") == want_full  # auto: fast
        assert port_api.beam_search_duplex(p1, p2, ALPHA, engine="exact", device="cpu") == want_full
        assert port_api.beam_search_duplex(p1, p2, ALPHA, envelope=ENV, device="cpu") == want_diag  # auto: exact
    c1, i1, c2, i2 = crf_pair(5)
    want = oracle.crf_beam_search_duplex(c1, i1, c2, i2, ALPHA)
    assert port_api.crf_beam_search_duplex(c1, i1, c2, i2, ALPHA, device="cpu") == want
    want = oracle.crf_beam_search_duplex(c1, i1, c2, i2, ALPHA, envelope=ENV)
    assert port_api.crf_beam_search_duplex(c1, i1, c2, i2, ALPHA, envelope=ENV, device="cpu") == want
    # a too small tree budget surfaces as NODE_OVERFLOW
    with pytest.raises(errors.SearchError, match="node budget"):
        port_api.beam_search_duplex(P1, P2, ALPHA, envelope=ENV, max_nodes=10, device="cpu")


@pytest.mark.parametrize("engine", [None, "fast", "exact"])
def test_batch_decoder_equals_single_read(engine):
    ps = [pair(10 + i) for i in range(3)]
    n1 = np.stack([p[0] for p in ps])
    n2 = np.stack([p[1] for p in ps])
    envs = np.stack([diag_env(T1, T2, w) for w in (2, 3, 4)])
    dec = BatchDuplexDecoder(ALPHA, T1=T1, T2=T2, engine=engine, device="cpu")
    for env in (None, ENV, envs):
        lengths = np.array([T1, 7, 0], np.int32)
        got = dec.decode(n1, n2, envelopes=env, lengths=lengths)
        for b in range(3):
            e = None if env is None else (env if env.ndim == 2 else env[b])
            want = port_api.beam_search_duplex(
                ps[b][0][: lengths[b]], ps[b][1], ALPHA,
                envelope=None if e is None else e[: lengths[b]],
                engine=engine or ("fast" if env is None else "exact"), device="cpu",
            )
            assert got[b] == (want, errors.OK)
    out = dec.decode_arrays(n1, n2)
    assert out["labels_rev"].dtype == torch.int32 and tuple(out["labels_rev"].shape) == (3, T1)


def test_crf_batch_decoder_equals_single_read():
    cs = [crf_pair(20 + i) for i in range(2)]
    stack = lambda i: np.stack([c[i] for c in cs])  # noqa: E731
    for engine, env in ((None, None), (None, ENV), ("fast", ENV), ("exact", None)):
        dec = BatchCrfDuplexDecoder(ALPHA, T1=T1, T2=T2, n_state=16, engine=engine, device="cpu")
        got = dec.decode(stack(0), stack(1), stack(2), stack(3), envelopes=env)
        for b in range(2):
            want = port_api.crf_beam_search_duplex(
                *cs[b], ALPHA, envelope=env,
                engine=engine or ("fast" if env is None else "exact"), device="cpu",
            )
            assert got[b] == (want, errors.OK)


def test_decoder_engine_checks():
    with pytest.raises(ValueError, match="unknown engine"):
        BatchDuplexDecoder(ALPHA, T1=4, T2=4, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        BatchDuplexDecoder(ALPHA, T1=4, T2=4, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        BatchCrfDuplexDecoder(ALPHA, T1=4, T2=4, n_state=4, engine="cuda", device="cpu")


def test_auto_engine_routing_on_a_cuda_device(monkeypatch):
    """Auto on a CUDA device, for the batch decoders and the API alike: a
    constant window runs the slot kernel while its shared memory holds the
    band and the tree kernel past it; a moving window the tree kernel; a CRF
    constant window the CRF tree kernel.  Past the lanes both kernels
    share (beam * A > 32) the chosen kernel raises.  The callers are handed a
    CUDA device; a spy runs each chosen engine on the CPU tensors, where the
    kernel wrappers check the same bounds before their plain versions."""
    seen = []
    run = port_pipeline.run_duplex_engine

    def spy(engine, batch, device, **kw):
        assert torch.device(device).type == "cuda"
        seen.append(engine)
        return run(engine, batch, "cpu", **kw)

    monkeypatch.setattr(port_pipeline, "run_duplex_engine", spy)
    cuda = torch.device("cuda")

    def route(beam=5, env=None, crf=False):
        seen.clear()
        if crf:
            dec = BatchCrfDuplexDecoder(ALPHA, T1=T1, T2=T2, n_state=16, beam_size=beam, device="cpu")
            monkeypatch.setattr(dec, "device", cuda)
            got = dec.decode(C1[None], I1[None], C2[None], I2[None], envelopes=env)
            one = port_api.crf_beam_search_duplex(C1, I1, C2, I2, ALPHA, envelope=env,
                                                  beam_size=beam, device="cuda")
        else:
            dec = BatchDuplexDecoder(ALPHA, T1=T1, T2=T2, beam_size=beam, device="cpu")
            monkeypatch.setattr(dec, "device", cuda)
            got = dec.decode(P1[None], P2[None], envelopes=env)
            one = port_api.beam_search_duplex(P1, P2, ALPHA, envelope=env, beam_size=beam,
                                              device="cuda")
        assert got == [(one, errors.OK)] and seen[0] == seen[1]
        return seen[0]

    assert route() == "cuda"
    assert route(env=ENV) == "exact"
    assert route(crf=True) == "exact"
    assert route(env=ENV, crf=True) == "exact"
    limit = duplex_cuda.SMEM_LIMIT
    monkeypatch.setattr(duplex_cuda, "SMEM_LIMIT", 8 * 5 * 4 * (T2 + 2) - 4)
    assert route() == "exact"  # the band no longer fits the slot kernel
    assert route(beam=4) == "cuda"
    assert route(crf=True) == "exact"
    monkeypatch.setattr(duplex_cuda, "SMEM_LIMIT", limit)
    with pytest.raises(ValueError, match=r"must be in \[1, 32\] for the duplex CUDA kernel"):
        route(beam=9)
    batch = port_pipeline.prep_duplex_batch(P1[None], P2[None], None, None, 0.0, T1=T1, T2=T2)
    with pytest.raises(ValueError, match=r"must be in \[1, 32\] for the exact duplex CUDA"):
        duplex_exact_cuda.duplex_exact_kernel_batch(
            *batch.tensors("cpu"), beam_size=9, collapse_repeats=True,
            max_nodes=batch.max_nodes(9), W=batch.W, needs_ext=batch.tree_needs_ext, crf=False,
        )


def test_decode_many_duplex_resumes_a_jax_checkpoint(tmp_path):
    rng = np.random.RandomState(6)
    pairs = []
    for i in range(6):
        t1 = 14 if i == 0 else int(rng.randint(5, 15))  # pair 0 fixes the bucket edges
        t2 = 16 if i == 0 else int(rng.randint(6, 17))
        p1, p2 = pair(40 + i, t1, t2)
        pairs.append((p1, p2, diag_env(t1, t2, 3)) if i % 2 else (p1, p2))
    kw = dict(beam_size=5, beam_cut_threshold=0.0, batch_size=8)
    want = jax_pipeline.decode_many_duplex(pairs, ALPHA, **kw)
    ckpt = os.path.join(tmp_path, "duplex.jsonl")
    half = jax_pipeline.decode_many_duplex(pairs[:3], ALPHA, checkpoint_path=ckpt, **kw)
    assert half == want[:3]
    got = decode_many_duplex(pairs, ALPHA, checkpoint_path=ckpt, device="cpu", **kw)
    assert got == want
    assert decode_many_duplex(pairs, ALPHA, device="cpu", **kw) == want  # uninterrupted, in the port
    assert all(e == errors.OK for _, e in got)


CRF_CONSTANT = [  # (seed, S, A+1, T1, T2, beam, cut, window)
    (0, 16, 5, 12, 14, 5, 0.0, None),
    (1, 9, 4, 9, 15, 1, 0.01, (0, 11)),
    (2, 4, 3, 14, 10, 3, 0.05, None),
    (3, 16, 5, 10, 13, 8, 0.0, (0, 6)),
]


@pytest.mark.parametrize("case", CRF_CONSTANT, ids=[f"seed{c[0]}" for c in CRF_CONSTANT])
def test_crf_tree_engine_gives_the_slot_engines_sequences_on_constant_windows(case):
    """What auto's CRF route on a CUDA device rests on: on constant windows
    (the full range included) the plain CRF tree engine gives the plain CRF
    slot engine's sequences and statuses, which are JAX's CRF ``duplex_fast``
    and tests/oracle.py's."""
    seed, S, A1, t1, t2, beam, thr, window = case
    alpha = "NACGT"[:A1]
    cs = [crf_pair(200 + 10 * seed + i, S=S, A1=A1, t1=t1, t2=t2) for i in range(3)]
    env = None
    if window is not None:
        env = np.stack([np.full(t1, window[0], np.int64), np.full(t1, window[1], np.int64)], 1)
    stack = [np.stack([c[i] for c in cs]) for i in range(4)]
    got = {eng: BatchCrfDuplexDecoder(alpha, T1=t1, T2=t2, n_state=S, beam_size=beam,
                                      beam_cut_threshold=thr, engine=eng, device="cpu"
                                      ).decode(*stack, envelopes=env)
           for eng in ("fast", "exact")}
    assert got["exact"] == got["fast"]
    for b in range(3):
        kw = dict(envelope=env, beam_size=beam, beam_cut_threshold=thr)
        want = jax_api.crf_beam_search_duplex(*cs[b], alpha, engine="fast", **kw)
        assert got["exact"][b] == (want, errors.OK)
        assert oracle.crf_beam_search_duplex(*cs[b], alpha, **kw) == want


def test_decode_many_duplex_resumes_a_jax_exact_pallas_checkpoint(tmp_path):
    """JAX names its duplex tree kernel "exact-pallas" (results equal to its
    "exact" engine); the port's "exact" resumes such a checkpoint, and a slot
    engine does not."""
    import json

    rng = np.random.RandomState(7)
    pairs = []
    for i in range(5):
        t1 = 14 if i == 0 else int(rng.randint(5, 15))
        t2 = 16 if i == 0 else int(rng.randint(6, 17))
        p1, p2 = pair(60 + i, t1, t2)
        pairs.append((p1, p2, diag_env(t1, t2, 3)) if i % 2 else (p1, p2))
    kw = dict(beam_size=5, beam_cut_threshold=0.0, batch_size=8)
    want = jax_pipeline.decode_many_duplex(pairs, ALPHA, engine="exact", **kw)
    ckpt = os.path.join(tmp_path, "duplex.jsonl")
    jax_pipeline.decode_many_duplex(pairs[:2], ALPHA, engine="exact", checkpoint_path=ckpt, **kw)
    with open(ckpt) as f:
        lines = f.read().splitlines()
    head = json.loads(lines[0])
    head["meta"]["engine"] = "exact-pallas"  # the header as the JAX tree kernel writes it
    with open(ckpt, "w") as f:
        f.write("\n".join([json.dumps(head)] + lines[1:]) + "\n")
    with pytest.raises(ValueError, match="different decode"):
        decode_many_duplex(pairs, ALPHA, engine="fast", device="cpu", checkpoint_path=ckpt, **kw)
    got = decode_many_duplex(pairs, ALPHA, engine="exact", device="cpu", checkpoint_path=ckpt, **kw)
    assert got == want and all(e == errors.OK for _, e in got)


@pytest.mark.parametrize("moving", [False, True])
def test_slot_engine_names_resume_as_one_class_only_on_constant_windows(tmp_path, moving):
    """A JAX checkpoint of its slot kernel ("pallas") resumes under the port's
    plain slot engine when every pair's window is constant (full range or a
    constant envelope), where the slot engines agree; with a moving window
    in the stream it does not."""
    rng = np.random.RandomState(8)
    pairs = []
    for i in range(4):
        t1, t2 = (12, 14) if i == 0 else (int(rng.randint(6, 12)), int(rng.randint(8, 14)))
        p1, p2 = pair(80 + i, t1, t2)  # pair 0 fixes the bucket edges
        env = np.stack([np.zeros(t1, np.int64), np.full(t1, t2 - 1, np.int64)], 1)
        pairs.append((p1, p2, diag_env(t1, t2, 3) if moving and i == 3 else env))
    kw = dict(beam_size=5, beam_cut_threshold=0.0, batch_size=8)
    ckpt = os.path.join(tmp_path, "duplex.jsonl")
    jax_pipeline.decode_many_duplex(pairs[:2], ALPHA, engine="fast", checkpoint_path=ckpt, **kw)
    with open(ckpt) as f:
        lines = f.read().splitlines()
    head = json.loads(lines[0])
    head["meta"]["engine"] = "pallas"
    with open(ckpt, "w") as f:
        f.write("\n".join([json.dumps(head)] + lines[1:]) + "\n")
    if moving:
        with pytest.raises(ValueError, match="different decode"):
            decode_many_duplex(pairs, ALPHA, engine="fast", device="cpu", checkpoint_path=ckpt, **kw)
    else:
        got = decode_many_duplex(pairs, ALPHA, engine="fast", device="cpu", checkpoint_path=ckpt, **kw)
        assert got == jax_pipeline.decode_many_duplex(pairs, ALPHA, engine="fast", **kw)


@pytest.mark.parametrize("beam,t2_fits", [(8, 894), (5, 1431), (1, 7166)])
def test_auto_sends_a_constant_window_past_the_slot_kernels_band_bound_to_the_tree(beam, t2_fits):
    """The slot kernel's band bound (8 * K * (T2 + 2) * 4 <= 224 KiB on the
    full range) decides auto's route on a CUDA device to the cell: the widest
    band that fits goes to the slot kernel, one cell more to the tree kernel,
    on the CPU both to the plain slot engine, and a moving window to the tree
    engine whatever its width.  A CRF constant window goes to the CRF tree
    kernel on CUDA at any width."""
    for T2n, want in ((t2_fits, "cuda"), (t2_fits + 1, "exact")):
        lo = np.zeros((2, 3), np.int32)
        hi = np.full((2, 3), T2n, np.int32)
        assert duplex_cuda.fits_shared_memory(beam, T2n + 2) == (want == "cuda")
        assert port_pipeline.auto_duplex_engine(lo, hi, "cuda", beam) == want
        assert port_pipeline.auto_duplex_engine(lo, hi, "cpu", beam) == "fast"
        assert port_pipeline.auto_duplex_engine(lo, hi, "cuda", beam, crf=True) == "exact"
        assert port_pipeline.auto_duplex_engine(lo, hi, "cpu", beam, crf=True) == "fast"
        hi[:, 0] = T2n - 1  # the window moves
        assert port_pipeline.auto_duplex_engine(lo, hi, "cuda", beam) == "exact"
