"""How the exact duplex engine cuts a batch into launches, on the CPU.

``pipeline.exact_chunk_pairs`` sizes one launch from plain integers: the
plain engine on the CPU keeps the JAX package's 2 GB of tables a call, and
on a CUDA device ``exact_launch_pairs`` hands it the card's free memory and
one wave of the tree kernel's blocks (here with ``torch.cuda`` stood in).
A pair's result does not depend on its chunk: a batch run in one chunk and
in several gives equal result dicts (tolerance 0), equal to the JAX
package's ``duplex_exact_batch`` on the same seeded inputs.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from duplex_helpers import diag_env, random_data
from fast_ctc_decode_tpu.ops import duplex as jax_dx
from fast_ctc_decode_tpu_torch.ops import duplex as port_dx
from fast_ctc_decode_tpu_torch.ops import duplex_exact_cuda
from fast_ctc_decode_tpu_torch.ops import duplex_fast as port_df
from fast_ctc_decode_tpu_torch.parallel import pipeline

torch.set_num_threads(1)

FIELDS = ("labels_rev", "count", "err")
B, T1, T2 = 7, 10, 12


def crf_full_range_per_pair():
    """Bytes of scratch a pair of the CRF full range at T1 = T2 = 500, beam 5,
    A = 4 takes: W = 501 and the JAX package's node budget."""
    W = port_df._prep_envelope_fast(np.stack([np.zeros(500, np.int64),
                                              np.full(500, 500, np.int64)], 1), 500).W
    N = port_dx._duplex_max_nodes(500, 5, 4, W)
    assert (W, N) == (501, 10_008) and N == jax_dx._duplex_max_nodes(500, 5, 4, W)
    return 4 * duplex_exact_cuda.scratch_stride(N, 5, 4, W)


def test_cpu_sizing_keeps_49_pairs_of_the_crf_full_range():
    per_pair = crf_full_range_per_pair()
    assert per_pair == 40_532_440
    chunk = pipeline.exact_chunk_pairs(256, per_pair, pipeline.EXACT_CHUNK_BYTES)
    assert chunk == 49 == pipeline.EXACT_CHUNK_BYTES // per_pair
    assert len(range(0, 256, chunk)) == 6  # 5 x 49 + 11
    # an 80 GB card holds the whole batch (10.4 GB) in one launch
    assert pipeline.exact_chunk_pairs(256, per_pair, int(0.9 * 79e9), 132 * 4) == 256


@pytest.mark.parametrize(
    "B_, per_pair, budget, wave, want",
    [
        (256, 100, 10_000, 0, 100),  # the budget caps
        (50, 100, 10_000, 0, 50),  # B caps
        (0, 100, 10_000, 0, 1),  # an empty batch: one empty call
        (1, 100, 100, 0, 1),  # one pair just fits
        (4000, 1, 1500, 1056, 1056),  # whole waves where a wave fits
        (4000, 1, 2200, 1056, 2112),
        (4000, 1, 1000, 1056, 1000),  # less than a wave: what fits
        (1400, 1, 1500, 1056, 1400),  # all of B fits: one launch
    ],
)
def test_exact_chunk_pairs_caps(B_, per_pair, budget, wave, want):
    assert pipeline.exact_chunk_pairs(B_, per_pair, budget, wave) == want


def test_exact_chunk_pairs_raises_when_one_pair_does_not_fit():
    with pytest.raises(MemoryError, match=r"40532440 bytes\) exceeds the budget of 40532439"):
        pipeline.exact_chunk_pairs(256, 40_532_440, 40_532_439)
    with pytest.raises(MemoryError):
        pipeline.exact_chunk_pairs(1, 10, -5)


def pair_batch(crf, env):
    if crf:
        rng = np.random.RandomState(31)
        n1 = rng.rand(B, T1, 4, 5).astype(np.float32)
        n2 = rng.rand(B, T2, 4, 5).astype(np.float32)
        n1 /= n1.sum(-1, keepdims=True)
        n2 /= n2.sum(-1, keepdims=True)
        i1, i2 = rng.rand(B, 4).astype(np.float32), rng.rand(B, 4).astype(np.float32)
        return pipeline.prep_duplex_batch(n1, n2, env, None, 0.0, T1=T1, T2=T2, init1=i1,
                                          init2=i2)
    n1 = np.stack([random_data(T1, 5, 40 + i) for i in range(B)])
    n2 = np.stack([random_data(T2, 5, 80 + i) for i in range(B)])
    return pipeline.prep_duplex_batch(n1, n2, env, None, 0.0, T1=T1, T2=T2)


def test_card_budget_from_free_memory(monkeypatch):
    """On a CUDA device the budget is EXACT_FREE_SHARE of the free memory
    (``cudaMemGetInfo``'s plus the caching allocator's unused), less the batch's own
    bytes, in whole waves of SMs x blocks per SM; stood in for torch.cuda."""
    batch = pair_batch(True, None)
    per_pair = 4 * duplex_exact_cuda.scratch_stride(batch.max_nodes(5), 5, 4, batch.W)
    mem = {"free": 0, "cached": 2 * per_pair}
    shapes = []
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (mem["free"], 10**12))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: per_pair + mem["cached"])
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: per_pair)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=2))
    monkeypatch.setattr(duplex_exact_cuda, "launch_shape",
                        lambda K, W, crf: shapes.append((K, W, crf)) or {"blocks_per_sm": 1})
    cuda = torch.device("cuda", 0)

    def pairs(free, cached=2 * per_pair):
        mem["free"], mem["cached"] = free, cached
        return pipeline.exact_launch_pairs(batch, cuda, beam_size=5, crf=True)

    # free + cached = 7 pairs' worth plus the batch: 0.9 of it holds 6 pairs,
    # rounded down to whole waves of 2 pairs
    assert pairs(5 * per_pair + batch.nbytes()) == 6
    assert shapes[-1] == (5, batch.W, True)
    assert pairs(4 * per_pair) == 4  # budget 0.9 * 6 pairs less the batch
    assert pairs(100 * per_pair) == B
    assert pairs(0) == 1  # 0.9 of the cached two pairs, less the batch
    with pytest.raises(MemoryError, match="exceeds the budget"):
        pairs(0, cached=per_pair)
    # the CPU keeps EXACT_CHUNK_BYTES, and at least one pair a chunk
    assert pipeline.exact_launch_pairs(batch, "cpu", beam_size=5, crf=True) == B
    assert pipeline.exact_launch_pairs(batch, "cpu", beam_size=5, crf=True,
                                       budget_bytes=2 * per_pair) == 2


def jax_exact(batch, env, crf):
    """JAX ``duplex_exact_batch`` on the batch's arrays, its static widths
    from the JAX package's own envelope preparation."""
    envs = np.stack([np.zeros(T1, np.int64), np.full(T1, T2, np.int64)], 1) if env is None \
        else env
    ep = jax_dx._prep_envelope(envs, T2)
    assert ep[2] == batch.W and ep[4] == batch.tree_needs_ext
    return jax_dx.duplex_exact_batch(
        batch.l1, batch.l2, batch.root_gap, batch.lo, batch.hi, batch.thr, batch.init_states,
        batch.lengths, beam_size=5, collapse_repeats=not crf, max_nodes=batch.max_nodes(5),
        W=batch.W, Wr=batch.root_gap.shape[1], Wext=ep[5], needs_ext=batch.tree_needs_ext,
        crf=crf)


@pytest.mark.parametrize("crf", [False, True], ids=["plain", "crf"])
@pytest.mark.parametrize("env", [None, diag_env(T1, T2, 3)], ids=["full", "diag3"])
def test_chunks_give_one_chunks_result(monkeypatch, crf, env):
    batch = pair_batch(crf, env)
    calls = []
    plain = port_dx.duplex_exact_batch

    def counted(l1, *args, **kw):
        calls.append(l1.shape[0])
        return plain(l1, *args, **kw)

    monkeypatch.setattr(port_dx, "duplex_exact_batch", counted)
    kw = dict(beam_size=5, collapse=not crf, crf=crf)
    one = pipeline.run_duplex_engine("exact", batch, "cpu", **kw)
    assert calls == [B]
    per_pair = 4 * duplex_exact_cuda.scratch_stride(batch.max_nodes(5), 5, 4, batch.W)
    calls.clear()
    many = pipeline.run_duplex_engine("exact", batch, "cpu", budget_bytes=2 * per_pair, **kw)
    assert calls == [2, 2, 2, 1]
    want = jax_exact(batch, env, crf)
    for k in FIELDS:
        assert one[k].dtype == many[k].dtype == torch.int32, k
        assert torch.equal(one[k], many[k]), k
        assert np.array_equal(one[k].numpy(), np.asarray(want[k])), k
    assert int((one["err"] == 0).sum()) >= 1
