"""The PyTorch port's plain traceback against the JAX package's.

Id logs come from the JAX engine (the fused Pallas beam in interpret mode,
``raw=True``, on the CPU), including reads that end with an error and a
final id of -2.  The port's ``_traceback_scan_batch`` must equal JAX's
``_traceback_scan_batch`` on them exactly (int32, tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_ctc_decode_tpu import errors
from fast_ctc_decode_tpu.ops import beam_fast as jax_beam_fast
from fast_ctc_decode_tpu.ops import beam_pallas as jax_beam_pallas
from fast_ctc_decode_tpu_torch.ops import beam_cuda
from fast_ctc_decode_tpu_torch.ops import beam_fast as torch_beam_fast

torch.set_num_threads(1)


def rand_batch(B, T, A1, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def jax_id_log():
    """(fin [B], ids_log [T, K, B], err [B], T, K, A) from the JAX kernel."""
    B, T, A1, K = 6, 24, 5, 5
    probs = rand_batch(B, T, A1, 9)
    probs[1, 4, 3] = np.nan  # INCOMPARABLE_VALUES mid-read
    probs[2] = 0.01  # RAN_OUT_OF_BEAM at the first step: fin = -2
    lengths = np.array([24, 24, 24, 11, 0, 24], np.int32)
    raw = jax_beam_pallas.beam_search_pallas_batch(
        probs, lengths, np.float32(0.19), beam_size=K, interpret=True, raw=True,
    )
    fin = np.array(raw["fin"][0, :B])
    ids_log = np.array(raw["ids_log"][:T, :K, :B])
    return fin, ids_log, np.asarray(raw["err"]), T, K, A1 - 1


def _jax_traceback(fin, ids_log, T, K, A):
    out = jax_beam_fast._traceback_scan_batch(
        jnp.asarray(fin), jnp.asarray(ids_log), T, K, A
    )
    return [np.asarray(x) for x in out]


def _torch_traceback(fin, ids_log, T, K, A):
    out = torch_beam_fast._traceback_scan_batch(
        torch.from_numpy(fin), torch.from_numpy(ids_log), T, K, A
    )
    return [x.numpy() for x in out]


def test_log_covers_error_reads(jax_id_log):
    fin, _, err, _, _, _ = jax_id_log
    assert err[1] == errors.INCOMPARABLE_VALUES
    assert err[2] == errors.RAN_OUT_OF_BEAM
    assert fin[2] == -2


def test_traceback_equals_jax(jax_id_log):
    fin, ids_log, _, T, K, A = jax_id_log
    want = _jax_traceback(fin, ids_log, T, K, A)
    got = _torch_traceback(fin, ids_log, T, K, A)
    for w, g in zip(want, got):
        assert g.dtype == np.int32 and np.array_equal(w, g)
    assert got[2][4] == 0  # the length-0 read emits nothing


def test_traceback_equals_jax_on_forced_final_ids(jax_id_log):
    # every read restarted from an arbitrary logged id, the root, or -2
    fin, ids_log, _, T, K, A = jax_id_log
    fin = fin.copy()
    fin[0] = ids_log[T - 1, 3, 0]
    fin[3] = -1
    fin[5] = -2
    want = _jax_traceback(fin, ids_log, T, K, A)
    got = _torch_traceback(fin, ids_log, T, K, A)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


def test_kernel_wrapper_uses_plain_traceback_on_cpu(jax_id_log):
    fin, ids_log, _, T, K, A = jax_id_log
    before = dict(beam_cuda.launches)
    got = beam_cuda.traceback_kernel(
        torch.from_numpy(fin), torch.from_numpy(ids_log), T=T, K=K, A=A
    )
    assert beam_cuda.launches == before
    for w, g in zip(_jax_traceback(fin, ids_log, T, K, A), got):
        assert np.array_equal(w, g.numpy())


def test_sort_unpack_keys_equals_jax():
    T, A = 37, 4
    lab_bits, t_bits = torch_beam_fast._key_bits(T, A)
    assert (lab_bits, t_bits) == jax_beam_fast._key_bits(T, A)
    rng = np.random.RandomState(3)
    lab1 = rng.randint(0, A + 1, size=(T, 5)).astype(np.int32)
    gap = 1 << (lab_bits + t_bits)
    i_col = np.arange(T, dtype=np.int32)[:, None] << lab_bits
    key = (np.where(lab1 == 0, gap, 0) | i_col | lab1).astype(np.int32).T
    want = jax_beam_fast._sort_unpack_keys(jnp.asarray(key), T, lab_bits, t_bits)
    got = torch_beam_fast._sort_unpack_keys(
        torch.from_numpy(np.ascontiguousarray(key)), T, lab_bits, t_bits
    )
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_wide_key_compaction_equals_packed():
    # the stable-sort form taken when the packed key does not fit 30 bits
    T, A = 50, 6
    rng = np.random.RandomState(4)
    lab1 = torch.from_numpy(rng.randint(0, A + 1, size=(T, 7)).astype(np.int32))
    lab_bits, t_bits = torch_beam_fast._key_bits(T, A)
    packed = torch_beam_fast._compact_packed(lab1, T, lab_bits, t_bits)
    stable = torch_beam_fast._compact_stable(lab1, T)
    for p, s in zip(packed, stable):
        assert p.dtype == s.dtype == torch.int32
        assert torch.equal(p, s)
