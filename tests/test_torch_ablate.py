"""The port's phase ablation (``tools/kernel_ablate.py``) against the JAX tool's.

``ablate_plain`` (the plain version of the ablation kernel) must equal the
JAX tool's Pallas kernel ``tools/kernel_ablate.py::_kernel`` bit for bit on
``fin`` and ``err`` (int32, tolerance 0), for each of the nine sets the tool
times.  The JAX kernel runs through this test's own
``pl.pallas_call(..., interpret=True)``, built as its ``run_ablate`` builds
it (B=8, T=16, blocks of 8).  Inputs are made with numpy from a seed.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fast_ctc_decode_tpu_torch.ops import beam_fast
from fast_ctc_decode_tpu_torch.tools import kernel_ablate

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_ablate", os.path.join(_ROOT, "tools", "kernel_ablate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_ablate(probs, lengths, thr, *, beam_size, ablate, block=8):
    """The JAX tool's ``run_ablate`` with ``interpret=True`` and small blocks."""
    B, T, A1 = probs.shape
    K, KP, TB, Bt = beam_size, 8, block, block
    kernel = functools.partial(
        _jax_tool()._kernel, K=K, KP=KP, A=A1 - 1, TB=TB, collapse=True,
        ablate=tuple(ablate.split(",")) if ablate else (),
    )
    probs_t = jnp.transpose(jnp.asarray(probs).reshape(B, T * A1), (1, 0)).reshape(T, A1, B)
    _, fin, err = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0,
            grid=(B // Bt, T // TB),
            in_specs=[
                pl.BlockSpec((1, 1), lambda i, j: (0, 0), memory_space=pltpu.SMEM),
                pl.BlockSpec((TB, A1, Bt), lambda i, j: (j, 0, i)),
                pl.BlockSpec((1, Bt), lambda i, j: (0, i)),
            ],
            out_specs=[
                pl.BlockSpec((TB, KP, Bt), lambda i, j: (j, 0, i)),
                pl.BlockSpec((1, Bt), lambda i, j: (0, i)),
                pl.BlockSpec((1, Bt), lambda i, j: (0, i)),
            ],
            scratch_shapes=[pltpu.VMEM((KP, Bt), jnp.float32)] * 2
            + [pltpu.VMEM((KP, Bt), jnp.int32)] * 5
            + [pltpu.VMEM((1, Bt), jnp.int32)],
        ),
        out_shape=[
            jax.ShapeDtypeStruct((T, KP, B), jnp.int32),
            jax.ShapeDtypeStruct((1, B), jnp.int32),
            jax.ShapeDtypeStruct((1, B), jnp.int32),
        ],
        interpret=True,
    )(jnp.asarray(thr, jnp.float32).reshape(1, 1), probs_t,
      jnp.asarray(lengths, jnp.int32).reshape(1, B))
    return np.asarray(fin)[0], np.asarray(err)[0]


def inputs():
    rng = np.random.RandomState(5)
    probs = rng.rand(8, 16, 5).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    probs[3] = 0.01  # every entry under the cut: the beam runs out
    probs[5, 4, 2] = np.nan  # a NaN label: incomparable values
    lengths = np.array([16, 11, 16, 16, 0, 16, 7, 16], np.int32)
    return probs, lengths, 0.1


@pytest.mark.parametrize("ablate", kernel_ablate.SETS)
def test_ablate_plain_equals_jax_kernel(ablate):
    probs, lengths, thr = inputs()
    want_fin, want_err = jax_ablate(probs, lengths, thr, beam_size=5, ablate=ablate)
    got = kernel_ablate.run_ablate(torch.from_numpy(probs), torch.from_numpy(lengths), thr,
                                   beam_size=5, ablate=ablate)
    assert got["fin"].dtype == torch.int32 and got["err"].dtype == torch.int32
    assert np.array_equal(got["fin"].numpy(), want_fin)
    assert np.array_equal(got["err"].numpy(), want_err)


def test_no_ablation_equals_the_plain_engine():
    probs, lengths, thr = inputs()
    p, ln = torch.from_numpy(probs), torch.from_numpy(lengths)
    got = kernel_ablate.ablate_plain(p, ln, thr, beam_size=5)
    _, fin, err = beam_fast.beam_search_ids_batch(p, ln, np.float32(thr), beam_size=5)
    assert torch.equal(got["fin"], fin) and torch.equal(got["err"], err)
    assert sorted(set(err.tolist())) == [0, 1, 2]
    # the stubs change the result: they are wrong on purpose
    assert not torch.equal(
        kernel_ablate.ablate_plain(p, ln, thr, beam_size=5, ablate="err")["err"], err)
    assert not torch.equal(
        kernel_ablate.ablate_plain(p, ln, thr, beam_size=5, ablate="rounds")["fin"], fin)


@pytest.mark.parametrize("ablate", ["nope", "mix,err", "idlog,hpick", "rounds,rounds,x"])
def test_unknown_set_raises(ablate):
    probs, lengths, thr = inputs()
    with pytest.raises(ValueError):
        kernel_ablate.run_ablate(torch.from_numpy(probs), torch.from_numpy(lengths), thr,
                                 beam_size=5, ablate=ablate)


def test_wider_shape_raises():
    probs, lengths, thr = inputs()
    with pytest.raises(ValueError, match="one instance"):
        kernel_ablate.run_ablate(torch.from_numpy(probs), torch.from_numpy(lengths), thr,
                                 beam_size=6)
