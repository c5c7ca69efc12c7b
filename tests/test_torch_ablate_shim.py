"""The phase-ablation kernel's body on the CPU, through the host shim.

``csrc/beam_ablate_kernel.cu`` (version 1 of ``csrc/beam_core.cuh`` with a
compile-time phase mask, nine sets) is compiled with g++ against the
stand-in ``cuda_runtime.h`` of ``tests/test_torch_beam_shim.py``, beside
``beam_v1_kernel.cu`` and ``beam_kernel.cu``.  The wrapper's launch path
(``tools.kernel_ablate._launch``) then runs the kernel body on CPU tensors,
and ``fin`` and ``err`` are held bit for bit to ``ablate_plain`` for each set,
and the unstubbed kernel to version 1, on small seeded cases: the shapes of
``chip_smoke.parity_cases`` within the kernel's one instance (beam <= 5,
A+1 <= 5; NaN, +-inf, -0.0, zero lengths), ragged lengths, and posteriors
that tie.  Skipped where g++ is missing.
"""

import contextlib
import os
import sys
import types

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu_torch.ops import _build, beam_cuda
from fast_ctc_decode_tpu_torch.tools import kernel_ablate

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the parity cases held on the card)
from test_torch_beam_shim import build_shim_library  # noqa: E402

torch.set_num_threads(1)

SOURCES = ("beam_ablate_kernel.cu", "beam_v1_kernel.cu", "beam_kernel.cu")


@pytest.fixture(scope="module")
def ablate_library(tmp_path_factory):
    import ctypes

    lib = build_shim_library(tmp_path_factory.mktemp("ablate_shim"), SOURCES,
                             "libablate_shim.so")
    lib.ctc_cuda_error_string.restype = ctypes.c_char_p
    lib.ctc_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture
def shim(ablate_library, monkeypatch):
    """The launch paths bound to the shim library, on CPU tensors."""
    monkeypatch.setattr(_build, "load_library", lambda: ablate_library)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=None))
    return ablate_library


def _cases():
    """(name, probs, lengths, thr, beam_size) within the kernel's instance."""
    cases = [(name, p, ln, thr, K)
             for name, p, ln, thr, K, _ in chip_smoke.parity_cases(full_width=False)
             if K <= kernel_ablate.MAX_BEAM and p.shape[2] - 1 <= kernel_ablate.MAX_A]
    rng = np.random.RandomState(90)
    cases.append(("ragged_B40", chip_smoke.make_reads(40, 48, 5, 91),
                  list(rng.randint(0, 49, size=40)), 0.1, 5))
    ties = (np.random.RandomState(92).rand(6, 40, 5) > 0.5).astype(np.float32) * 0.9 + 0.05
    cases.append(("ties", ties, [40, 40, 33, 0, 40, 12], 0.1, 5))
    cases.append(("beam3_A1=4", chip_smoke.make_reads(5, 36, 4, 93), [36, 0, 20, 36, 1],
                  0.05, 3))
    return cases


CASES = _cases()


def _tensors(probs, lengths):
    return (torch.from_numpy(np.ascontiguousarray(probs)),
            torch.tensor(lengths, dtype=torch.int32))


@pytest.mark.parametrize("ablate", kernel_ablate.SETS, ids=[s or "none" for s in kernel_ablate.SETS])
def test_each_set_equals_ablate_plain(shim, ablate):
    mask = kernel_ablate.phase_mask(ablate)
    bad = []
    for name, probs, lengths, thr, K in CASES:
        p, ln = _tensors(probs, lengths)
        want = kernel_ablate.ablate_plain(p, ln, thr, beam_size=K, ablate=ablate)
        got = kernel_ablate._launch(p, ln, thr, K=K, mask=mask, what=ablate or "none")
        if not all(torch.equal(got[f], want[f]) for f in ("fin", "err")):
            bad.append(name)
    assert bad == []


def test_unstubbed_kernel_equals_version_1(shim):
    bad = []
    for name, probs, lengths, thr, K in CASES:
        p, ln = _tensors(probs, lengths)
        B, T, A1 = p.shape
        _, fin, err = beam_cuda._thread_launch(p, ln, thr, B=B, T=T, A=A1 - 1, K=K,
                                               collapse=True, version=1)
        got = kernel_ablate._launch(p, ln, thr, K=K, mask=0, what="none")
        if not (torch.equal(got["fin"], fin) and torch.equal(got["err"], err)):
            bad.append(name)
    assert bad == []


def test_launch_function_refuses_other_masks_and_shapes(shim):
    p, ln = _tensors(chip_smoke.make_reads(2, 6, 6, 0), [6, 6])
    with pytest.raises(RuntimeError, match="launch failed"):  # A+1 = 6: past <5, 4>
        kernel_ablate._launch(p, ln, 0.1, K=5, mask=0, what="none")
    p, ln = _tensors(chip_smoke.make_reads(2, 6, 5, 0), [6, 6])
    with pytest.raises(RuntimeError, match="launch failed"):  # beam 6
        kernel_ablate._launch(p, ln, 0.1, K=6, mask=0, what="none")
    with pytest.raises(RuntimeError, match="launch failed"):  # mix + err: no instance
        kernel_ablate._launch(p, ln, 0.1, K=5, mask=2 | 8, what="mix,err")


@pytest.mark.parametrize("ablate", [s for s in kernel_ablate.SETS if "rounds" in s])
def test_rounds_leaves_every_slot_past_0_empty(shim, ablate):
    # The one-slot list keeps slots 1..K-1 in their empty initial state, so
    # slot 0 holds the only valid tip and the ids of valid tips never repeat:
    # the one-pass word needs no rule for two valid tips with one id.
    mask = kernel_ablate.phase_mask(ablate)
    for name, probs, lengths, thr, K in CASES:
        p, ln = _tensors(probs, lengths)
        B, T, A1 = p.shape
        ids_log = torch.full((T, K, B), 7, dtype=torch.int32)
        fin = torch.empty((B,), dtype=torch.int32)
        err = torch.empty((B,), dtype=torch.int32)
        rc = shim.ctc_beam_ablate_launch(
            p.data_ptr(), ln.data_ptr(), float(thr), B, T, A1 - 1, K, mask,
            ids_log.data_ptr(), fin.data_ptr(), err.data_ptr(), None)
        assert rc == 0, name
        assert bool((ids_log[:, 1:] == -2).all()), name
        assert bool((ids_log[0, 0] == -1).all()), name  # the root, logged at step 0
