"""The hash beam kernels' bodies on the CPU, through a host shim.

The CUDA sources of the hash beam (``csrc/beam_kernel.cu``,
``beam_v1_kernel.cu``, ``beam_v3_kernel.cu`` over ``beam_core.cuh``: one
thread per read; ``beam_warp_kernel.cu``: one warp per read, 1D and CRF)
are compiled with g++ against a stand-in ``cuda_runtime.h``: every thread of
a block is a ``std::thread``, warp collectives go through a barrier and a
32-slot exchange buffer, ``__shared__`` is ``static`` (blocks run one at a
time), and ``__fadd_rn`` and its kin are plain IEEE operations kept out of
contraction (``-ffp-contract=off``).  Each ``kernel<<<grid, block, smem,
stream>>>(args)`` launch becomes a host loop over the blocks.  The wrappers'
launch paths (``beam_cuda._thread_launch`` / ``_warp_launch``) then run the
kernel bodies on CPU tensors, and each output is held to the plain engines
bit for bit, on the parity cases that ``chip_smoke.py`` runs on the card
(all but the full-width ones), on partial blocks and at each instance's
just-fits and just-misses.

The shim checks the kernels' logic, not the card: nvcc, warp scheduling and
memory ordering are the card's own (``chip_smoke.py``).  The tests skip
where g++ is missing.
"""

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu_torch.ops import _build, beam_cuda

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the parity cases held on the card)

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(beam_cuda.__file__), os.pardir, "csrc")
SOURCES = ("beam_kernel.cu", "beam_v1_kernel.cu", "beam_v3_kernel.cu", "beam_warp_kernel.cu")
LAUNCH = re.compile(
    r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>\((.*?)\);", re.S)

SHIM_HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
inline thread_local dim3 threadIdx, blockIdx, blockDim;
struct WarpCtx {
  std::barrier<>* bar;
  uint64_t* xch;
};
inline thread_local WarpCtx g_warp;
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned x; std::memcpy(&x, &f, 4); return x; }
using std::isnan;
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline void __syncwarp() { g_warp.bar->arrive_and_wait(); }
template <class T> T __shfl_sync(unsigned, T v, int src) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  g_warp.bar->arrive_and_wait();
  g_warp.xch[threadIdx.x & 31] = u;
  g_warp.bar->arrive_and_wait();
  const uint64_t r = g_warp.xch[src & 31];
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  g_warp.bar->arrive_and_wait();
  g_warp.xch[threadIdx.x & 31] = p ? 1 : 0;
  g_warp.bar->arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (g_warp.xch[i] ? 1u : 0u) << i;
  return m;
}
inline bool __any_sync(unsigned mask, bool p) { return __ballot_sync(mask, p) != 0u; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host shim"; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, int) {
  *n = 1;
  return 0;
}
template <class Fn> void host_launch(dim3 grid, dim3 block, Fn fn) {
  const int nw = (block.x + 31) / 32;
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::vector<uint64_t>> xch(nw, std::vector<uint64_t>(32));
    for (int i = 0; i < nw; ++i) bars.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> th;
    for (unsigned tx = 0; tx < block.x; ++tx)
      th.emplace_back([&, tx, bx] {
        threadIdx = dim3(tx);
        blockIdx = dim3(bx);
        blockDim = block;
        g_warp = WarpCtx{bars[tx / 32].get(), xch[tx / 32].data()};
        fn();
      });
    for (auto& t : th) t.join();
  }
}
"""


@pytest.fixture(scope="module")
def shim_library(tmp_path_factory):
    """The hash beam sources built by g++ against the stand-in runtime."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host shim cannot be built")
    out = tmp_path_factory.mktemp("beam_shim")
    (out / "cuda_runtime.h").write_text(SHIM_HEADER)
    for name in ("beam_core.cuh",) + SOURCES:
        with open(os.path.join(CSRC, name)) as f:
            text = f.read()
        (out / name).write_text(LAUNCH.sub(
            lambda m: f"host_launch(dim3({m.group(2)}), dim3({m.group(3)}), "
                      f"[&] {{ {m.group(1)}({m.group(4)}); }});", text))
    lib_path = out / "libbeam_shim.so"
    subprocess.run(
        [gxx, "-x", "c++", "-O1", "-std=c++20", "-ffp-contract=off", "-pthread", "-shared",
         "-fPIC", "-I", str(out), "-o", str(lib_path), *(str(out / n) for n in SOURCES)],
        check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    for name, args in _build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
    lib.ctc_cuda_error_string.restype = ctypes.c_char_p
    lib.ctc_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture
def shim(shim_library, monkeypatch):
    """The wrappers' launch paths bound to the shim library, on CPU tensors."""
    monkeypatch.setattr(_build, "load_library", lambda: shim_library)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=None))
    return shim_library


def _equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _run_1d(probs, lengths, thr, K, collapse, rpb):
    """Every one-thread-per-read version and the warp body against the plain
    engine: the names of the bodies that differ."""
    p = torch.from_numpy(np.ascontiguousarray(probs))
    ln = torch.tensor(lengths, dtype=torch.int32)
    B, T, A1 = p.shape
    want = beam_cuda.beam_ids_plain(p, ln, thr, beam_size=K, collapse_repeats=collapse)
    got = {f"thread v{v}": beam_cuda._thread_launch(
        p, ln, thr, B=B, T=T, A=A1 - 1, K=K, collapse=collapse, version=v) for v in (1, 2, 3)}
    got["warp"] = beam_cuda._warp_launch(
        p, None, ln, thr, B=B, T=T, S=1, Si=1, A=A1 - 1, K=K, collapse=collapse, crf=False,
        rpb=rpb)
    return [name for name, out in got.items() if not _equal(out, want)]


def _run_crf(probs, init, lengths, thr, K, rpb):
    p = torch.from_numpy(np.ascontiguousarray(probs))
    ini = torch.from_numpy(np.ascontiguousarray(init))
    ln = torch.tensor(lengths, dtype=torch.int32)
    B, T, S, A1 = p.shape
    want = beam_cuda.crf_beam_ids_plain(p, ini, ln, thr, beam_size=K)
    got = beam_cuda._warp_launch(p, ini, ln, thr, B=B, T=T, S=S, Si=ini.shape[1], A=A1 - 1,
                                 K=K, collapse=False, crf=True, rpb=rpb)
    return _equal(got, want)


PARITY = chip_smoke.parity_cases(full_width=False)
CRF = chip_smoke.crf_cases(full_width=False)


@pytest.mark.parametrize("i", range(len(PARITY)), ids=[c[0] for c in PARITY])
def test_1d_bodies_equal_the_plain_engine(shim, i):
    _, probs, lengths, thr, K, collapse = PARITY[i]
    assert _run_1d(probs, lengths, thr, K, collapse, (1, 2, 4, 8)[i % 4]) == []


@pytest.mark.parametrize("i", range(len(CRF)), ids=[c[0] for c in CRF])
def test_crf_body_equals_the_plain_engine(shim, i):
    _, probs, init, lengths, thr, K, _ = CRF[i]
    assert _run_crf(probs, init, lengths, thr, K, (1, 2, 4, 8)[i % 4])


@pytest.mark.parametrize("rpb", [1, 2, 4, 8])
def test_warp_body_partial_blocks(shim, rpb):
    # B = 1 and B = 33 leave the last block of rpb reads part empty
    for B, seed in ((1, 3), (33, 4)):
        probs = chip_smoke.make_reads(B, 24, 5, seed)
        lengths = list(np.random.RandomState(seed).randint(0, 25, size=B))
        assert _run_1d(probs, lengths, 0.05, 5, True, rpb) == []
        crf, init = chip_smoke.make_crf_reads(B, 16, 8, 5, seed)
        assert _run_crf(crf, init, lengths, 0.05, 5, rpb)


@pytest.mark.parametrize(
    "K, A1",
    [
        (1, 2),
        (5, 5),  # just fits the narrow instance <5, 4>
        (6, 5),  # one tip past it: <16, 7>
        (5, 6),  # one label past it: <16, 7>
        (16, 8),  # just fits the wide instance
    ],
)
def test_instances_just_fit(shim, K, A1):
    probs = chip_smoke.make_reads(3, 20, A1, K)
    lengths = [20, 11, 0]
    assert _run_1d(probs, lengths, 0.0, K, True, 4) == []
    crf, init = chip_smoke.make_crf_reads(3, 20, A1 - 1, A1, K)
    assert _run_crf(crf, init, lengths, 0.0, K, 4)


@pytest.mark.parametrize("K, A1", [(17, 5), (5, 9)])
def test_instances_just_miss_in_the_launch_functions(shim, K, A1):
    # past every instance the C launch functions refuse, whatever the wrapper checks
    probs = torch.from_numpy(chip_smoke.make_reads(2, 6, A1, 0))
    ln = torch.full((2,), 6, dtype=torch.int32)
    for version in (1, 2, 3):
        with pytest.raises(RuntimeError, match="launch failed"):
            beam_cuda._thread_launch(probs, ln, 0.0, B=2, T=6, A=A1 - 1, K=K, collapse=True,
                                     version=version)
    for crf in (False, True):
        p = probs.view(2, 6, 1, A1) if crf else probs
        init = torch.ones((2, 1)) if crf else None
        with pytest.raises(RuntimeError, match="launch failed"):
            beam_cuda._warp_launch(p, init, ln, 0.0, B=2, T=6, S=1, Si=1, A=A1 - 1, K=K,
                                   collapse=not crf, crf=crf, rpb=4)
