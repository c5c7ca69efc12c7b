"""The traceback kernel's two routes on the CPU, through a host shim.

``csrc/traceback_kernel.cu`` is compiled with g++ against the stand-in
``cuda_runtime.h`` of ``tests/test_torch_beam_shim.py`` (every thread of a
block a ``std::thread``, warp collectives through a barrier and an exchange
buffer), plus a per-block dynamic shared memory filled with poison bytes
before each block and a ``cuda_pipeline.h`` whose ``cp.async`` copies are
queued per thread and land only at ``__pipeline_wait_prior``, group by
group, as the card's may: a tile read before its wait sees poison or an
older tile.  Each ``kernel<<<grid, block, smem, stream>>>(args)`` launch
becomes a host loop over the blocks.  ``beam_cuda._traceback_launch`` then
runs both routes, the sweep and the walk, on CPU tensors, and each output
is held to ``traceback_plain`` bit for bit: on the id logs of the parity
cases that ``chip_smoke.py`` runs on the card (all but the full-width one),
on forced final ids, on duplex-shaped and random logs, on partial warps
(B = 1, 33) and at the route's just-fits and just-misses.

The shim checks the kernel's logic, not the card.  The tests skip where g++
is missing.
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

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)
import chip_smoke  # noqa: E402  (the parity cases held on the card)
from test_torch_beam_shim import CSRC, SHIM_HEADER  # noqa: E402

torch.set_num_threads(1)

SOURCE = "traceback_kernel.cu"
LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\((.*?)\);", re.S)
DYNAMIC_SMEM = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")

EXTRA_HEADER = r"""
#include <algorithm>
using std::max;
using std::min;
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline thread_local unsigned char* g_dynamic_smem;
template <class T> T* shim_dynamic_smem() { return reinterpret_cast<T*>(g_dynamic_smem); }
template <class Fn> void host_launch_smem(dim3 grid, dim3 block, size_t smem, Fn fn) {
  const int nw = (block.x + 31) / 32;
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    std::vector<unsigned char> buf(smem + 16, 0xA5);  // poison: 0xA5A5A5A5 is no valid id
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
        g_dynamic_smem = buf.data();
        fn();
      });
    for (auto& t : th) t.join();
  }
}
"""

PIPELINE_HEADER = r"""
#pragma once
#include <cstddef>
#include <cstring>
#include <deque>
#include <vector>
struct ShimCopy {
  void* dst;
  const void* src;
  size_t n;
};
inline thread_local std::vector<ShimCopy> g_pending;
inline thread_local std::deque<std::vector<ShimCopy>> g_groups;
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n, size_t = 0) {
  g_pending.push_back({dst, src, n});
}
inline void __pipeline_commit() {
  g_groups.push_back(std::move(g_pending));
  g_pending.clear();
}
inline void __pipeline_wait_prior(size_t prior) {
  while (g_groups.size() > prior) {
    for (const ShimCopy& c : g_groups.front()) std::memcpy(c.dst, c.src, c.n);
    g_groups.pop_front();
  }
}
"""


# the kernel's source in one translation unit with a host check of its
# multiply-shift division against the compiler's
DIVISION_CHECK = r"""
#include "traceback_kernel.cu"
extern "C" long long shim_division_mismatches(unsigned d, unsigned n0, unsigned count) {
  const Divisor by(d);
  long long bad = 0;
  for (unsigned n = n0; n - n0 < count && n <= 0x7fffffffu; ++n)
    bad += by.div((int)n) != (int)(n / d);
  return bad;
}
"""


@pytest.fixture(scope="module")
def shim_library(tmp_path_factory):
    """``csrc/traceback_kernel.cu`` built by g++ against the stand-in runtime."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host shim cannot be built")
    out = tmp_path_factory.mktemp("traceback_shim")
    (out / "cuda_runtime.h").write_text(SHIM_HEADER + EXTRA_HEADER)
    (out / "cuda_pipeline.h").write_text(PIPELINE_HEADER)
    with open(os.path.join(CSRC, SOURCE)) as f:
        text = f.read()
    text = DYNAMIC_SMEM.sub(lambda m: f"{m.group(1)}* {m.group(2)} = "
                                      f"shim_dynamic_smem<{m.group(1)}>();", text)
    text, launches = LAUNCH.subn(
        lambda m: f"host_launch_smem(dim3({m.group(2)}), dim3({m.group(3)}), {m.group(4)}, "
                  f"[&] {{ {m.group(1)}({m.group(5)}); }});", text)
    assert launches == 2  # the sweep and the walk
    (out / SOURCE).write_text(text)
    (out / "division_check.cc").write_text(DIVISION_CHECK)
    lib_path = out / "libtraceback_shim.so"
    subprocess.run(
        [gxx, "-x", "c++", "-O1", "-std=c++20", "-pthread", "-shared", "-fPIC", "-I", str(out),
         "-o", str(lib_path), str(out / "division_check.cc")],
        check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.ctc_traceback_launch
    fn.restype = ctypes.c_int
    fn.argtypes = _build.SIGNATURES["ctc_traceback_launch"]
    lib.shim_division_mismatches.restype = ctypes.c_longlong
    lib.shim_division_mismatches.argtypes = [ctypes.c_uint] * 3
    lib.ctc_traceback_smem_bytes.restype = ctypes.c_longlong
    lib.ctc_traceback_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ctc_cuda_error_string = lambda rc: b"host shim"
    return lib


@pytest.fixture
def shim(shim_library, monkeypatch):
    """The wrapper's launch path bound to the shim library, on CPU tensors."""
    monkeypatch.setattr(_build, "load_library", lambda: shim_library)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=None))
    return shim_library


def _routes(fin, ids_log, A, *, warps, steps=beam_cuda.TRACEBACK_STEPS, routes=None):
    """Both routes' launches against the plain version: the routes that differ."""
    T, K, B = ids_log.shape
    want = beam_cuda.traceback_plain(fin, ids_log, T=T, K=K, A=A)
    _, fit_steps = beam_cuda.traceback_route(T, K, warps=warps, steps=steps)
    bad = []
    for route in routes or beam_cuda.TRACEBACK_ROUTES:
        got = beam_cuda._traceback_launch(fin, ids_log, B=B, T=T, K=K, A=A, route=route,
                                          warps=warps, steps=fit_steps if route == "sweep" else 0)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            bad.append(route)
    return bad


def _beam_log(probs, lengths, thr, K, collapse):
    p = torch.from_numpy(np.ascontiguousarray(probs))
    ln = torch.tensor(lengths, dtype=torch.int32)
    ids_log, fin, _ = beam_cuda.beam_ids_plain(p, ln, thr, beam_size=K, collapse_repeats=collapse)
    return fin, ids_log


def random_log(T, K, A, B, seed):
    """``chip_smoke.random_log`` (every kind of node id) as CPU tensors."""
    return tuple(torch.from_numpy(x) for x in chip_smoke.random_log(T, K, A, B, seed))


PARITY = chip_smoke.parity_cases(full_width=False)


@pytest.mark.parametrize("i", range(len(PARITY)), ids=[c[0] for c in PARITY])
def test_routes_equal_the_plain_traceback(shim, i):
    _, probs, lengths, thr, K, collapse = PARITY[i]
    fin, ids_log = _beam_log(probs, lengths, thr, K, collapse)
    warps, steps = (1, 2, 4, 8)[i % 4], (1, 3, 16, 32)[i % 4]
    assert _routes(fin, ids_log, probs.shape[2] - 1, warps=warps, steps=steps) == []


def test_routes_on_forced_final_ids(shim):
    _, probs, lengths, thr, K, collapse = PARITY[0]
    fin, ids_log = _beam_log(probs, lengths, thr, K, collapse)
    T, A = ids_log.shape[0], probs.shape[2] - 1
    KA = K * A
    forced = [
        -1, -2,
        int(ids_log[T - 1, 2, 0]),  # restart from a logged entry
        (T - 1) * KA + 3,  # the last step itself
        T * KA,  # a step past the log: no emit
        2**31 - 1,
    ]
    log = ids_log.clone()
    log[5, 1, 0] = 7 * KA + 2  # node (5, 1) -> a later step: the walk stops there
    log[9, 0, 1] = 9 * KA + 1  # node (9, 0) -> the same step
    for f in forced:
        fin_f = fin.clone()
        fin_f[:] = f
        assert _routes(fin_f, ids_log, A, warps=1, steps=4) == []
    fin_f = torch.tensor([5 * KA + 1 * A + 2, 9 * KA + 0 * A + 1, -2, 17 * KA + 5],
                         dtype=torch.int32)
    assert _routes(fin_f, log, A, warps=2, steps=3) == []


@pytest.mark.parametrize("K, A1", [(32, 2), (4, 9)])
def test_routes_on_duplex_shaped_logs(shim, K, A1):
    # the duplex slot kernel's widths: K*A <= 32 with K past the beams' 16 or
    # A+1 past their 8; T = 500 steps as the duplex paths, B = 33
    fin, log = random_log(500, K, A1 - 1, 33, K)
    assert _routes(fin, log, A1 - 1, warps=2, steps=7) == []


@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("warps", [1, 4])
def test_routes_on_partial_warps(shim, B, warps):
    # B = 1 and 33 leave the last warp part empty; 4 warps leave whole warps idle
    probs = chip_smoke.make_reads(B, 40, 5, B + warps)
    lengths = list(np.random.RandomState(B).randint(0, 41, size=B))
    fin, ids_log = _beam_log(probs, lengths, 0.05, 5, True)
    assert _routes(fin, ids_log, 4, warps=warps, steps=6) == []
    fin, log = random_log(40, 5, 4, B, warps)
    assert _routes(fin, log, 4, warps=warps, steps=32) == []


@pytest.mark.parametrize("steps", [3, 5, 7, 32])
def test_routes_on_dense_chains(shim, steps):
    # nodes whose parents sit one or two steps back: a lane emits at nearly
    # every step, so its ring of staged emits fills between the warp's flushes
    T, K, A, B = 150, 5, 4, 40
    rng = np.random.RandomState(steps)
    t = np.arange(T)[:, None, None]
    t_par = t - 1 - (rng.rand(T, K, B) < 0.2)
    log = np.where(t_par >= 0, t_par * K * A + rng.randint(0, K * A, size=(T, K, B)), -1)
    fin = (T - 1 - rng.randint(0, 3, size=B)) * K * A + rng.randint(0, K * A, size=B)
    fin_t = torch.from_numpy(fin.astype(np.int32))
    log_t = torch.from_numpy(np.ascontiguousarray(log.astype(np.int32)))
    assert int(beam_cuda.traceback_plain(fin_t, log_t, T=T, K=K, A=A)[2].min()) > 100
    assert _routes(fin_t, log_t, A, warps=2, steps=steps) == []


def _k_fit(warps):
    """The largest K whose one-step ring fits, by the wrapper's arithmetic."""
    per_k = beam_cuda.traceback_smem_bytes(1, warps, 1) - beam_cuda.traceback_smem_bytes(
        1, warps, 0)
    return (beam_cuda.TRACEBACK_SMEM_LIMIT - beam_cuda.traceback_smem_bytes(1, warps, 0)) // per_k


@pytest.mark.parametrize("warps", [1, beam_cuda.TRACEBACK_WARPS])
def test_route_just_fits_and_just_misses(shim, warps):
    k = _k_fit(warps)
    assert beam_cuda.traceback_route(3, k, warps=warps) == ("sweep", 1)
    assert beam_cuda.traceback_route(3, k + 1, warps=warps) == ("walk", 0)
    assert beam_cuda.traceback_smem_bytes(k, warps, 1) <= beam_cuda.TRACEBACK_SMEM_LIMIT
    assert beam_cuda.traceback_smem_bytes(k + 1, warps, 1) > beam_cuda.TRACEBACK_SMEM_LIMIT
    # the sweep at the K that just fits; the walk one past it
    fin, log = random_log(3, k, 1, 33, warps)
    assert _routes(fin, log, 1, warps=warps, steps=1, routes=("sweep",)) == []
    fin, log = random_log(3, k + 1, 1, 33, warps)
    assert _routes(fin, log, 1, warps=warps, routes=("walk",)) == []
    # past the bound the C launch function refuses the sweep, and the wrapper
    # refuses to force it
    with pytest.raises(RuntimeError, match="launch failed"):
        beam_cuda._traceback_launch(fin, log, B=33, T=3, K=k + 1, A=1, route="sweep",
                                    warps=warps, steps=1)
    with pytest.raises(ValueError, match="does not fit"):
        beam_cuda.traceback_kernel(fin, log, T=3, K=k + 1, A=1, route="sweep", warps=warps)


def test_steps_just_fit_at_the_widest_block(shim):
    # the most steps a tile that fit 8 warps at K = 32 (the duplex slot log)
    warps, K = beam_cuda.MAX_TRACEBACK_WARPS, 32
    route, steps = beam_cuda.traceback_route(500, K, warps=warps, steps=32)
    assert route == "sweep" and 1 <= steps < 32
    assert beam_cuda.traceback_smem_bytes(K, warps, steps) <= beam_cuda.TRACEBACK_SMEM_LIMIT
    assert beam_cuda.traceback_smem_bytes(K, warps, steps + 1) > beam_cuda.TRACEBACK_SMEM_LIMIT
    fin, log = random_log(40, K, 1, 2, 5)
    with pytest.raises(RuntimeError, match="launch failed"):
        beam_cuda._traceback_launch(fin, log, B=2, T=40, K=K, A=1, route="sweep", warps=warps,
                                    steps=steps + 1)


def test_constants_and_smem_arithmetic_equal_the_source(shim):
    src = open(os.path.join(CSRC, SOURCE)).read()
    const = lambda name: eval(re.search(rf"{name} = ([\d* +]+);", src).group(1))
    assert const("kChunk") == beam_cuda.TRACEBACK_CHUNK
    assert const("kRing") == beam_cuda.TRACEBACK_RING
    assert const("kSmemLimit") == beam_cuda.TRACEBACK_SMEM_LIMIT
    assert const("kMaxWarps") == beam_cuda.MAX_TRACEBACK_WARPS
    for K, warps, steps in ((5, 4, 16), (32, 8, 0), (583, 1, 1), (1, 1, 32)):
        assert shim.ctc_traceback_smem_bytes(K, warps, steps) == beam_cuda.traceback_smem_bytes(
            K, warps, steps)


def test_multiply_shift_division_is_exact(shim):
    # every divisor a node id meets (K*A and A, 1 <= d < 2**31) on every
    # numerator near 0, near multiples of d and near 2**31 - 1
    rng = np.random.RandomState(0)
    divisors = set(range(1, 600)) | {2**p + e for p in range(1, 31) for e in (-1, 0, 1)}
    divisors |= set(int(x) for x in rng.randint(1, 2**31 - 1, size=200)) | {2**31 - 1}
    for d in sorted(divisors):
        starts = {0, 2**31 - 5000, max(0, (2**31 - 1) // d * d - 2000), d * 37 % 2**31}
        for n0 in starts:
            assert shim.shim_division_mismatches(d, n0, 5000) == 0, (d, n0)


def test_wrapper_takes_the_plain_version_on_the_cpu_for_either_route():
    # no library is loaded for a CPU tensor, whatever route, block or tile
    fin, log = random_log(30, 5, 4, 9, 1)
    want = beam_cuda.traceback_plain(fin, log, T=30, K=5, A=4)
    before = dict(beam_cuda.launches)
    for route in (None, *beam_cuda.TRACEBACK_ROUTES):
        got = beam_cuda.traceback_kernel(fin, log, T=30, K=5, A=4, route=route, warps=2, steps=5)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert beam_cuda.launches == before
    for bad in (dict(route="scan"), dict(warps=0), dict(warps=9), dict(steps=0),
                dict(steps=33), dict(warps=True)):
        with pytest.raises(ValueError):
            beam_cuda.traceback_kernel(fin, log, T=30, K=5, A=4, **bad)
