"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

The sources have a plain C interface (no PyTorch headers).  Each ``.cu`` is
compiled to an object by its own nvcc process, all started together, and one
more nvcc call links the objects.  The shared library lands in ``_build/<digest>/``
inside this package (listed in ``.gitignore``), keyed by a hash of the
sources and flags: the first use after a change rebuilds, later uses load
the cached library.  A failed build raises; nothing falls back.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` so nvcc never contracts an
``a * b + c`` into one rounding (the plain engine rounds twice), and never
``--use_fast_math`` (the renormalising divide must be IEEE division and the
NaN compares must stay ordered).  ``-Xptxas -v`` records registers, shared
memory and spills of every kernel in ``nvcc.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libctc_kernels.so"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_TIMEOUT_S = 900

_LOCK = threading.Lock()
_LIB = None


@dataclass
class BuildResult:
    path: str  # the shared library
    seconds: float  # nvcc wall time; 0.0 when the cached library was used
    log: str  # nvcc's output, ptxas register/spill lines included


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs, headers


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` into one shared library, unless already built."""
    srcs, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + headers:
        digest.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            digest.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, digest.hexdigest()[:16])
    out = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "nvcc.log")
    if os.path.exists(out):
        with open(log_path) as f:
            return BuildResult(out, 0.0, f.read())
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, jobs = [], []
    try:
        for src in srcs:  # one compiler per source, all running at once
            obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, src]
            objs.append(obj)
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs = []
        for cmd, job in jobs:
            text, _ = job.communicate(timeout=_TIMEOUT_S)
            logs.append(text)
            if job.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({job.returncode}): {' '.join(cmd)}\n{text}"
                )
        tmp = f"{out}.{tag}"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
        link = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=_TIMEOUT_S,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}): {' '.join(cmd)}\n{link.stdout}"
            )
    finally:
        for _, job in jobs:
            if job.poll() is None:
                job.kill()
                job.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    log = "".join(logs) + link.stdout
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


def load_library():
    """The kernels' ctypes library, built on first use (raises on failure)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        _LIB = bind(ctypes.CDLL(build().path))
        return _LIB


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: argtypes of every C function of the library (all return an int: the launch
#: functions a cudaError_t)
SIGNATURES = {
    "ctc_beam_ids_launch": [_P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "ctc_beam_ids_v1_launch": [_P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "ctc_beam_ids_v3_launch": [_P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "ctc_beam_ablate_launch": [_P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "ctc_traceback_launch": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P],
    "ctc_beam_warp_launch": [
        _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P,
    ],
    "ctc_beam_warp_blocks_per_sm": [_I, _I, _I, _I],
    "ctc_exact_beam_launch": [
        _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P, ctypes.c_longlong, _P, _P, _P, _P, _I, _P,
    ],
    "ctc_exact_beam_blocks_per_sm": [_I, _I, _I, _I],
    "ctc_duplex_slot_launch": [
        _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P, ctypes.c_longlong, _P, _P, _P, _P,
    ],
    "ctc_viterbi_run_means_launch": [_P, _P, _P, _P, _I, _I, _P, _P],
    "ctc_duplex_math_check_launch": [_P, _P],
    "ctc_duplex_block_threads": [],
    "ctc_duplex_slot_blocks_per_sm": [_I, _I],
    "ctc_duplex_exact_blocks_per_sm": [_I, _I, _I],
    "ctc_duplex_exact_launch": [
        _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P, ctypes.c_longlong, _P, _P, _P, _P,
    ],
}


def bind(lib):
    """Declare the C signatures of the launch functions on the ctypes
    library ``lib``."""
    for name in SIGNATURES:
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = SIGNATURES[name]
    lib.ctc_cuda_error_string.restype = ctypes.c_char_p
    lib.ctc_cuda_error_string.argtypes = [_I]
    return lib
