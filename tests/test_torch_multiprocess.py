"""Two processes decode one batch over torch.distributed (Gloo, CPU).

The port's counterpart of tests/test_multihost.py: each worker joins the
process group with ``parallel.mesh.distributed_init`` (``device="cpu"``,
hence Gloo), decodes its contiguous shard (``shard_bounds``) with
``pipeline.decode_and_count``, and the ``all_reduce`` inside must give both
workers the global counters ``[16, 0]``.  The workers import torch and the
port only, never jax; the union of their shards must equal the JAX
package's ``beam_fast`` on the whole batch, bit for bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np

from fast_ctc_decode_tpu.ops import beam_fast as jax_beam_fast

_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import numpy as np
import torch
torch.set_num_threads(1)
from fast_ctc_decode_tpu_torch.parallel import mesh
from fast_ctc_decode_tpu_torch.parallel.pipeline import decode_and_count

mesh.distributed_init(f"tcp://127.0.0.1:{{port}}", world, rank, device="cpu")
assert torch.distributed.get_backend() == "gloo"
assert torch.distributed.get_world_size() == world

B, T, A1 = 16, 24, 5
rng = np.random.RandomState(0)
probs = rng.rand(B, T, A1).astype(np.float32)
probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
lengths = np.full((B,), T, np.int32)
lo, hi = mesh.shard_bounds(B, rank, world)

res, totals = decode_and_count(
    probs[lo:hi], lengths[lo:hi], beam_size=5, threshold=0.1, collapse=True, device="cpu"
)
np.savez(out, lo=lo, hi=hi, **{{k: v.numpy() for k, v in res.items()}})
torch.distributed.destroy_process_group()
assert "jax" not in sys.modules and "fast_ctc_decode_tpu" not in sys.modules
print("WORKER_OK", rank, totals.tolist())
"""


def test_two_process_decode_and_all_reduce(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=repo))
    with socket.socket() as s:  # a free rendezvous port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    outs = [tmp_path / f"shard{i}.npz" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port), str(outs[i])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {i} failed:\n{log[-2000:]}"
        assert f"WORKER_OK {i} [16, 0]" in log, log[-2000:]

    B, T, A1 = 16, 24, 5
    rng = np.random.RandomState(0)
    probs = rng.rand(B, T, A1).astype(np.float32)
    probs /= np.linalg.norm(probs, ord=2, axis=-1, keepdims=True)
    want = jax_beam_fast.beam_search_fast_batch(
        probs, np.full((B,), T, np.int32), np.float32(0.1), beam_size=5, collapse_repeats=True)
    shards = [np.load(o) for o in outs]
    assert [(int(s["lo"]), int(s["hi"])) for s in shards] == [(0, 8), (8, 16)]
    for f in ("labels_rev", "times_rev", "count", "err"):
        got = np.concatenate([s[f] for s in shards])
        assert got.dtype == np.int32 and np.array_equal(got, np.asarray(want[f])), f
