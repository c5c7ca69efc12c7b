"""The PyTorch port's pipeline and host layer against the JAX package.

``BatchBeamDecoder.decode`` and ``decode_many`` must give the JAX package's
results on the same reads (made with numpy from a seed); a ``decode_many``
checkpoint written by the JAX package must resume in the port; and the port
must import neither jax nor the JAX package.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu import errors as jax_errors
from fast_ctc_decode_tpu.parallel import pipeline as jax_pipeline
from fast_ctc_decode_tpu.utils import padding as jax_padding
import fast_ctc_decode_tpu_torch as port
from fast_ctc_decode_tpu_torch import errors as port_errors
from fast_ctc_decode_tpu_torch.alphabet import normalize_alphabet
from fast_ctc_decode_tpu_torch.parallel import pipeline as port_pipeline
from fast_ctc_decode_tpu_torch.utils import padding as port_padding
from fast_ctc_decode_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rand_read(T, A1, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=-1, keepdims=True)


def ragged_batch(B=16, T=48, seed=0):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    probs = np.zeros((B, T, 5), np.float32)
    for i, n in enumerate(lengths):
        probs[i, :n] = rand_read(n, 5, 100 + i)
    return probs, lengths


def test_batch_decoder_equals_jax():
    probs, lengths = ragged_batch()
    probs[3, 2, 1] = np.nan  # one read errors, the batch goes on
    kw = dict(T=48, beam_size=5, beam_cut_threshold=0.1)
    want = jax_pipeline.BatchBeamDecoder("NACGT", engine="fast", **kw).decode(probs, lengths)
    dec = port.BatchBeamDecoder("NACGT", engine="fast", device="cpu", **kw)
    got = dec.decode(probs, lengths)
    assert got == want
    assert got[3][2] == port_errors.INCOMPARABLE_VALUES
    assert {"beam.device", "beam.detok"} <= set(profiling.METRICS.stages)


def test_decode_many_auto_buckets_equal_jax():
    reads = [rand_read(int(n), 5, i) for i, n in enumerate([140, 30, 260, 90, 300, 5, 131])]
    kw = dict(beam_size=5, beam_cut_threshold=0.1, batch_size=8)
    want = jax_pipeline.decode_many(reads, "NACGT", engine="fast", **kw)
    got = port.decode_many(reads, "NACGT", device="cpu", **kw)
    assert got == want
    assert port_pipeline._auto_bucket_edges([r.shape[0] for r in reads]) == [128, 256, 300]
    assert port_pipeline._bucket_edge_for(300) == jax_pipeline._bucket_edge_for(300)


def test_checkpoint_from_jax_resumes_in_port(tmp_path):
    reads = [rand_read(t, 5, i) for i, t in enumerate([30, 17, 30, 9, 25, 30, 12, 3])]
    ckpt = str(tmp_path / "run.jsonl")
    kw = dict(beam_size=5, beam_cut_threshold=0.1, batch_size=8, T=30)
    full = jax_pipeline.decode_many(reads, "NACGT", engine="fast", **kw)
    # preempted JAX run: half of the reads land in the checkpoint
    jax_pipeline.decode_many(reads[:4], "NACGT", engine="fast", checkpoint_path=ckpt, **kw)
    with open(ckpt) as f:
        lines_before = len(f.read().splitlines())
    resumed = port.decode_many(
        reads, "NACGT", engine="fast", device="cpu", checkpoint_path=ckpt, **kw
    )
    assert resumed == full
    with open(ckpt) as f:
        lines = f.read().splitlines()
    assert len(lines) == lines_before + 1  # the port decoded only the rest
    assert json.loads(lines[-1])["i"] == [4, 5, 6, 7]


def _set_engine(path, engine):
    """Rewrite a checkpoint's header engine, as the JAX package writes it
    for another engine of the same results."""
    with open(path) as f:
        lines = f.read().splitlines()
    head = json.loads(lines[0])
    head["meta"]["engine"] = engine
    with open(path, "w") as f:
        f.write("\n".join([json.dumps(head)] + lines[1:]) + "\n")


@pytest.mark.parametrize("engine", ["pallas", "fast"])
def test_jax_checkpoint_of_a_hash_engine_resumes_with_the_default(tmp_path, engine):
    # JAX's default decode_many writes "fast", its kernel "pallas" (bit-identical
    # results); the port resumes either with its own default engine
    reads = [rand_read(t, 5, 20 + i) for i, t in enumerate([30, 11, 30, 24, 8, 30])]
    ckpt = str(tmp_path / "run.jsonl")
    kw = dict(beam_size=5, beam_cut_threshold=0.1, batch_size=4, T=30)
    full = jax_pipeline.decode_many(reads, "NACGT", **kw)
    jax_pipeline.decode_many(reads[:3], "NACGT", checkpoint_path=ckpt, **kw)
    _set_engine(ckpt, engine)
    assert port.decode_many(reads, "NACGT", device="cpu", checkpoint_path=ckpt, **kw) == full
    with open(ckpt) as f:
        lines = f.read().splitlines()
    assert json.loads(lines[0])["meta"]["engine"] == engine
    assert json.loads(lines[-1])["i"] == [3, 4, 5]  # only the rest was decoded


@pytest.mark.parametrize("written, resume", [("exact", None), ("fast", "exact"),
                                             ("pallas", "exact")])
def test_checkpoint_across_the_exact_hash_divide_raises(tmp_path, written, resume):
    reads = [rand_read(20, 5, 30 + i) for i in range(3)]
    ckpt = str(tmp_path / "run.jsonl")
    port.decode_many(reads[:1], "NACGT", T=20, engine="fast", device="cpu", checkpoint_path=ckpt)
    _set_engine(ckpt, written)
    with pytest.raises(ValueError, match="different decode"):
        port.decode_many(reads, "NACGT", T=20, engine=resume, device="cpu", checkpoint_path=ckpt)


def test_checkpoint_engine_classes():
    from fast_ctc_decode_tpu_torch.utils.checkpoint import same_run

    meta = {"beam_size": 5, "engine": "cuda"}
    for name in ("pallas", "cuda", "fast", None):
        assert same_run({"beam_size": 5, "engine": name}, meta, "beam")
    assert same_run({"beam_size": 5}, meta, "beam")  # a missing engine is auto
    assert not same_run({"beam_size": 5, "engine": "exact"}, meta, "beam")
    assert not same_run({"beam_size": 4, "engine": "cuda"}, meta, "beam")  # other keys exact
    dup = {"duplex": True, "engine": "exact"}
    assert same_run({"duplex": True, "engine": "exact-pallas"}, dup, "duplex")
    assert same_run({"duplex": True, "engine": "exact-pallas"}, dup, "duplex_moving")
    assert not same_run({"duplex": True, "engine": None}, dup, "duplex")
    assert not same_run({"duplex": True, "engine": "fast"}, dup, "duplex")
    slot = {"duplex": True, "engine": "cuda"}
    assert same_run({"duplex": True, "engine": "pallas"}, slot, "duplex")
    assert same_run({"duplex": True, "engine": "fast"}, slot, "duplex")
    assert not same_run({"duplex": True, "engine": "fast"}, slot, "duplex_moving")
    assert not same_run({"duplex": True, "engine": None}, slot, "duplex")


def test_checkpoint_meta_mismatch_raises(tmp_path):
    reads = [rand_read(20, 5, i) for i in range(3)]
    ckpt = str(tmp_path / "run.jsonl")
    port.decode_many(reads[:1], "NACGT", T=20, device="cpu", checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="different decode"):
        port.decode_many(reads, "NACGT", T=20, beam_size=3, device="cpu",
                         checkpoint_path=ckpt)


def test_decode_and_count_is_a_local_sum():
    probs, lengths = ragged_batch(B=8, T=24, seed=2)
    probs[1, 0, :] = np.nan
    out, totals = port_pipeline.decode_and_count(
        probs, lengths, beam_size=5, threshold=0.1, collapse=True, device="cpu"
    )
    assert totals.tolist() == [7, 1]
    assert int(out["err"][1]) == port_errors.INCOMPARABLE_VALUES


@pytest.mark.parametrize(
    "engine, device",
    [("cuda", "cpu"), ("pallas", "cuda"), ("pallas", "cpu")],
)
def test_engine_choice_raises(engine, device):
    with pytest.raises(ValueError):
        port.BatchBeamDecoder("NACGT", T=10, engine=engine, device=device)


def test_engine_default_follows_device():
    assert port.BatchBeamDecoder("NACGT", T=10, device="cpu").engine == "fast"
    assert port.BatchBeamDecoder("NACGT", T=10, device="cpu").device.type == "cpu"
    assert port.BatchBeamDecoder("NACGT", T=10, device="cuda").engine == "cuda"


def test_errors_and_host_layer_match_jax():
    assert port_errors._MESSAGES == jax_errors._MESSAGES
    for code in range(6):
        assert port_errors.status_message(code) == jax_errors.status_message(code)
    assert isinstance(port.SearchError(1), RuntimeError)
    assert normalize_alphabet(["A", 1, "GT"]) == ["A", "1", "GT"]
    reads = [rand_read(t, 5, t) for t in (7, 130, 3, 300)]
    for a, b in zip(port_padding.pad_batch(reads, pad_to_multiple=8),
                    jax_padding.pad_batch(reads, pad_to_multiple=8)):
        assert np.array_equal(a, b)
    edges = [128, 256, 512]
    assert port_padding.bucket_reads(reads, edges) == jax_padding.bucket_reads(reads, edges)


def test_profiling_block_and_trace(tmp_path):
    x = {"a": torch.zeros(3), "b": [torch.ones(2)]}
    assert profiling.block(x) is x  # CPU tensors: nothing to wait for
    with profiling.trace(str(tmp_path)):
        torch.ones(4).sum()
        port.decode_many([rand_read(30, 5, 1)], "NACGT", batch_size=2, device="cpu")
    assert os.path.exists(tmp_path / "trace.json")
    with open(tmp_path / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"decode_many", "beam.device", "beam.upload"} <= names


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np\n"
        "import fast_ctc_decode_tpu_torch as m\n"
        "from fast_ctc_decode_tpu_torch import api\n"
        "from fast_ctc_decode_tpu_torch.ops import beam, crf, viterbi, beam_exact_cuda\n"
        "from fast_ctc_decode_tpu_torch.ops import duplex, duplex_fast, duplex_cuda, duplex_exact_cuda\n"
        "from fast_ctc_decode_tpu_torch.ops import viterbi_cuda\n"
        "from fast_ctc_decode_tpu_torch.tools import exact_probe\n"
        "from fast_ctc_decode_tpu_torch.parallel import pipeline\n"
        "c = np.random.RandomState(1).rand(12, 4, 5).astype(np.float32)\n"
        "s = np.full((4,), 0.25, np.float32)\n"
        "assert api.beam_search(c[:, 0], 'NACGT', 5, 0.1, device='cpu')[0]\n"
        "assert api.crf_beam_search(c, s, 'NACGT', 5, 0.01, device='cpu')[0]\n"
        "assert api.viterbi_search(c[:, 0], 'NACGT', device='cpu')[0]"
        " and api.crf_greedy_search(c, s, 'NACGT', device='cpu')\n"
        "x = np.random.RandomState(0).rand(2, 20, 5).astype(np.float32)\n"
        "r = m.BatchBeamDecoder('NACGT', T=20, beam_cut_threshold=0.1, device='cpu').decode(x, np.array([20, 9]))\n"
        "assert len(r) == 2 and r[0][2] == 0\n"
        "e = np.stack([np.zeros(12, np.int64), np.minimum(np.arange(12) + 3, 12)], 1)\n"
        "assert api.beam_search_duplex(c[:, 0], c[:, 1], 'NACGT', envelope=e, device='cpu')\n"
        "assert api.crf_beam_search_duplex(c, s, c, s, 'NACGT', beam_cut_threshold=0.01,"
        " device='cpu')\n"
        "d = m.BatchDuplexDecoder('NACGT', T1=12, T2=12, device='cpu').decode(c[None, :, 0], c[None, :, 1])\n"
        "assert d[0][1] == 0 and m.decode_many_duplex([(c[:, 0], c[:, 1], e)], 'NACGT',"
        " device='cpu')[0][1] == 0\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'fast_ctc_decode_tpu' or k.startswith('fast_ctc_decode_tpu.')]\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
