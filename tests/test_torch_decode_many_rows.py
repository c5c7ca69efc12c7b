"""``decode_many`` hands the decoder one row a read of each batch.

A bucket's last batch holds only its own reads: the decoder receives
``[len(chunk), edge, A+1]`` posteriors and ``[len(chunk)]`` lengths, never
rows of length 0 up to ``batch_size``.  The rows it returns equal, bit for
bit, those of the same chunks decoded in a ``[batch_size, edge, A+1]``
zero-padded buffer: the JAX package's ``decode_many``, which still pads
each partial batch to ``batch_size``.  A checkpoint cut after a partial
batch resumes to the same rows.  The ``card`` case compares engine ``cuda``
with the port's CPU ``fast`` engine, since a card's machine has no JAX; its
skip lives in this file, so it runs there without the JAX package's
conftest:

    python -m pytest tests/test_torch_decode_many_rows.py -q                          # here
    python -m pytest --noconftest tests/test_torch_decode_many_rows.py -q -m card     # on a card
"""

import json

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu_torch import errors
from fast_ctc_decode_tpu_torch.parallel import pipeline
from fast_ctc_decode_tpu_torch.utils.padding import edge_holding

torch.set_num_threads(1)

ALPHA = "NACGT"
KW = dict(beam_size=5, beam_cut_threshold=0.1)

#: with ``batch_size`` 4 the auto edges [128, 256, 300] hold a full batch and
#: a chunk of 1, a bucket exactly full, and a read alone in its bucket;
#: [64, 160, 320] a bucket exactly full and two partial batches of 3; T=300 two
#: full batches and one of 2; ``batch_size`` 16 is more than the read count
LENGTHS = [30, 140, 5, 131, 16, 300, 9, 250, 90, 200]

#: how decode_many is told its buckets -> the edges it decodes them at, and
#: the rows of each batch in decode order for each ``batch_size``
BUCKETS = {
    "T": (dict(T=300), [300], {4: [4, 4, 2], 16: [10]}),
    "bucket_edges": (dict(bucket_edges=[320, 64, 160]), [64, 160, 320],
                     {4: [4, 3, 3], 16: [4, 3, 3]}),
    "auto": ({}, [128, 256, 300], {4: [4, 1, 4, 1], 16: [5, 4, 1]}),
}


def rand_read(T, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(T, 5).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=-1, keepdims=True)


def reads_of(lengths=LENGTHS):
    return [rand_read(n, 40 + i) for i, n in enumerate(lengths)]


def chunks_of(reads, edges, bs):
    """``(edge, chunk)`` of each batch in decode order: buckets by edge, reads
    in input order within one, ``bs`` at a time."""
    buckets = {}
    for i, r in enumerate(reads):
        buckets.setdefault(edge_holding(r.shape[0], edges), []).append(i)
    return [(e, idxs[s: s + bs]) for e, idxs in sorted(buckets.items())
            for s in range(0, len(idxs), bs)]


@pytest.fixture
def card():
    """The CUDA card, decided inside the test (every worker collects the same
    tests); skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the test runs only on one")
    return torch.device("cuda", 0)


@pytest.fixture
def seen(monkeypatch):
    """The shapes of every batch ``BatchBeamDecoder.decode`` receives:
    ``(T, probs shape, lengths shape)``."""
    calls = []
    real = pipeline.BatchBeamDecoder.decode

    def spy(self, probs, lengths):
        calls.append((self.T, tuple(probs.shape), tuple(lengths.shape)))
        return real(self, probs, lengths)

    monkeypatch.setattr(pipeline.BatchBeamDecoder, "decode", spy)
    return calls


def own_rows(reads, edges, bs):
    return [(e, (len(c), e, 5), (len(c),)) for e, c in chunks_of(reads, edges, bs)]


@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("buckets", list(BUCKETS))
@pytest.mark.parametrize("engine", ["fast", "exact"])
def test_batches_hold_their_own_rows_and_decode_as_zero_padded(seen, engine, buckets, bs):
    # JAX pads each partial batch to ``bs`` rows of length 0; each port
    # engine is held to JAX's engine of the same name
    from fast_ctc_decode_tpu.parallel import pipeline as jax_pipeline

    reads = reads_of()
    given, edges, sizes = BUCKETS[buckets]
    assert [len(c) for _, c in chunks_of(reads, edges, bs)] == sizes[bs]
    got = pipeline.decode_many(reads, ALPHA, batch_size=bs, engine=engine, device="cpu",
                               **given, **KW)
    assert seen == own_rows(reads, edges, bs)
    assert got == jax_pipeline.decode_many(reads, ALPHA, engine=engine, batch_size=bs,
                                           **given, **KW)
    assert all(r[2] == errors.OK for r in got)


class Preempted(RuntimeError):
    pass


@pytest.mark.parametrize("engine", ["fast", "exact"])
def test_a_cut_after_a_partial_batch_resumes_to_the_same_rows(tmp_path, monkeypatch, engine):
    reads = reads_of()
    given, edges, _ = BUCKETS["bucket_edges"]
    kw = dict(batch_size=4, engine=engine, device="cpu", **given, **KW)
    full = pipeline.decode_many(reads, ALPHA, **kw)
    batches = chunks_of(reads, edges, 4)
    assert [len(c) for _, c in batches] == [4, 3, 3]

    shapes, cut = [], [3]
    real = pipeline.BatchBeamDecoder.decode

    def cut_at_the_third(self, probs, lengths):
        shapes.append(tuple(probs.shape))
        if len(shapes) == cut[0]:
            raise Preempted("preempted before batch 3")
        return real(self, probs, lengths)

    monkeypatch.setattr(pipeline.BatchBeamDecoder, "decode", cut_at_the_third)
    ckpt = str(tmp_path / "run.jsonl")
    with pytest.raises(Preempted):
        pipeline.decode_many(reads, ALPHA, checkpoint_path=ckpt, **kw)
    with open(ckpt) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    assert [x["i"] for x in lines[1:]] == [batches[0][1], batches[1][1]]

    shapes.clear()
    cut[0] = None
    resumed = pipeline.decode_many(reads, ALPHA, checkpoint_path=ckpt, **kw)
    assert shapes == [(3, 320, 5)]  # only the last batch, at its own 3 rows
    assert resumed == full
    with open(ckpt) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    assert lines[0]["meta"]["bucket_edges"] == edges
    assert [x["i"] for x in lines[1:]] == [c for _, c in batches]
    assert [len(x["r"]) for x in lines[1:]] == [4, 3, 3]


@pytest.mark.card
def test_the_cuda_engine_decodes_own_rows_as_the_cpu(seen, card):
    reads = reads_of()
    given, edges, _ = BUCKETS["auto"]
    kw = dict(batch_size=4, **given, **KW)
    got = pipeline.decode_many(reads, ALPHA, engine="cuda", device=card, **kw)
    assert seen == own_rows(reads, edges, 4)
    assert got == pipeline.decode_many(reads, ALPHA, engine="fast", device="cpu", **kw)
