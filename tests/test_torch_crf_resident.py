"""``decode_many_crf`` on reads that are torch tensors on the decode device.

A batch whose posteriors are tensors on ``device`` is padded there, in torch
buffers, and decodes bit for bit as the same reads given as numpy arrays
(padded into torch buffers on the host), on every engine of the CPU, with
checkpoints resumed across the two forms.  The port's sequences, statuses and latest-entry
paths meet the benchmark's frozen NumPy reference (``ctcbench/reference/
crf.py``) at a sup-class CRF width (1,024 states), and sequences and
statuses meet the repository's oracle.  A batch of consecutive whole rows
of one tensor is decoded in place, from the caller's memory, which it leaves
unchanged, bit for bit as the padded path decodes the same reads; any other
layout takes the pad.  The stream counts the frames it decodes, the bytes
its pad stage writes and the frames it decodes in place.
"""

import numpy as np
import pytest
import torch

import oracle
from ctcbench.reference.crf import crf_beam_search as ref_crf_beam_search
from fast_ctc_decode_tpu_torch import decode_many_crf, errors
from fast_ctc_decode_tpu_torch.parallel import pipeline
from fast_ctc_decode_tpu_torch.utils import profiling

torch.set_num_threads(1)

ALPHA = "NACGT"


def crf_reads(lengths, S, seed):
    """Seeded reads ``(posteriors [T, S, 5], init [S])``, float32 numpy."""
    rng = np.random.RandomState(seed)
    reads = []
    for T in lengths:
        x = rng.rand(int(T), S, 5).astype(np.float32)
        x /= x.sum(-1, keepdims=True)
        init = rng.rand(S).astype(np.float32)
        reads.append((x, init / init.sum()))
    return reads


def as_tensors(reads):
    return [(torch.from_numpy(p.copy()), torch.from_numpy(i.copy())) for p, i in reads]


LENGTHS = {"ragged": [7, 19, 3, 12, 16], "uniform": [14] * 5}

#: (engine, S, lengths, batch size): every batch size leaves a partial batch
CASES = [(e, S, kind, bs) for e in ("fast", "exact") for S in (4, 64, 1024)
         for kind in LENGTHS for bs in (2, 3)]


@pytest.mark.parametrize("engine, S, kind, bs", CASES)
def test_tensors_on_the_device_decode_as_the_host_arrays(engine, S, kind, bs):
    reads = crf_reads(LENGTHS[kind], S, seed=S + bs)
    kw = dict(beam_size=5, beam_cut_threshold=0.0, batch_size=bs, engine=engine,
              device="cpu")
    want = decode_many_crf(reads, ALPHA, **kw)
    got = decode_many_crf(as_tensors(reads), ALPHA, **kw)
    assert got == want
    assert all(r[2] == errors.OK for r in got)


def test_tensor_batches_reach_the_decoder_as_torch_buffers(monkeypatch):
    seen = []
    real = pipeline.BatchCrfBeamDecoder.decode_arrays

    def spy(self, probs, inits, lengths):
        seen.append((type(probs), type(inits), tuple(probs.shape)))
        return real(self, probs, inits, lengths)

    monkeypatch.setattr(pipeline.BatchCrfBeamDecoder, "decode_arrays", spy)
    reads = crf_reads([9, 9, 9], 16, seed=3)
    decode_many_crf(as_tensors(reads), ALPHA, batch_size=2, device="cpu")
    decode_many_crf(reads, ALPHA, batch_size=2, device="cpu")
    # the last batch of tensors, one whole read, is decoded in place: one row;
    # host arrays are padded into torch buffers on the host
    assert seen == [(torch.Tensor, torch.Tensor, (2, 9, 16, 5)),
                    (torch.Tensor, torch.Tensor, (1, 9, 16, 5))] + [
        (torch.Tensor, torch.Tensor, (2, 9, 16, 5))] * 2


def host_pad(reads, chunk, bs, edge):
    """``decode_many_crf``'s host pad of ``chunk`` (its own lines)."""
    S = reads[0][0].shape[1]
    probs = np.zeros((bs, edge, S, 5), np.float32)
    inits = np.zeros((bs, S), np.float32)
    inits[:, 0] = 1.0
    lengths = np.zeros((bs,), np.int32)
    for j, i in enumerate(chunk):
        probs[j, : reads[i][0].shape[0]] = reads[i][0]
        inits[j] = reads[i][1]
        lengths[j] = reads[i][0].shape[0]
    return probs, inits, lengths


@pytest.mark.parametrize("lengths, chunk, bs, group", [
    ([5, 2], [1, 0], 3, None),              # ragged, a padding row
    ([8, 8, 3, 8, 8, 8], [0, 1, 2, 3, 4, 5], 7, None),  # runs of whole reads around a short one
    ([8, 8, 3, 8, 8, 8], [5, 4, 3, 1, 0, 2], 6, 2),     # runs cut at two reads a copy
    ([8, 8, 8], [0, 1, 2], 3, 1),           # a copy a read
])
def test_the_device_pad_is_the_host_pad(monkeypatch, lengths, chunk, bs, group):
    if group is not None:
        monkeypatch.setattr(pipeline, "_CAT_ELEMENTS", group * 8 * 8 * 5)
    reads = crf_reads(lengths, 8, seed=4)
    want = host_pad(reads, chunk, bs, 8)
    # tensors on the device, and host arrays for the CPU or for a card: the
    # buffers lie where the reads lie, the host's for arrays
    for dev, form in (("cpu", as_tensors), ("cpu", list), ("cuda", list)):
        probs, inits, lens = pipeline._pad_crf(torch.device(dev), form(reads), chunk, bs, 8)
        assert {probs.device.type, inits.device.type, lens.device.type} == {"cpu"}
        assert np.array_equal(probs.numpy(), want[0]) and np.array_equal(inits.numpy(), want[1])
        assert lens.dtype == torch.int32 and np.array_equal(lens.numpy(), want[2])
    # host init states beside posteriors on the device: the same values
    mixed = [(p, i.numpy()) for p, i in as_tensors(reads)]
    assert np.array_equal(pipeline._pad_crf(torch.device("cpu"), mixed, chunk, bs, 8)[1],
                          want[1])


@pytest.mark.parametrize("first, then", [("numpy", "tensor"), ("tensor", "numpy")])
@pytest.mark.parametrize("engine", ["fast", "exact"])
def test_a_checkpoint_of_one_form_resumes_in_the_other(tmp_path, first, then, engine):
    reads = crf_reads([6, 13, 4, 9, 11, 8, 5], 64, seed=8)  # the longest among the first 4
    form = {"numpy": lambda r: r, "tensor": as_tensors}
    kw = dict(beam_size=5, beam_cut_threshold=0.0, batch_size=2, engine=engine, device="cpu")
    full = decode_many_crf(reads, ALPHA, **kw)
    ckpt = str(tmp_path / f"{first}.jsonl")
    assert decode_many_crf(form[first](reads[:4]), ALPHA, checkpoint_path=ckpt, **kw) == full[:4]
    assert decode_many_crf(form[then](reads), ALPHA, checkpoint_path=ckpt, **kw) == full


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_sup_width_reads_meet_the_reference_and_the_oracle(seed):
    rng = np.random.RandomState(seed)
    reads = crf_reads(rng.randint(20, 61, size=3), 1024, seed)
    got = decode_many_crf(as_tensors(reads), ALPHA, beam_size=5, beam_cut_threshold=0.0,
                          device="cpu")
    exact = decode_many_crf(as_tensors(reads), ALPHA, beam_size=5, beam_cut_threshold=0.0,
                            engine="exact", device="cpu")
    for (x, init), (seq, path, status), (xseq, xpath, xstatus) in zip(reads, got, exact):
        want_seq, first, latest = ref_crf_beam_search(x, init, ALPHA, 5, 0.0)
        assert (seq, path, status) == (want_seq, latest, errors.OK)
        # the exact engine reports upstream's first-creation path
        assert (xseq, xpath, xstatus) == (want_seq, first, errors.OK)
        assert oracle.crf_beam_search(x, init, ALPHA, 5, 0.0) == (want_seq, first)


@pytest.mark.parametrize("seed", [2**31 + 31, 2**33 + 7])
def test_the_benchmark_law_meets_the_reference_on_latest_entry_paths(seed):
    """Chunks of ``crf.stream``'s posterior law (a confident true state among
    flat rows), where prefixes leave the beam and come back: the port's
    paths are their latest entries, not upstream's first creations."""
    from ctcbench.drivers.common import generator
    from ctcbench.gen.crf import crf_chunks
    from ctcbench.spec import load_files

    config, _ = load_files("crf_sup_s1024_b5", "crf_chunks")
    probs, init = crf_chunks(3, 80, 1024, config["posteriors"], generator(seed, "cpu"), "cpu")[:2]
    got = decode_many_crf(list(zip(probs, init)), ALPHA, beam_size=5, beam_cut_threshold=0.0,
                          device="cpu")
    differ = 0
    for x, i, (seq, path, status) in zip(probs.numpy(), init.numpy(), got):
        want_seq, first, latest = ref_crf_beam_search(x, i, ALPHA, 5, 0.0)
        assert (seq, path, status) == (want_seq, latest, errors.OK)
        differ += first != latest
    assert differ > 0


def counted_forms(form, reads):
    """``reads`` in ``form``: numpy arrays, separate tensors, or posteriors
    as views of one tensor with the init states as views too, as separate
    tensors or as numpy arrays."""
    if form == "numpy":
        return reads
    if form == "tensor":
        return as_tensors(reads)
    probs = torch.from_numpy(np.stack([p for p, _ in reads])).unbind(0)
    inits = {"views": lambda: torch.from_numpy(np.stack([i for _, i in reads])).unbind(0),
             "views-own-inits": lambda: [torch.from_numpy(i.copy()) for _, i in reads],
             "views-host-inits": lambda: [i for _, i in reads]}[form]()
    return list(zip(probs, inits))


#: form -> (read lengths, counts after decoding them, counts after decoding the
#: first again), S = 16, batches of 2.  A batch whose posteriors are one
#: tensor's consecutive whole rows (a single whole read among them) is decoded
#: in place, and writes only init states that are not one tensor's rows.
S16 = 16
COUNTED = {
    "numpy": ([7, 3, 12], (22, None, 4 * (22 * S16 * 5 + 3 * S16)),
              (29, None, 4 * (29 * S16 * 5 + 4 * S16))),
    "tensor": ([7, 3, 12], (22, 12, 4 * (10 * S16 * 5 + 2 * S16)),
               (29, 19, 4 * (10 * S16 * 5 + 2 * S16))),
    "views": ([11, 11, 11], (33, 33, 0), (44, 44, 0)),
    "views-own-inits": ([11, 11, 11], (33, 33, 4 * 2 * S16), (44, 44, 4 * 2 * S16)),
    "views-host-inits": ([11, 11, 11], (33, 33, 4 * 3 * S16), (44, 44, 4 * 4 * S16)),
}


def counted(frames, in_place, moved):
    out = {"decode_many_crf.frames": frames, "decode_many_crf.moved_bytes": moved}
    if in_place is not None:
        out["decode_many_crf.in_place_frames"] = in_place
    return out


@pytest.mark.parametrize("form", COUNTED)
def test_counters_of_frames_and_moved_bytes(form):
    lengths, first, again = COUNTED[form]
    reads = counted_forms(form, crf_reads(lengths, S16, seed=5))
    counts = profiling.reset_metrics().counts
    decode_many_crf(reads, ALPHA, batch_size=2, device="cpu")
    assert counts == counted(*first)
    decode_many_crf(reads[:1], ALPHA, batch_size=2, device="cpu")
    assert counts == counted(*again)
    assert profiling.reset_metrics().counts == {}


def one_tensor(N, T, S, seed):
    """``N`` reads of ``T`` frames as the rows of one ``[N, T, S, 5]`` tensor,
    with init states as the rows of one ``[N, S]`` tensor."""
    reads = crf_reads([T] * N, S, seed)
    return (torch.from_numpy(np.stack([p for p, _ in reads])),
            torch.from_numpy(np.stack([i for _, i in reads])))


def clones(reads):
    """The same reads as separate tensors: the pad path's input."""
    return [(p.clone(), torch.as_tensor(i).clone()) for p, i in reads]


#: (engine, S, batch size) over 5 reads: a full batch, and a full then a partial
IN_PLACE = [(e, S, bs) for e in ("fast", "exact") for S in (4, 64, 1024) for bs in (5, 3)]


@pytest.mark.parametrize("engine, S, bs", IN_PLACE)
def test_rows_of_one_tensor_decode_in_place_as_the_pad(engine, S, bs):
    base, init = one_tensor(5, 14, S, seed=S + bs)
    kept = base.clone(), init.clone()
    kw = dict(beam_size=5, beam_cut_threshold=0.0, batch_size=bs, engine=engine,
              device="cpu")
    counts = profiling.reset_metrics().counts
    got = decode_many_crf(list(zip(base.unbind(0), init.unbind(0))), ALPHA, **kw)
    assert counts["decode_many_crf.in_place_frames"] == 5 * 14
    assert counts["decode_many_crf.moved_bytes"] == 0
    want = decode_many_crf(clones(zip(base, init)), ALPHA, **kw)
    assert "decode_many_crf.in_place_frames" not in profiling.reset_metrics().counts
    assert got == want and all(r[2] == errors.OK for r in got)
    # the caller's tensors are only read
    assert torch.equal(base, kept[0]) and torch.equal(init, kept[1])


def test_an_in_place_batch_reaches_the_decoder_as_the_callers_memory(monkeypatch):
    seen = []
    real = pipeline.BatchCrfBeamDecoder.decode_arrays

    def spy(self, probs, inits, lengths):
        seen.append((probs.data_ptr(), inits.data_ptr(), tuple(probs.shape),
                     lengths.tolist()))
        return real(self, probs, inits, lengths)

    monkeypatch.setattr(pipeline.BatchCrfBeamDecoder, "decode_arrays", spy)
    base, init = one_tensor(5, 9, 16, seed=3)
    decode_many_crf(list(zip(base.unbind(0), init.unbind(0))), ALPHA, batch_size=3,
                    device="cpu")
    # a partial batch has no padding rows
    assert seen == [(base[0].data_ptr(), init[0].data_ptr(), (3, 9, 16, 5), [9] * 3),
                    (base[3].data_ptr(), init[3].data_ptr(), (2, 9, 16, 5), [9] * 2)]


def ragged_rows(T, S):
    """Reads of ``T[j]`` frames laid end to end in one storage."""
    flat = torch.from_numpy(np.concatenate([p.reshape(-1) for p, _ in crf_reads(T, S, 9)]))
    ends = np.cumsum([0] + [t * S * 5 for t in T])
    return [flat[a:b].view(-1, S, 5) for a, b in zip(ends[:-1], ends[1:])]


FALLBACKS = {
    "reversed rows": lambda b, b2: b.unbind(0)[::-1],
    "skipped rows": lambda b, b2: b.unbind(0)[::2],
    "two tensors": lambda b, b2: b.unbind(0)[:2] + b2.unbind(0)[2:],
    "non-contiguous": lambda b, b2: b.transpose(1, 2).contiguous().transpose(1, 2).unbind(0),
    "shorter than its bucket": lambda b, b2: b.unbind(0)[:-1] + (b[-1, :-3],),
    "ragged": lambda b, b2: ragged_rows([8, 10, 10, 7, 10, 10], 8),
}


@pytest.mark.parametrize("case", FALLBACKS)
@pytest.mark.parametrize("engine", ["fast", "exact"])
def test_any_other_layout_takes_the_pad(case, engine):
    base, init = one_tensor(6, 10, 8, seed=11)
    probs = FALLBACKS[case](base, base.clone())
    reads = list(zip(probs, init.unbind(0)))
    edge = max(int(p.shape[0]) for p in probs)
    assert pipeline._crf_in_place(torch.device("cpu"), reads, list(range(len(reads))),
                                  edge) is None
    kw = dict(beam_size=5, beam_cut_threshold=0.0, batch_size=6, engine=engine,
              device="cpu")
    counts = profiling.reset_metrics().counts
    got = decode_many_crf(reads, ALPHA, **kw)
    assert "decode_many_crf.in_place_frames" not in counts
    assert got == decode_many_crf(clones(reads), ALPHA, **kw)
