"""Every entry point of the port runs on the CUDA card unless asked for the CPU.

``device=None`` (the default) means ``torch.device("cuda")``; without a CUDA
device it raises RuntimeError and never runs on the CPU quietly.  Here
``torch.cuda.is_available`` is patched to False (and to True for the
resolution test, which builds objects but launches nothing).
"""

import numpy as np
import pytest
import torch

import fast_ctc_decode_tpu_torch as port
from fast_ctc_decode_tpu_torch import api, serve
from fast_ctc_decode_tpu_torch.device import resolve_device
from fast_ctc_decode_tpu_torch.parallel import mesh, pipeline

R = np.random.RandomState(0).rand(12, 5).astype(np.float32)
C = np.random.RandomState(1).rand(12, 4, 5).astype(np.float32)
S = np.full((4,), 0.25, np.float32)
REQ = '{"posteriors": [0.5, 0.5], "shape": [1, 2], "alphabet": "NA"}'

ENTRY_POINTS = {
    "viterbi_search": lambda: api.viterbi_search(R, "NACGT"),
    "beam_search": lambda: api.beam_search(R, "NACGT"),
    "crf_greedy_search": lambda: api.crf_greedy_search(C, S, "NACGT"),
    "crf_beam_search": lambda: api.crf_beam_search(C, S, "NACGT"),
    "beam_search_duplex": lambda: api.beam_search_duplex(R, R, "NACGT"),
    "crf_beam_search_duplex": lambda: api.crf_beam_search_duplex(C, S, C, S, "NACGT"),
    "BatchBeamDecoder": lambda: port.BatchBeamDecoder("NACGT", T=12),
    "BatchViterbiDecoder": lambda: port.BatchViterbiDecoder("NACGT", T=12),
    "BatchCrfBeamDecoder": lambda: port.BatchCrfBeamDecoder("NACGT", T=12, n_state=4),
    "BatchDuplexDecoder": lambda: port.BatchDuplexDecoder("NACGT", T1=12, T2=12),
    "BatchCrfDuplexDecoder": lambda: port.BatchCrfDuplexDecoder("NACGT", T1=12, T2=12, n_state=4),
    "decode_many": lambda: port.decode_many([R], "NACGT"),
    "decode_many_crf": lambda: port.decode_many_crf([(C, S)], "NACGT"),
    "decode_many_duplex": lambda: port.decode_many_duplex([(R, R)], "NACGT"),
    "decode_and_count": lambda: pipeline.decode_and_count(
        R[None], np.array([12], np.int32), beam_size=5, threshold=0.0, collapse=True),
    "serve.decode_request": lambda: serve.decode_request(
        {"posteriors": R.ravel().tolist(), "shape": [12, 5], "alphabet": "NACGT"}),
    "serve.handle_json": lambda: serve.handle_json(REQ),
    "serve.decode_json": lambda: serve.decode_json(REQ),
    "serve.MicroBatcher": lambda: serve.MicroBatcher(),
    "serve.enable_microbatching": lambda: serve.enable_microbatching(),
    "serve.serve_http": lambda: serve.serve_http("127.0.0.1", 0),
    "serve.main": lambda: serve.main(["--http", "127.0.0.1:0"]),
    "mesh.distributed_init": lambda: mesh.distributed_init("tcp://127.0.0.1:1", 1, 0),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_without_cuda_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            ENTRY_POINTS[name]()
    finally:
        serve.disable_microbatching()
    assert serve._MICRO is None


def test_default_resolves_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    dec = port.BatchBeamDecoder("NACGT", T=12)
    assert dec.device == torch.device("cuda") and dec.engine == "cuda"
    assert port.BatchCrfBeamDecoder("NACGT", T=12, n_state=4).engine == "cuda"
    for cls, kw in ((port.BatchViterbiDecoder, dict(T=12)),
                    (port.BatchDuplexDecoder, dict(T1=12, T2=12)),
                    (port.BatchCrfDuplexDecoder, dict(T1=12, T2=12, n_state=4))):
        assert cls("NACGT", **kw).device == torch.device("cuda")
    assert mesh.local_device() == torch.device("cuda", 0)


def test_cpu_on_request_runs():
    assert api.beam_search(R, "NACGT", device="cpu")[0]
    assert port.BatchBeamDecoder("NACGT", T=12, device="cpu").decode(
        R[None], np.array([12], np.int32))[0][2] == 0
