"""The port's JSON decode service (``fast_ctc_decode_tpu_torch/serve.py``)
against the JAX package's, on the CPU.

The counterparts of the service tests of tests/test_serve_and_checkpoint.py
(TestServe, TestWasmGoldens, TestServeDecoderCache, TestMicroBatch,
TestHttpEndToEnd), with ``device="cpu"``.  Where the JAX service answers the
same request string (no micro-batching), the port's response JSON must equal
its bytes exactly; micro-batched beam requests run the batch engine, so
there the sequences must equal the single-read API (as in the JAX tests).
Every micro-batching test disables it in a ``finally`` block, every thread
join and HTTP request has a finite timeout, and the HTTP server binds port 0.
"""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu import serve as jax_serve
from fast_ctc_decode_tpu_torch import api, serve
from fast_ctc_decode_tpu_torch.parallel.pipeline import _bucket_edge_for

torch.set_num_threads(1)

CPU = "cpu"
TIMEOUT = 120


def rand_read(T, A1, seed):
    x = np.random.RandomState(seed).rand(T, A1).astype(np.float32)
    return x / np.linalg.norm(x, ord=2, axis=1, keepdims=True)


def req(x, method="beam_search", **kw):
    r = {
        "method": method,
        "posteriors": x.reshape(-1).tolist(),
        "shape": list(x.shape),
        "alphabet": ["N", "A", "C", "G", "T"],
    }
    r.update(kw)
    return r


def same_as_jax(body):
    """The port's response to a request string, checked byte-equal to the
    JAX service's (status code included)."""
    got = serve.handle_json(body, device=CPU)
    assert got == jax_serve.handle_json(body)
    return json.loads(got[0]), got[1]


@pytest.fixture(autouse=True)
def _no_microbatcher_left():
    yield
    serve.disable_microbatching()
    assert serve._MICRO is None


WASM_MATRIX = [
    [0.0, 0.4, 0.6], [0.0, 0.3, 0.7], [0.3, 0.3, 0.4],
    [0.4, 0.3, 0.3], [0.4, 0.3, 0.3], [0.3, 0.3, 0.4],
    [0.1, 0.4, 0.5], [0.1, 0.5, 0.4], [0.8, 0.1, 0.1],
    [0.1, 0.1, 0.8],
]


class TestServe:
    def test_beam_request_matches_api(self):
        x = rand_read(20, 5, 0)
        r = req(x, beam_size=5, beam_cut_threshold=0.1)
        out = serve.decode_request(r, device=CPU)
        seq, starts = api.beam_search(x, "NACGT", 5, 0.1, device=CPU)
        assert out == {"seq": seq, "starts": starts}
        assert same_as_jax(json.dumps(r)) == (out, 200)

    def test_viterbi_request_matches_api(self):
        x = np.array(WASM_MATRIX, np.float32)
        r = {"method": "viterbi_search", "posteriors": x.reshape(-1).tolist(),
             "shape": [10, 3], "alphabet": ["N", "A", "G"]}
        out = serve.decode_request(r, device=CPU)
        seq, starts = api.viterbi_search(x, "NAG", device=CPU)
        assert out["seq"] == seq == "GGAG"
        assert out["starts"] == starts
        assert same_as_jax(json.dumps(r)) == (out, 200)

    def test_batch_request_matches_api(self):
        reads = [rand_read(20, 5, s) for s in range(5)]
        r = req(np.stack(reads), beam_size=5, beam_cut_threshold=0.1)
        out = serve.decode_request(r, device=CPU)
        assert len(out["results"]) == 5
        for res, read in zip(out["results"], reads):
            seq, starts = api.beam_search(read, "NACGT", 5, 0.1, engine="fast", device=CPU)
            assert (res["seq"], res["starts"], res["err"]) == (seq, starts, 0)
        assert same_as_jax(json.dumps(r)) == (out, 200)

    def test_batch_with_lengths_and_bad_read(self):
        reads = np.stack([rand_read(20, 5, s) for s in range(4)])
        reads[2] = np.nan  # incomparable values: that read fails alone
        r = req(reads, beam_size=5, beam_cut_threshold=0.1, lengths=[20, 9, 20, 0])
        out, code = same_as_jax(json.dumps(r))
        assert code == 200 and [x["err"] for x in out["results"]] == [0, 0, 2, 0]
        bad = dict(r, lengths=[20, 9, 21, 0])
        assert same_as_jax(json.dumps(bad))[1] == 400

    def test_batch_viterbi_with_qstring(self):
        reads = [rand_read(16, 5, s) for s in range(3)]
        r = req(np.stack(reads), method="viterbi_search", qstring=True)
        out = serve.decode_request(r, device=CPU)
        for res, read in zip(out["results"], reads):
            seq, starts = api.viterbi_search(read, "NACGT", qstring=True, device=CPU)
            assert (res["seq"], res["starts"]) == (seq, starts)
        assert same_as_jax(json.dumps(r)) == (out, 200)

    def test_http_status_codes(self):
        good = json.dumps(req(rand_read(10, 5, 1)))
        assert same_as_jax(good)[1] == 200
        for bad in (
            "not json",
            '{"method": "nope", "shape": [1, 2], "posteriors": [0.5, 0.5], "alphabet": "NA"}',
            '{"shape": [10, 5]}',  # KeyError: posteriors
            '{"shape": [2, 2, 2, 2], "posteriors": [0.5], "alphabet": "NA"}',
        ):
            body, code = same_as_jax(bad)
            assert code == 400 and "error" in body
        nan = json.dumps(req(np.full((10, 5), np.nan, np.float32)))
        body, code = same_as_jax(nan)
        assert code == 400
        assert "Failed to compare values" in body["error"]

    def test_json_roundtrip_and_errors(self):
        r = json.dumps(req(rand_read(10, 5, 1)))
        out = json.loads(serve.decode_json(r, device=CPU))
        assert set(out) == {"seq", "starts"}
        assert serve.decode_json(r, device=CPU) == jax_serve.decode_json(r)
        for bad in ('{"method": "nope", "shape": [1, 2]}', "not json"):
            assert "error" in json.loads(serve.decode_json(bad, device=CPU))
            assert serve.decode_json(bad, device=CPU) == jax_serve.decode_json(bad)


class TestWasmGoldens:
    @pytest.mark.parametrize("method, want", [
        ("beam_search", {"seq": "GAGAG", "starts": [0, 1, 2, 4, 6]}),
        ("viterbi_search", {"seq": "GGAG", "starts": [0, 5, 7, 9]}),
    ])
    def test_golden(self, method, want):
        r = {"method": method, "posteriors": [x for row in WASM_MATRIX for x in row],
             "shape": [10, 3], "alphabet": ["N", "A", "G"], "beam_size": 5,
             "beam_cut_threshold": 0.1}
        assert serve.decode_request(r, device=CPU) == want
        assert same_as_jax(json.dumps(r)) == (want, 200)


class TestServeDecoderCache:
    def test_nearby_lengths_share_one_decoder(self):
        serve._DECODER_CACHE.clear()
        for T, seed in ((100, 1), (120, 2)):
            reads = np.stack([rand_read(T, 5, seed + i) for i in range(2)])
            r = req(reads, beam_size=5, beam_cut_threshold=0.1)
            out = serve.decode_request(r, device=CPU)
            for i, res in enumerate(out["results"]):
                seq, starts = api.beam_search(reads[i], "NACGT", 5, 0.1, engine="fast",
                                              device=CPU)
                assert (res["seq"], res["starts"], res["err"]) == (seq, starts, 0)
        assert len(serve._DECODER_CACHE) == 1  # T=100 and T=120 -> T=128
        (key,) = serve._DECODER_CACHE
        assert key[2] == 128 and key[-1] == "cpu"  # keyed on the device too


def run_threads(fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()


class TestMicroBatch:
    def test_concurrent_singles_coalesce(self):
        mb = serve.enable_microbatching(max_wait_ms=200.0, device=CPU)
        reads = [rand_read(20 + i, 5, 100 + i) for i in range(8)]
        outs = [None] * 8

        def run(i):
            outs[i] = serve.decode_request(
                req(reads[i], beam_size=5, beam_cut_threshold=0.1), device=CPU)

        b0 = mb.batches
        run_threads([lambda i=i: run(i) for i in range(8)])
        assert mb.batches - b0 <= 2  # one batch, or two on scheduler skew
        for i, x in enumerate(reads):
            assert outs[i]["seq"] == api.beam_search(x, "NACGT", 5, 0.1, device=CPU)[0]

    def test_bad_request_fails_alone(self):
        serve.enable_microbatching(max_wait_ms=100.0, device=CPU)
        results = {}

        def run(name, r):
            body, code = serve.handle_json(json.dumps(r), device=CPU)
            results[name] = (json.loads(body), code)

        reqs = {
            "good": req(rand_read(20, 5, 3), beam_size=5, beam_cut_threshold=0.1),
            "bad": req(rand_read(20, 5, 4), beam_size=0),  # 400 at submit
        }
        run_threads([lambda k=k, v=v: run(k, v) for k, v in reqs.items()])
        assert results["good"][1] == 200
        assert results["bad"][1] == 400
        assert "beam_size cannot be 0" in results["bad"][0]["error"]

    def test_viterbi_microbatch_matches_api(self):
        serve.enable_microbatching(max_wait_ms=10.0, device=CPU)
        x = rand_read(24, 5, 9)
        out = serve.decode_request(req(x, method="viterbi_search"), device=CPU)
        seq, path = api.viterbi_search(x, "NACGT", device=CPU)
        assert out == {"seq": seq, "starts": path}
        assert json.dumps(out) == jax_serve.decode_json(json.dumps(req(x, method="viterbi_search")))

    def test_qstring_variants_share_one_decoder(self):
        serve.enable_microbatching(max_wait_ms=10.0, device=CPU)
        x = rand_read(24, 5, 21)
        keys0 = set(serve._DECODER_CACHE)
        out_plain = serve.decode_request(req(x, method="viterbi_search"), device=CPU)
        out_q = serve.decode_request(req(x, method="viterbi_search", qstring=True), device=CPU)
        assert len(set(serve._DECODER_CACHE) - keys0) <= 1
        seq, path = api.viterbi_search(x, "NACGT", device=CPU)
        seq_q, path_q = api.viterbi_search(x, "NACGT", qstring=True, device=CPU)
        assert out_plain == {"seq": seq, "starts": path}
        assert out_q == {"seq": seq_q, "starts": path_q}

    def test_different_buckets_group_separately(self):
        mb = serve.enable_microbatching(max_wait_ms=200.0, device=CPU)
        reads = [rand_read(20, 5, 31), rand_read(200, 5, 32)]
        assert _bucket_edge_for(20) != _bucket_edge_for(200)
        outs = [None, None]

        def run(i):
            outs[i] = serve.decode_request(
                req(reads[i], beam_size=5, beam_cut_threshold=0.1), device=CPU)

        b0 = mb.batches
        run_threads([lambda i=i: run(i) for i in range(2)])
        assert mb.batches - b0 == 2
        for i, x in enumerate(reads):
            assert outs[i]["seq"] == api.beam_search(x, "NACGT", 5, 0.1, device=CPU)[0]

    def test_batcher_for_another_device_raises(self):
        mb = serve.enable_microbatching(max_wait_ms=10.0, device=CPU)
        assert serve.enable_microbatching(device=CPU) is mb
        with pytest.raises(ValueError, match="already serves cpu"):
            serve.enable_microbatching(device="meta")
        with pytest.raises(ValueError, match="already serves cpu"):
            serve.make_http_server("127.0.0.1", 0, microbatch=True, device="meta")
        assert serve._MICRO is mb

    def test_dead_worker_fails_requests_instead_of_hanging(self, monkeypatch):
        monkeypatch.setattr(serve.MicroBatcher, "_worker", lambda self: None)
        mb = serve.enable_microbatching(max_wait_ms=10.0, device=CPU)
        mb._thread.join(timeout=TIMEOUT)
        body, code = serve.handle_json(json.dumps(req(rand_read(20, 5, 2))), device=CPU)
        assert code == 500 and "micro-batcher worker is not running" in json.loads(body)["error"]


class TestHttpEndToEnd:
    def test_http_server_microbatch_roundtrip(self):
        httpd = serve.make_http_server("127.0.0.1", 0, microbatch=True, device=CPU)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            reads = [rand_read(20, 5, 200 + i) for i in range(4)]
            results = [None] * 5

            def post(i, body):
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
                try:
                    conn.request("POST", "/", body)
                    r = conn.getresponse()
                    results[i] = (r.status, json.loads(r.read()))
                finally:
                    conn.close()

            bodies = [json.dumps(req(x, beam_size=5, beam_cut_threshold=0.1)) for x in reads]
            bodies.append('{"shape": [10, 5]}')  # malformed: 400 on its own
            run_threads([lambda i=i, b=b: post(i, b) for i, b in enumerate(bodies)])
            for i, x in enumerate(reads):
                status, out = results[i]
                assert status == 200
                assert out["seq"] == api.beam_search(x, "NACGT", 5, 0.1, device=CPU)[0]
            assert results[4][0] == 400 and "error" in results[4][1]
            assert serve._MICRO is not None and serve._MICRO.batches >= 1
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=TIMEOUT)
