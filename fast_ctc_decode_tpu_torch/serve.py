"""JSON decode service: the port of ``fast_ctc_decode_tpu/serve.py``, the
non-Python binding surface (the reference's WASM/JS ``js_beam_search`` /
``js_viterbi_search``, src/lib.rs:63-140, as a wire protocol).

The request and response schema, the JSON bytes and the error mapping are
the JAX package's: input errors (bad params, shape or JSON, search failures
on the given input) are HTTP 400, anything else 500, and the body is always
``{"error": "..."}`` on failure.

Request schema:
    {
      "method": "beam_search" | "viterbi_search",
      "posteriors": [f32, ...],        # flattened row-major
      "shape": [T, A],                 # or [B, T, A] for a batch
      "lengths": [int, ...],           # optional, batch only
      "alphabet": ["N", "A", ...],
      "beam_size": 5,                  # beam_search only
      "beam_cut_threshold": 0.0,       # beam_search only
      "collapse_repeats": true,
      "qstring": false,                # viterbi_search only
      "qscale": 1.0, "qbias": 0.0      # viterbi_search only
    }
Response: ``{"seq": str, "starts": [int, ...]}``; a batch request (3-d
shape) returns ``{"results": [{"seq": ..., "starts": ..., "err": 0}, ...]}``
through the batch decoders, with per-read status codes.

Every entry point takes ``device``: None (the default) is the CUDA card and
raises RuntimeError without one; ``device="cpu"`` runs the plain engines.
Decodes run on that one device; the JAX package's pad of a batch to a
multiple of its mesh has no counterpart (one process, one card).

Run it with ``python -m fast_ctc_decode_tpu_torch.serve`` (one JSON request
per stdin line, one response per line), ``--http [host:port]`` for the HTTP
server, ``--microbatch`` to coalesce concurrent single-read requests, and
``--device cpu`` for the CPU.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import api, errors
from .alphabet import normalize_alphabet
from .device import resolve_device, with_index


def _decode_single(req: Dict[str, Any], posteriors: np.ndarray, device) -> Dict[str, Any]:
    method = req.get("method", "beam_search")
    alphabet = req["alphabet"]
    if method == "beam_search":
        seq, starts = api.beam_search(
            posteriors,
            alphabet,
            int(req.get("beam_size", 5)),
            float(req.get("beam_cut_threshold", 0.0)),
            bool(req.get("collapse_repeats", True)),
            device=device,
        )
    elif method == "viterbi_search":
        seq, starts = api.viterbi_search(
            posteriors,
            alphabet,
            bool(req.get("qstring", False)),
            float(req.get("qscale", 1.0)),
            float(req.get("qbias", 0.0)),
            bool(req.get("collapse_repeats", True)),
            device=device,
        )
    else:
        raise ValueError(f"unknown method {method!r}")
    return {"seq": seq, "starts": list(starts)}


_DECODER_CACHE: Dict[Tuple, Any] = {}
_DECODER_CACHE_MAX = 16
_DECODER_LOCK = threading.Lock()


def _cache_get_or_make(key, factory):
    """FIFO-bounded decoder cache, safe against concurrent handler and
    micro-batcher threads: the caller keeps the returned decoder even if
    another thread evicts the entry immediately after.  Keys end with the
    device."""
    with _DECODER_LOCK:
        dec = _DECODER_CACHE.get(key)
        if dec is None:
            dec = factory()
            if len(_DECODER_CACHE) >= _DECODER_CACHE_MAX:
                _DECODER_CACHE.pop(next(iter(_DECODER_CACHE)))
            _DECODER_CACHE[key] = dec
    return dec


def _beam_decoder(key, device):
    """The cached BatchBeamDecoder of a ("beam", alphabet, T, beam_size,
    threshold, collapse) key on ``device``."""
    from .parallel import pipeline

    return _cache_get_or_make((*key, str(device)), lambda: pipeline.BatchBeamDecoder(
        list(key[1]), T=key[2], beam_size=key[3], beam_cut_threshold=key[4],
        collapse_repeats=key[5], device=device,
    ))


def _viterbi_decoder(key, device):
    """The cached BatchViterbiDecoder of a ("viterbi", alphabet, T, collapse,
    qscale, qbias) key on ``device`` (qstring is a decode-time argument)."""
    from .parallel import pipeline

    return _cache_get_or_make((*key, str(device)), lambda: pipeline.BatchViterbiDecoder(
        list(key[1]), T=key[2], collapse_repeats=key[3], qscale=key[4], qbias=key[5],
        device=device,
    ))


def _decode_batch(req: Dict[str, Any], posteriors: np.ndarray, device) -> Dict[str, Any]:
    """[B, T, A] request through the batch decoders (cached per static
    configuration and device)."""
    from .parallel import pipeline

    method = req.get("method", "beam_search")
    B, T, _ = posteriors.shape
    alphabet = tuple(req["alphabet"])
    lengths = np.asarray(req.get("lengths", [T] * B), np.int32)
    if lengths.shape != (B,):
        raise ValueError("lengths must have one entry per read")
    if np.any(lengths < 0) or np.any(lengths > T):
        raise ValueError("lengths must be in [0, T]")

    # round T up to a power-of-two bucket edge so requests with naturally
    # varying read lengths share decoders (per-read ``lengths`` keep the
    # decode exact on the padded frames)
    Tb = pipeline._bucket_edge_for(T)
    if Tb > T:
        posteriors = np.concatenate(
            [posteriors, np.zeros((B, Tb - T, posteriors.shape[2]), np.float32)],
            axis=1,
        )
        T = Tb

    if method == "beam_search":
        dec = _beam_decoder((
            "beam", alphabet, T,
            int(req.get("beam_size", 5)),
            float(req.get("beam_cut_threshold", 0.0)),
            bool(req.get("collapse_repeats", True)),
        ), device)
        res = dec.decode(posteriors, lengths)
        return {
            "results": [
                {"seq": s, "starts": p, "err": int(e)} for s, p, e in res
            ]
        }
    if method == "viterbi_search":
        dec = _viterbi_decoder((
            "viterbi", alphabet, T,
            bool(req.get("collapse_repeats", True)),
            float(req.get("qscale", 1.0)),
            float(req.get("qbias", 0.0)),
        ), device)
        res = dec.decode(posteriors, lengths, qstring=bool(req.get("qstring", False)))
        return {
            "results": [{"seq": s, "starts": p, "err": 0} for s, p in res]
        }
    raise ValueError(f"unknown method {method!r}")


class _MicroItem:
    __slots__ = ("key", "req", "post", "T", "event", "result", "error")

    def __init__(self, key, req, post, T):
        self.key = key
        self.req = req
        self.post = post
        self.T = T
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce concurrent single-read requests into one device batch.

    The reference binding decodes one read per call (src/lib.rs:63-140); on
    a card that wastes it: a single T=1000 read occupies one thread of one
    block.  The micro-batcher holds each single-read (2-d shape) request for
    at most ``max_wait_ms``, stacks every compatible pending request (same
    method, alphabet, parameters and T bucket) into one [B, Tb, A] batch
    through the cached batch decoders on ``device``, then fans results back
    out.  Per-read status codes keep one bad read from failing its
    batch-mates; malformed requests are rejected at submit time, before
    batching.  Its worker thread launches the kernels, with ``device`` as
    its current CUDA device.

    Trade-off (opt-in, ``serve_http(..., microbatch=True)``): batched beam
    decodes run the throughput engines, whose ``path`` entries for
    pruned-and-re-derived prefixes may differ from the single-call exact
    engine (sequences are identical; see BatchBeamDecoder).
    """

    def __init__(self, max_batch: int = 256, max_wait_ms: float = 3.0, device=None):
        self.device = with_index(resolve_device(device))
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self._cv = threading.Condition()
        self._pending: List[_MicroItem] = []
        self._closed = False
        self.batches = 0  # device batches run (observability / tests)
        self.requests = 0
        self._thread = threading.Thread(
            target=self._worker, name="microbatcher", daemon=True
        )
        self._thread.start()

    # -- request -> group key (validates eagerly so a bad request fails
    #    alone with the API's own messages, never poisoning a batch)
    def _key_for(self, req: Dict[str, Any], post: np.ndarray):
        from .parallel import pipeline

        method = req.get("method", "beam_search")
        alphabet = tuple(normalize_alphabet(req["alphabet"]))
        if len(alphabet) != post.shape[1]:
            raise ValueError(
                f"alphabet size {len(alphabet)} does not match probability "
                f"matrix inner dimension {post.shape[1]}"
            )
        T = int(post.shape[0])
        if T == 0:
            raise ValueError("network_output must not be empty")
        Tb = pipeline._bucket_edge_for(T)
        if method == "beam_search":
            beam_size = int(req.get("beam_size", 5))
            thr = float(req.get("beam_cut_threshold", 0.0))
            api._check_beam_args(list(alphabet), beam_size, thr)
            return (
                "beam", alphabet, Tb, beam_size, thr,
                bool(req.get("collapse_repeats", True)),
            )
        if method == "viterbi_search":
            return (
                "viterbi", alphabet, Tb,
                bool(req.get("collapse_repeats", True)),
                float(req.get("qscale", 1.0)),
                float(req.get("qbias", 0.0)),
                bool(req.get("qstring", False)),
            )
        raise ValueError(f"unknown method {method!r}")

    def submit(self, req: Dict[str, Any], post: np.ndarray) -> Dict[str, Any]:
        """Block until this request's batch is decoded; returns the
        single-read response dict or re-raises its per-read failure."""
        key = self._key_for(req, post)
        item = _MicroItem(key, req, post, int(post.shape[0]))
        with self._cv:
            if self._closed:
                raise RuntimeError("micro-batcher is closed")
            self._pending.append(item)
            self.requests += 1
            self._cv.notify_all()
        while not item.event.wait(timeout=1.0):
            if not self._thread.is_alive():  # never wait on a worker that died
                raise RuntimeError("micro-batcher worker is not running")
        if item.error is not None:
            raise item.error
        assert item.result is not None
        return item.result

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join()

    def _worker(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                deadline = time.monotonic() + self.max_wait
                while len(self._pending) < self.max_batch and not self._closed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                items, self._pending = self._pending, []
            groups: Dict[Tuple, List[_MicroItem]] = {}
            for it in items:
                groups.setdefault(it.key, []).append(it)
            for key, group in groups.items():
                try:
                    self._run_group(key, group)
                except BaseException as e:  # fan the fault out, keep serving
                    for it in group:
                        it.error = e
                        it.event.set()

    def _run_group(self, key: Tuple, group: List[_MicroItem]):
        Tb = key[2]
        A1 = len(key[1])
        B = len(group)
        probs = np.zeros((B, Tb, A1), np.float32)
        lengths = np.zeros((B,), np.int32)
        for i, it in enumerate(group):
            probs[i, : it.T] = it.post
            lengths[i] = it.T

        if key[0] == "beam":
            dec = _beam_decoder(key, self.device)
        else:
            dec = _viterbi_decoder(key[:6], self.device)
        self.batches += 1
        if key[0] == "beam":
            res = dec.decode(probs, lengths)
            for it, (seq, starts, err) in zip(group, res):
                if err != errors.OK:
                    it.error = errors.SearchError(err)
                else:
                    it.result = {"seq": seq, "starts": list(starts)}
                it.event.set()
        else:
            res = dec.decode(probs, lengths, qstring=key[6])
            for it, (seq, starts) in zip(group, res):
                it.result = {"seq": seq, "starts": list(starts)}
                it.event.set()


_MICRO: Optional[MicroBatcher] = None


def enable_microbatching(max_batch: int = 256, max_wait_ms: float = 3.0, device=None):
    """Route single-read requests for ``device`` through a shared
    MicroBatcher (the one already running, if any).  ValueError if the one
    running serves another device: one process batches for one card."""
    global _MICRO
    dev = with_index(resolve_device(device))
    if _MICRO is None:
        _MICRO = MicroBatcher(max_batch=max_batch, max_wait_ms=max_wait_ms, device=dev)
    elif _MICRO.device != dev:
        raise ValueError(
            f"a micro-batcher already serves {_MICRO.device}, not {dev}; "
            "call disable_microbatching() first"
        )
    return _MICRO


def disable_microbatching():
    global _MICRO
    if _MICRO is not None:
        _MICRO.close()
        _MICRO = None


def decode_request(req: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Execute one decode request dict on ``device``; returns the response
    dict.  Single-read requests go through the micro-batcher when one runs
    on the same device.

    Raises ValueError/TypeError/KeyError/SearchError exactly like the Python
    API: callers map these to protocol errors.
    """
    dev = resolve_device(device)
    shape = req["shape"]
    posteriors = np.asarray(req["posteriors"], np.float32)
    if len(shape) == 2:
        if (
            _MICRO is not None
            and _MICRO.device == with_index(dev)
            and req.get("method", "beam_search") in ("beam_search", "viterbi_search")
        ):
            return _MICRO.submit(req, posteriors.reshape(shape))
        return _decode_single(req, posteriors.reshape(shape), dev)
    if len(shape) == 3:
        return _decode_batch(req, posteriors.reshape(shape), dev)
    raise ValueError("shape must be [T, A] or [B, T, A]")


def handle_json(request_json: str, device=None) -> Tuple[str, int]:
    """String-in entry point: returns (response_json, http_status).

    Input-derived failures (malformed JSON/params, search errors on the
    given posteriors) are 400; anything unexpected is a 500.  Without a
    CUDA device, ``device=None`` raises RuntimeError before any request is
    read.
    """
    dev = resolve_device(device)
    try:
        req = json.loads(request_json)
        return json.dumps(decode_request(req, dev)), 200
    except (
        ValueError,  # includes json.JSONDecodeError and API validation
        TypeError,
        KeyError,
        errors.SearchError,  # RuntimeError subclass: input-induced
    ) as e:
        return json.dumps({"error": f"{type(e).__name__}: {e}"}), 400
    except Exception as e:  # pragma: no cover - server-side fault
        return json.dumps({"error": f"{type(e).__name__}: {e}"}), 500


def decode_json(request_json: str, device=None) -> str:
    """String-in/string-out entry point (the js_beam_search analog)."""
    return handle_json(request_json, device)[0]


def make_http_server(host: str = "127.0.0.1", port: int = 8000, microbatch: bool = False,
                     device=None):
    """The threaded stdlib HTTP server of ``serve_http``, bound but not yet
    serving (port 0 binds a free port: ``server.server_address[1]``).  The
    caller runs ``serve_forever`` and ends it with ``shutdown``.  ``device``
    is resolved here, so a server without its card fails before it binds."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    dev = resolve_device(device)
    if microbatch:
        enable_microbatching(device=dev)

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length).decode("utf-8")
            out, code = handle_json(body, dev)
            data = out.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):  # quiet
            pass

    class Server(ThreadingHTTPServer):
        # the listen backlog: socketserver's default of 5 resets the
        # connections of a burst of concurrent single-read clients
        request_queue_size = 1024
        daemon_threads = True

    return Server((host, port), Handler)


def serve_http(host: str = "127.0.0.1", port: int = 8000, microbatch: bool = False,
               device=None):
    """Threaded stdlib HTTP server: POST / with a request JSON body.

    Handler threads overlap host-side JSON and detok work across requests;
    their decodes share the one device.  Throughput-minded clients send
    batch (3-d shape) requests, or the server runs with ``microbatch=True``
    (CLI ``--microbatch``) to coalesce concurrent single-read requests into
    shared device batches (see MicroBatcher).
    """
    httpd = make_http_server(host, port, microbatch, device)
    print(f"fast_ctc_decode_tpu_torch serving on http://{host}:{httpd.server_address[1]}",
          flush=True)
    httpd.serve_forever()


def main(argv=None):
    """CLI: one JSON request per stdin line -> one JSON response per line,
    or --http [host:port] for the HTTP server; --microbatch, --device DEV."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    microbatch = "--microbatch" in args
    args = [a for a in args if a != "--microbatch"]
    device = None
    if "--device" in args:
        i = args.index("--device")
        if i + 1 >= len(args):
            raise SystemExit("--device needs a value (e.g. cpu, cuda, cuda:1)")
        device = args[i + 1]
        del args[i : i + 2]
    dev = resolve_device(device)
    if args and args[0] == "--http":
        hp = args[1] if len(args) > 1 else "127.0.0.1:8000"
        host, _, port = hp.partition(":")
        serve_http(host, int(port or 8000), microbatch=microbatch, device=dev)
        return
    if microbatch:
        # honoured in stdin mode too (coalescing only helps when several
        # producers share the process, but the flag must not be a no-op)
        enable_microbatching(device=dev)
    for line in sys.stdin:
        line = line.strip()
        if line:
            print(decode_json(line, dev), flush=True)


if __name__ == "__main__":
    main()
