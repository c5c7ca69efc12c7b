"""The engine table (``ops/engines.py``): which beam batch function each
(CRF, tree, kernel) choice runs, and the tree budget it is given.

Each choice names the function the decoders and the API have always run for
it, looked up through its module at the call (a patched module attribute is
what runs); a tree engine gets the worst-case ``max_nodes`` for its batch
unless one is given, a hash engine none.  The pipeline's decoders and the
single-read API reach the same functions on the CPU with the same budgets.
"""

import numpy as np
import pytest
import torch

from fast_ctc_decode_tpu_torch import api
from fast_ctc_decode_tpu_torch.ops import beam, beam_cuda, beam_fast, crf, engines
from fast_ctc_decode_tpu_torch.parallel import pipeline

ALPHA = "NACGT"
B, T, S, K = 2, 7, 4, 3


def stub_all(monkeypatch):
    """Every table function replaced by a stub that records its module, name
    and keywords and returns an empty result of the batch's shape."""
    calls = []
    for module, name in engines.TABLE.values():
        def stub(probs, *args, _at=(module, name), **kw):
            calls.append((*_at, kw))
            b, t = probs.shape[:2]
            zeros = torch.zeros((b,), dtype=torch.int32)
            return {"labels_rev": torch.full((b, t), -1, dtype=torch.int32),
                    "times_rev": torch.full((b, t), -1, dtype=torch.int32),
                    "count": zeros, "err": zeros.clone()}
        monkeypatch.setattr(module, name, stub)
    return calls


def batch(is_crf):
    probs = torch.rand((B, T, S, 5) if is_crf else (B, T, 5))
    init = torch.rand((B, S)) if is_crf else None
    return probs, torch.full((B,), T, dtype=torch.int32), init


@pytest.mark.parametrize("choice", list(engines.TABLE))
def test_each_choice_runs_its_function_with_its_budget(monkeypatch, choice):
    is_crf, tree, kernel = choice
    module, name = engines.TABLE[choice]
    calls = stub_all(monkeypatch)
    probs, lengths, init = batch(is_crf)
    for given in (None, 11):
        engines.beam_batch(probs, lengths, np.float32(0.0), beam_size=K, tree=tree,
                           kernel=kernel, init_states=init, max_nodes=given)
    want = {"beam_size": K}
    if not is_crf:
        want["collapse_repeats"] = True
    budgets = [beam.default_max_nodes(T, K, 4), 11] if tree else [None, None]
    assert calls == [(module, name, {**want, **({"max_nodes": n} if n else {})}) for n in budgets]


def pipeline_site(engine, is_crf):
    probs, lengths, init = batch(is_crf)
    if engine == "cuda":  # the pipeline's kernel choice, without a card
        return pipeline._decode_arrays("cuda", torch.device("cpu"), probs, lengths, 0.0, K,
                                       init_states=init)
    if is_crf:
        return pipeline.BatchCrfBeamDecoder(ALPHA, T=T, n_state=S, beam_size=K, engine=engine,
                                            device="cpu").decode_arrays(probs, init, lengths)
    return pipeline.BatchBeamDecoder(ALPHA, T=T, beam_size=K, engine=engine,
                                     device="cpu").decode_arrays(probs, lengths)


def api_site(engine, is_crf):
    probs, _, init = batch(is_crf)
    probs = probs[0].numpy()
    if is_crf:
        return api.crf_beam_search(probs, init[0].numpy(), ALPHA, K, engine=engine,
                                   device="cpu")
    return api.beam_search(probs, ALPHA, K, engine=engine, device="cpu")


#: (site, engine, crf) -> the function that site ran before the table
SITES = {
    ("pipeline", "cuda", False): (beam_cuda, "beam_search_kernel_batch"),
    ("pipeline", "fast", False): (beam_fast, "beam_search_fast_batch"),
    ("pipeline", "exact", False): (beam, "beam_search_device_batch"),
    ("pipeline", "cuda", True): (beam_cuda, "crf_beam_search_kernel_batch"),
    ("pipeline", "fast", True): (beam_fast, "crf_beam_search_fast_batch"),
    ("pipeline", "exact", True): (crf, "crf_beam_search_device_batch"),
    ("api", "fast", False): (beam_fast, "beam_search_fast_batch"),
    ("api", "exact", False): (beam, "beam_search_device_batch"),
    ("api", "fast", True): (beam_fast, "crf_beam_search_fast_batch"),
    ("api", "exact", True): (crf, "crf_beam_search_device_batch"),
}


@pytest.mark.parametrize("site, engine, is_crf", list(SITES))
def test_decoders_and_api_reach_the_same_functions(monkeypatch, site, engine, is_crf):
    calls = stub_all(monkeypatch)
    {"pipeline": pipeline_site, "api": api_site}[site](engine, is_crf)
    [(module, name, kw)] = calls
    assert (module, name) == SITES[site, engine, is_crf]
    # the worst case for the batch's T where a tree engine runs, as before
    assert kw.get("max_nodes") == (beam.default_max_nodes(T, K, 4) if engine == "exact" else None)
