"""One table from a beam decode's three choices to its batch function: CRF
(init states given) or 1D, tree ("exact") or hash, the hand-written kernel
or the plain PyTorch engine.  The pipeline's decoders and the single-read
API each say which engine name is a kernel on which device."""

from . import beam, beam_cuda, beam_exact_cuda, beam_fast, crf

#: (crf, tree, kernel) -> (module, function name), looked up at each call so
#: that a wrapped or patched module attribute is what runs
TABLE = {
    (False, False, True): (beam_cuda, "beam_search_kernel_batch"),
    (False, False, False): (beam_fast, "beam_search_fast_batch"),
    (False, True, True): (beam_exact_cuda, "beam_search_exact_kernel_batch"),
    (False, True, False): (beam, "beam_search_device_batch"),
    (True, False, True): (beam_cuda, "crf_beam_search_kernel_batch"),
    (True, False, False): (beam_fast, "crf_beam_search_fast_batch"),
    (True, True, True): (beam_exact_cuda, "crf_beam_search_exact_kernel_batch"),
    (True, True, False): (crf, "crf_beam_search_device_batch"),
}


def beam_batch(probs, lengths, thr, *, beam_size, tree, kernel, init_states=None,
               collapse_repeats=True, max_nodes=None):
    """The result dict (labels_rev, times_rev, count, err) of the function
    ``TABLE`` holds for the choice, on ``probs``' device.  A tree engine's
    ``max_nodes`` defaults to the worst case for the batch's T and A
    (``beam.default_max_nodes``); the hash engines ignore it, and CRF takes
    no ``collapse_repeats``."""
    is_crf = init_states is not None
    module, name = TABLE[is_crf, bool(tree), bool(kernel)]
    kw = {"beam_size": int(beam_size)}
    if not is_crf:
        kw["collapse_repeats"] = bool(collapse_repeats)
    if tree:
        if max_nodes is None:
            max_nodes = beam.default_max_nodes(probs.shape[1], beam_size, probs.shape[-1] - 1)
        kw["max_nodes"] = int(max_nodes)
    args = (probs, lengths) if not is_crf else (probs, init_states, lengths)
    return getattr(module, name)(*args, thr, **kw)
