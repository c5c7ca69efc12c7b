"""fast_ctc_decode_tpu_torch — the PyTorch + CUDA port of fast_ctc_decode_tpu.

CTC decoding on one NVIDIA GPU (hand-written CUDA kernels for Hopper,
``sm_90a``) or on the CPU (plain PyTorch engines), bit-identical to the
JAX package's engines.  It imports neither jax nor the JAX package.

Public surface:
  - the single-read reference API (``api.py``): ``viterbi_search``,
    ``beam_search``, ``crf_greedy_search``, ``crf_beam_search``,
    ``beam_search_duplex`` and ``crf_beam_search_duplex``, each with a
    keyword-only ``device``;
  - the batch pipeline: ``BatchBeamDecoder`` (engines cuda/fast/exact),
    ``BatchViterbiDecoder``, ``BatchCrfBeamDecoder`` (cuda/fast/exact),
    ``BatchDuplexDecoder`` (cuda/fast/exact), ``BatchCrfDuplexDecoder``
    (fast/exact), and the checkpointable ``decode_many`` /
    ``decode_many_crf`` / ``decode_many_duplex`` / ``decode_many_crf_duplex``;
  - ``SearchError`` and ``__version__``.
Beside it: the JSON/HTTP service ``serve`` (``python -m
fast_ctc_decode_tpu_torch.serve``), the process-group helpers
``parallel.mesh`` (one process per card, torch.distributed), and the
measurement tools under ``tools`` (``python -m
fast_ctc_decode_tpu_torch.tools.<name>``).  Beside the package:
``bench_torch.py`` (the headline benchmark) and
``examples/basecall_demo_torch.py``.

Every entry point takes ``device``: None (the default) is the CUDA card and
raises RuntimeError without one; ``device="cpu"`` runs the plain engines.
"""

from .api import (
    beam_search,
    beam_search_duplex,
    crf_beam_search,
    crf_beam_search_duplex,
    crf_greedy_search,
    viterbi_search,
)
from .errors import SearchError
from .parallel.pipeline import (
    BatchBeamDecoder,
    BatchCrfBeamDecoder,
    BatchCrfDuplexDecoder,
    BatchDuplexDecoder,
    BatchViterbiDecoder,
    decode_many,
    decode_many_crf,
    decode_many_crf_duplex,
    decode_many_duplex,
)

__version__ = "0.1.0"

__all__ = [
    "viterbi_search",
    "beam_search",
    "crf_greedy_search",
    "crf_beam_search",
    "beam_search_duplex",
    "crf_beam_search_duplex",
    "BatchBeamDecoder",
    "BatchViterbiDecoder",
    "BatchCrfBeamDecoder",
    "BatchDuplexDecoder",
    "BatchCrfDuplexDecoder",
    "decode_many",
    "decode_many_crf",
    "decode_many_duplex",
    "decode_many_crf_duplex",
    "SearchError",
    "__version__",
]
