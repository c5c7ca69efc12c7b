"""fast_ctc_decode_tpu_torch — the PyTorch + CUDA port of fast_ctc_decode_tpu.

Batched 1D CTC prefix beam search on one NVIDIA GPU (hand-written CUDA
kernels for Hopper, ``sm_90a``) or on the CPU (the plain PyTorch engine),
bit-identical to the JAX package's ``fast``/``pallas`` engines.  It imports
neither jax nor the JAX package.

Public surface: ``BatchBeamDecoder`` and ``decode_many`` (the batch
pipeline), ``SearchError`` and ``__version__``.  The single-read API of the
JAX package (``api.py``) is not ported yet.
"""

from .errors import SearchError
from .parallel.pipeline import BatchBeamDecoder, decode_many

__version__ = "0.1.0"

__all__ = ["BatchBeamDecoder", "decode_many", "SearchError", "__version__"]
