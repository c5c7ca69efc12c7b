"""Native (C++) host runtime pieces, loaded via ctypes with Python fallback."""

from .build import get_lib, detokenize_batch, qstrings_batch  # noqa: F401
