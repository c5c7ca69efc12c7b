"""Error model: per-read status codes and the exception they map to.

The reference (nanoporetech/fast-ctc-decode, ``src/lib.rs:36-58``) models
runtime search failures as a Rust enum ``SearchError { RanOutOfBeam,
IncomparableValues, InvalidEnvelope }`` that the binding layer maps to
``RuntimeError``; argument violations raise ``ValueError`` before the
kernel runs.

A device kernel cannot raise per read, so kernels return a per-read int32
*status code* instead (0 = OK).  Batched APIs surface the codes per read
without aborting the batch; host code maps a non-zero code back to the
exception the reference would have raised, with byte-identical messages.
Codes and messages are the same as in ``fast_ctc_decode_tpu.errors``.
"""

from __future__ import annotations

# Status codes, stable ABI for device kernels.
OK = 0
RAN_OUT_OF_BEAM = 1  # reference: src/search.rs:274-277
INCOMPARABLE_VALUES = 2  # reference: src/search.rs:261-272 (NaN during sort)
INVALID_ENVELOPE = 3  # reference: src/duplex.rs:485-488
NODE_OVERFLOW = 4  # no reference analog: fixed max_nodes budget exhausted

_MESSAGES = {
    RAN_OUT_OF_BEAM: "Ran out of search space (beam_cut_threshold too high)",
    INCOMPARABLE_VALUES: "Failed to compare values (NaNs in input?)",
    INVALID_ENVELOPE: "Invalid envelope values",
    NODE_OVERFLOW: (
        "Search tree node budget exhausted (increase max_nodes); "
        "this input exceeds the preallocated device tree"
    ),
}


class SearchError(RuntimeError):
    """Runtime search failure, mirroring the reference's SearchError→RuntimeError map."""

    def __init__(self, code: int):
        self.code = int(code)
        super().__init__(_MESSAGES.get(self.code, f"Unknown search error {code}"))


def status_message(code: int) -> str:
    return _MESSAGES.get(int(code), f"Unknown search error {code}")


def raise_for_status(code: int) -> None:
    """Map a device status code to the exception contract of the reference bindings."""
    code = int(code)
    if code != OK:
        raise SearchError(code)
