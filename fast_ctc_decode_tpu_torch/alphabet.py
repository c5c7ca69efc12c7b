"""Alphabet handling and host-side detokenization.

The reference accepts any Python sequence of str (``seq_to_vec``,
reference ``src/lib.rs:144-146``): a ``str`` yields its characters, a
list/tuple yields ``str(elem)`` per element, so multi-character labels are
supported.  Label index 0 is the blank and is never emitted.

Device kernels work purely in label-index space; sequences are materialized
host-side from fixed-width int32 token arrays (ragged strings never live on
the device).  A C++ fast path for large batches lives in ``native/``; this
module is the always-available pure-Python implementation.
"""

from __future__ import annotations

from typing import List, Sequence, Union


def normalize_alphabet(alphabet: Union[str, Sequence]) -> List[str]:
    """Convert the user-provided alphabet into a list of string labels.

    Mirrors seq_to_vec (reference src/lib.rs:144-146): iterate the sequence,
    stringify each element.  Raises TypeError for non-sequences, like PyO3's
    PySequence conversion would.
    """
    if isinstance(alphabet, str):
        return list(alphabet)
    if isinstance(alphabet, (list, tuple)):
        return [str(x) for x in alphabet]
    try:
        return [str(x) for x in list(alphabet)]
    except TypeError:
        raise TypeError("alphabet must be a str or a sequence of str")


def detokenize(labels, alphabet: List[str]) -> str:
    """Join alphabet entries for a sequence of label indices (0-based row index
    into the full alphabet, i.e. blank would be index 0 — callers never pass
    blanks)."""
    return "".join(alphabet[int(l)] for l in labels)


def quality_string(qints) -> str:
    """ASCII-encode rounded phred integers (already offset-free); +33 offset
    per reference src/search.rs:35."""
    return "".join(chr(int(q) + 33) for q in qints)
