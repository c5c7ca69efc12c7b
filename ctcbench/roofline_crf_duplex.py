"""The CRF duplex decode's work, on ``roofline.py``'s rules (its own inputs
and final outputs, never a kernel's intermediate tensors):

- inputs as the work needs them: at each step of read 1 a pair's beam reads
  the rows of its K tips' states, ``K * (A+1)`` float32, not the whole
  ``[n_state, A+1]`` frame; each band cell of read 2 under the envelope
  reads K rows of ``A+1`` float32 at the tips' states; both init states
  (``n_state`` float32 each), the envelope (two int32 a frame of read 1)
  and the length of read 1;
- outputs as ``roofline.duplex_work`` counts them: a label an emitted base,
  a count and a status a pair, int32 each;
- operations as ``roofline.duplex_work``: ten a band cell for each of the
  ``K + K*A`` candidates of a step.

A kernel cannot read less than one row a tip at each step and band cell, so
its share of the bound cannot pass 100 %.
"""

from __future__ import annotations

from .roofline import bound_s, share  # noqa: F401


def crf_duplex_work(frames1: int, band_cells: int, pairs: int, bases: int, K: int, A1: int,
                    S: int):
    """``(bytes, ops)`` of a CRF duplex decode of ``pairs`` pairs of ``S``
    states: ``frames1`` frames of read 1, ``band_cells`` cells of read 2
    under the envelopes, ``bases`` bases emitted."""
    nbytes = (4 * frames1 * K * A1 + 4 * band_cells * K * A1 + 2 * 4 * S * pairs
              + 8 * frames1 + 4 * pairs + 4 * bases + 8 * pairs)
    return nbytes, band_cells * (K + K * (A1 - 1)) * 10
