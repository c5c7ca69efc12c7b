"""The CRF beam decode's work, on ``roofline.py``'s rules (its own inputs
and final outputs, never a kernel's intermediate tensors):

- inputs as the work needs them: at each step a read's beam reads the rows
  of its K tips' states, ``K * (A+1)`` float32, not the whole
  ``[n_state, A+1]`` frame; each read's ``init_state`` (``n_state``
  float32) and its length;
- outputs as ``roofline.beam_work`` counts them: a label and a frame index
  an emitted base, a count and a status a read, int32 each;
- operations ``roofline.beam_step_ops(K, A)`` a read-step, as for the 1D
  beam (the CRF step has no collapse of repeats, and its state update is
  integer work).

A kernel cannot read less than one row a tip, so its share of the bound
cannot pass 100 %.
"""

from __future__ import annotations

from .roofline import beam_step_ops, bound_s, share  # noqa: F401


def crf_work(frames: int, reads: int, bases: int, K: int, A1: int, S: int):
    """``(bytes, ops)`` of a CRF beam decode of ``reads`` reads of ``S``
    states holding ``frames`` frames of ``A1`` float32 labels a state, that
    emitted ``bases`` bases."""
    nbytes = 4 * frames * K * A1 + 4 * reads * S + 4 * reads + 8 * bases + 8 * reads
    return nbytes, frames * beam_step_ops(K, A1 - 1)
