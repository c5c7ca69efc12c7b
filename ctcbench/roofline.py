"""The card's peaks and the least time a decode could take on it.

Copied from the repository's ``chip_smoke.py`` (``bound``, ``beam_step_ops``,
``beam_bound``, ``duplex_bound``) and counted anew on the decode's own
inputs and final outputs, never on a kernel's:

- Intermediate tensors are not counted.  The beam's ``[T, K, B]`` id log is
  one kernel's output and the next kernel's input, and the duplex decoder's
  log posteriors, clamped bounds and root bands are derived on the host.
  Counting them would let a change that fuses two kernels, or moves a
  derivation, move the yardstick it is judged by.
- Inputs are counted as the work needs them: the frames each read's steps
  read (a padded frame is the layout's cost, not the work's), the lengths,
  and for duplex both reads' frames and the envelope as two int32 bounds a
  frame of read 1.
- Outputs are what the decode returns that carries information: a label and
  a frame index (beam) or a label (duplex) per emitted base, and a count and
  a status per read, int32 each.
- Operations are the f32 arithmetic of the algorithm per step, as
  ``chip_smoke.py`` counts it: ``beam_step_ops`` a read-step, and ten a band
  cell for each of the ``K + K*A`` candidates of a duplex step.

The bound is the larger of bytes over the HBM bandwidth and operations over
the f32 rate outside the tensor cores (no matrix product here); a share of
it is the bound over the device time of every kernel the decode launched.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take for ``nbytes`` moved once and
    ``ops`` f32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def beam_step_ops(K: int, A: int) -> int:
    """f32 operations of one read-step of the beam: K*A extension products,
    K label+gap sums, 2K stay/blank products, K tip sums, K + K*A candidate
    totals, K*(K + K*A) selection compares, 2K divides."""
    return K * A + K + 2 * K + K + (K + K * A) + K * (K + K * A) + 2 * K


def beam_work(frames: int, reads: int, bases: int, K: int, A1: int):
    """``(bytes, ops)`` of a beam decode of ``reads`` reads holding ``frames``
    frames of ``A1`` float32 symbols, that emitted ``bases`` bases."""
    nbytes = 4 * frames * A1 + 4 * reads + 8 * bases + 8 * reads
    return nbytes, frames * beam_step_ops(K, A1 - 1)


def duplex_work(frames1: int, frames2: int, band_cells: int, pairs: int, bases: int,
                K: int, A1: int):
    """``(bytes, ops)`` of a duplex decode of ``pairs`` pairs: both reads'
    frames, read 1's envelope (two int32 a frame) and lengths in; a label
    per emitted base, a count and a status a pair out; ``band_cells`` cells
    of read 2 under the envelopes, each of ten operations for each of the
    ``K + K*A`` candidates of a step."""
    nbytes = 4 * (frames1 + frames2) * A1 + 8 * frames1 + 4 * pairs + 4 * bases + 8 * pairs
    return nbytes, band_cells * (K + K * (A1 - 1)) * 10


def share(work, kernel_s):
    """Percent of the bound in ``kernel_s`` of device time; None where there
    is no work or no kernel time to read."""
    if not work or kernel_s is None or kernel_s <= 0:
        return None
    return 100.0 * bound_s(*work) / kernel_s
