"""The plain reference of the benchmark: NumPy re-implementations of the
upstream ``fast-ctc-decode`` semantics (``beam_search``, src/search.rs:159-301;
``beam_search_duplex``, src/duplex.rs:443-650), copied from the repository's
test oracle and frozen here, so that no change to the program or its tests
moves the yardstick.

Nothing here imports the measured package, its tests or JAX.  Every
function takes the raw posteriors (and envelopes) that the benchmark made and
works out everything else itself.  ``q`` is the rounding applied after every
arithmetic step: ``np.float32`` is the configuration's precision, and
``bf16`` the nearest precision below it, the precision control of
``ctcbench.control``.
"""

from .ctc import beam_search  # noqa: F401
from .duplex import beam_search_duplex  # noqa: F401
from .precision import bf16, f32  # noqa: F401
