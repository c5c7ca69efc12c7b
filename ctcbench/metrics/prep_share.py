"""Share of the window in the program's host preparation of duplex batches
(its ``duplex.prep`` span: ``prep_duplex_batch``'s log conversion, envelope
clamping and root bands)."""

from ._span import share


def read(name, view):
    return share(name, view, "prep")
