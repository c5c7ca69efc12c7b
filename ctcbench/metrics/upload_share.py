"""Share of the window in the program's copies of a batch to the card (its
``beam.upload`` / ``duplex.upload`` span; past a duplex batch's first
chunk, the wait in stream order behind the previous chunk's kernel too)."""

from ._span import share


def read(name, view):
    return share(name, view, "upload")
