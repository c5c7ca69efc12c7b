"""Share of the window in the program's copies of results home (its
``beam.fetch`` / ``duplex.fetch`` span, after the kernels have finished)."""

from ._span import share


def read(name, view):
    return share(name, view, "fetch")
