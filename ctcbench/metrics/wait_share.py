"""Share of the window in which the program waits for its kernels (its
``beam.wait`` / ``duplex.wait`` span: a stream sync after the launches,
before the copies home)."""

from ._span import share


def read(name, view):
    return share(name, view, "wait")
