"""What the span readers share: a metric ``<family>.<suffix>`` reads the
program's stage ``<path>.<stage>``, its path from the suffix (``frames``:
the beam path's ``beam.*``; ``pairs``: the duplex path's ``duplex.*``)."""

PATHS = {"frames": "beam", "pairs": "duplex"}


def share(name, view, stage):
    """The seconds of the stage ``<path>.<stage>`` over the window's, in %;
    None where the run recorded no such stage (a program without it)."""
    path = PATHS.get(name.rsplit(".", 1)[-1])
    span = f"{path}.{stage}"
    if path is None or span not in view.stages or view.window_s <= 0:
        return None
    return 100.0 * view.stages[span] / view.window_s
