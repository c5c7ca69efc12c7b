"""Share of the window in one stage of the program's CRF duplex path: a
metric ``crf_duplex_stage.<stage>`` reads the stage ``crf_duplex.<stage>``
(``prep``: the batch's preparation, envelopes, init states and root bands;
``size``: the tree kernel's launch sizing; ``wait``: a stream sync after the
launches, the kernels the host waits on); None where the run recorded no
such stage."""


def read(name, view):
    span = "crf_duplex." + name.split(".", 1)[1]
    if span not in view.stages or view.window_s <= 0:
        return None
    return 100.0 * view.stages[span] / view.window_s
