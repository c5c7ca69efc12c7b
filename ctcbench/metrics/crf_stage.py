"""Share of the window in one stage of the program's CRF path: a metric
``crf_stage.<stage>`` reads the stage ``crf.<stage>`` (``crf_stage.wait``:
``crf.wait``, a stream sync after the launches, the kernels the host waits
on); None where the run recorded no such stage."""


def read(name, view):
    span = "crf." + name.split(".", 1)[1]
    if span not in view.stages or view.window_s <= 0:
        return None
    return 100.0 * view.stages[span] / view.window_s
