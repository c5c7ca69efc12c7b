"""Share of the traced window in which no kernel, copy or fill ran on the
card (the profiler's device activity, intervals merged)."""


def read(name, view):
    t = view.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
