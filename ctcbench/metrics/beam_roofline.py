"""The beam decode's bound (``roofline.beam_work``: its own inputs and final
outputs) over the device time of every kernel in the traced window."""

from .. import roofline


def read(name, view):
    return roofline.share(view.work.get("beam"), view.trace and view.trace.kernel_s)
