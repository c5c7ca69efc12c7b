"""The duplex decode's bound (``roofline.duplex_work``) over the device time
of every kernel in the traced window."""

from .. import roofline


def read(name, view):
    return roofline.share(view.work.get("duplex"), view.trace and view.trace.kernel_s)
