"""The CRF beam decode's bound (``roofline_crf.crf_work``) over the device
time of every kernel in the traced window."""

from .. import roofline_crf


def read(name, view):
    return roofline_crf.share(view.work.get("crf"), view.trace and view.trace.kernel_s)
