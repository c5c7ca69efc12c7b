"""The CRF duplex decode's bound (``roofline_crf_duplex.crf_duplex_work``)
over the device time of every kernel in the traced window."""

from .. import roofline_crf_duplex


def read(name, view):
    return roofline_crf_duplex.share(view.work.get("crf_duplex"),
                                     view.trace and view.trace.kernel_s)
