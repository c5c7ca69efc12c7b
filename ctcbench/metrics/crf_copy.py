"""Bytes the CRF stream copies into its batch buffers a frame decoded: the
program's counters ``decode_many_crf.moved_bytes`` over
``decode_many_crf.frames`` (``crf_copy.bytes_per_frame``); None where the
program counts neither (a program without the counters)."""


def read(name, view):
    moved = view.counters.get("decode_many_crf.moved_bytes")
    frames = view.counters.get("decode_many_crf.frames")
    if not moved or not frames:
        return None
    return moved / frames
