"""Frames the CRF duplex stream hands its decoder a real frame: the
program's counters ``decode_many_crf_duplex.batch_frames`` (both reads of
every pair at its bucket's edges) over ``decode_many_crf_duplex.frames``
(both reads' own frames); 1 where nothing is padded.  None where the
program counts neither (a program without the counters)."""


def read(name, view):
    batch = view.counters.get("decode_many_crf_duplex.batch_frames")
    frames = view.counters.get("decode_many_crf_duplex.frames")
    if not batch or not frames:
        return None
    return batch / frames
