"""Share of the window in the program's padding of reads into bucket
batches (its ``decode_many.pad`` / ``decode_many_duplex.pad`` span)."""


def read(name, view):
    return view.stage_share("pad")
