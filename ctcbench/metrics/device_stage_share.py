"""Share of the window in the program's device stage (its ``beam.device``
span: the kernels and the copy home; ``duplex.device``: host preparation,
kernels and the copy home)."""


def read(name, view):
    return view.stage_share("device")
