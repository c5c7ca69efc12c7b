"""Share of the window in the program's host assembly of results (its
``beam.detok`` span: device results to strings and paths)."""


def read(name, view):
    return view.stage_share("detok")
