"""Per-layer metric readers: ``<family>.py`` reads every metric whose name
starts with ``<family>``.  Each exposes ``read(name, view)`` over a
``harness.LayerView`` and returns a number, or None where the run has
nothing for it to read (the metric is then left out of the line)."""
