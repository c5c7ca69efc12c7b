"""The benchmark of ``fast_ctc_decode_tpu_torch``, the PyTorch and CUDA port.

``python3 -m ctcbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the decode settings and the posterior law;
- ``traffic/<traffic>.json``: a traffic mix, data only; its ``kind`` names
  the driver that runs it, ``drivers/<kind>.py``;
- ``metrics/<family>.py``: the reader of the per-layer metrics whose name
  starts with ``<family>`` (up to the first dot);
- ``gen/``: the seeded generators; ``reference/``: the plain reference;
  ``roofline.py``: the card's peaks and the decode's work.

This package never imports JAX or the JAX package, and imports the port
only from the drivers, the metric of program spans and ``run.py``.
"""
