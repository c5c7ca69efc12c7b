"""Measurement tools of the port, run with ``python -m``: the kernel probes
(``ab_bench``, ``kernel_ablate``, ``exact_probe``, ``kernel_probe``) and the
counterparts of the JAX package's tools (``benchmark``, ``bench_exact_duplex``,
``scaling_bench``; their shared inputs in ``workloads``)."""
