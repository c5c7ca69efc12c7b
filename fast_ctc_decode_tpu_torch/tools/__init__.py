"""Measurement tools of the port, run with ``python -m``: the A/B bench of the
beam kernel versions (``ab_bench``) and the phase ablation (``kernel_ablate``)."""
