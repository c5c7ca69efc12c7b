"""The card's name and power limit, as ``nvidia-smi`` reads them (copied from
the port's ``tools/workloads.py::card_info``)."""

from __future__ import annotations

import subprocess


def card_info(device):
    """``(name, power limit)`` of CUDA ``device``; torch's name and None where
    ``nvidia-smi`` does not answer."""
    import torch

    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        name, power = (s.strip() for s in line.rsplit(",", 1))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return torch.cuda.get_device_name(device), None
    return name, power
