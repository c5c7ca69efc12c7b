"""The device an entry point runs on.

Every entry point of the port (the single-read API, the batch decoders, the
``decode_many*`` streams, ``decode_and_count`` and the service) takes
``device=None``, which means the CUDA card.  Without one, the default raises:
it never runs on the CPU quietly.  ``device="cpu"`` asks for the plain
PyTorch engines on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is ``torch.device("cuda")``, and
    raises RuntimeError when no CUDA device is available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the entry points run on the card by "
                "default; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def with_index(device: torch.device) -> torch.device:
    """``device`` with its card index: an index-less ``cuda`` becomes the
    current card (``torch.cuda.set_device`` and comparisons need one)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
