"""Device selection: the port's entry points run on the card unless the
caller asks for the CPU."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises ``RuntimeError`` when CUDA is absent and the caller did not name
    a device: a run meant for the card never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain torch path"
        )
    return torch.device("cuda")
