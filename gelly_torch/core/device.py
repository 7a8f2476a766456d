"""Device resolution shared by every entry point of the port.

``gelly_torch`` runs on a CUDA device unless the caller asks for another
one (the CPU tests pass ``device="cpu"``). A default CUDA request on a
machine without a card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises if it asks for CUDA and the
    machine has no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gelly_torch runs on a CUDA device by default and this machine "
            "has none; pass device='cpu' to run on the CPU"
        )
    return dev


def to_numpy(x) -> np.ndarray:
    """Host numpy view/copy of a tensor on any device (or an array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
