"""Carry CC state across the two packages as numpy arrays.

``gelly_tpu``'s ``CCSummary`` leaves (``parent`` i32, ``seen`` bool, taken
to numpy with ``np.asarray``) become the port's :class:`CCSummary` on a
device and back — so both packages can continue one stream from the same
mid-stream forest. Dtypes are checked, never widened or narrowed silently.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import DEFAULT_DEVICE, resolve_device, to_numpy
from .library.connected_components import CCSummary


def cc_summary_from_numpy(parent, seen,
                          device: torch.device | str = DEFAULT_DEVICE
                          ) -> CCSummary:
    parent = np.asarray(parent)
    seen = np.asarray(seen)
    if parent.dtype != np.int32 or seen.dtype != np.bool_:
        raise TypeError(
            f"CCSummary leaves are i32 parent and bool seen, got "
            f"{parent.dtype} and {seen.dtype}"
        )
    if parent.shape != seen.shape or parent.ndim != 1:
        raise ValueError(
            f"parent {parent.shape} and seen {seen.shape} must be equal 1D"
        )
    dev = resolve_device(device)
    return CCSummary(
        parent=torch.from_numpy(parent.copy()).to(dev),
        seen=torch.from_numpy(seen.copy()).to(dev),
    )


def cc_summary_to_numpy(summary: CCSummary) -> tuple[np.ndarray, np.ndarray]:
    return to_numpy(summary.parent), to_numpy(summary.seen)
