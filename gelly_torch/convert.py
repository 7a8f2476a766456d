"""Carry CC state across the two packages as numpy arrays.

``gelly_tpu``'s ``CCSummary`` leaves (``parent`` i32, ``seen`` bool) and
``CCCompactSummary`` leaves (``croot`` i32, ``vertex_of`` i32), taken to
numpy with ``np.asarray``, become the port's summaries on a device and
back — so both packages can continue one stream from the same mid-stream
forest. Dtypes are checked, never widened or narrowed silently.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import DEFAULT_DEVICE, resolve_device, to_numpy
from .library.connected_components import CCCompactSummary, CCSummary


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


def cc_compact_summary_from_numpy(croot, vertex_of,
                                  device: torch.device | str = DEFAULT_DEVICE
                                  ) -> CCCompactSummary:
    croot = np.asarray(croot)
    vertex_of = np.asarray(vertex_of)
    if croot.dtype != np.int32 or vertex_of.dtype != np.int32:
        raise TypeError(
            f"CCCompactSummary leaves are i32 croot and i32 vertex_of, got "
            f"{croot.dtype} and {vertex_of.dtype}"
        )
    if croot.shape != vertex_of.shape or croot.ndim != 1:
        raise ValueError(
            f"croot {croot.shape} and vertex_of {vertex_of.shape} must be "
            "equal 1D"
        )
    dev = resolve_device(device)
    return CCCompactSummary(
        croot=torch.from_numpy(croot.copy()).to(dev),
        vertex_of=torch.from_numpy(vertex_of.copy()).to(dev),
    )


def cc_compact_summary_to_numpy(summary: CCCompactSummary
                                ) -> tuple[np.ndarray, np.ndarray]:
    return to_numpy(summary.croot), to_numpy(summary.vertex_of)
