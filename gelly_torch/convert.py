"""Carry summary state across the two packages as numpy arrays.

``gelly_tpu``'s summaries, taken to numpy with ``np.asarray``, become the
port's on a device and back — so both packages can continue one stream
from the same mid-stream state:

- ``CCSummary`` (``parent`` i32, ``seen`` bool) and ``CCCompactSummary``
  (``croot`` i32, ``vertex_of`` i32);
- ``ParityForest`` (``parent`` i32, ``rel`` i32, ``failed`` 0-d bool) and
  ``BipartiteSummary`` (its forest, ``seen`` bool);
- the degree vector (``int64[n]``).

Dtypes and shapes are checked, never widened or narrowed silently.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import DEFAULT_DEVICE, resolve_device, to_numpy
from .library.bipartiteness import BipartiteSummary
from .library.connected_components import CCCompactSummary, CCSummary
from .ops.parity_unionfind import ParityForest


_I32, _BOOL, _I64 = np.int32, np.bool_, np.int64


def _tensors(device, spec: dict, **arrays) -> list[torch.Tensor]:
    """Each array checked against its ``(dtype, ndim)`` in ``spec`` (the
    1D ones of one length) and copied to a tensor on ``device``."""
    checked, lengths = [], {}
    for name, a in arrays.items():
        a = np.asarray(a)
        dtype, ndim = spec[name]
        if a.dtype != dtype:
            raise TypeError(
                f"{name} must be {np.dtype(dtype)}, got {a.dtype}")
        if a.ndim != ndim:
            raise ValueError(f"{name} {a.shape} must be {ndim}-d")
        if ndim == 1:
            lengths[name] = a.shape[0]
        checked.append(a)
    if len(set(lengths.values())) > 1:
        raise ValueError(f"{', '.join(lengths)} must be of one length, got "
                         f"{list(lengths.values())}")
    dev = resolve_device(device)
    return [torch.from_numpy(a.copy()).to(dev) for a in checked]


def cc_summary_from_numpy(parent, seen,
                          device: torch.device | str = DEFAULT_DEVICE
                          ) -> CCSummary:
    return CCSummary(*_tensors(device, {"parent": (_I32, 1),
                                        "seen": (_BOOL, 1)},
                               parent=parent, seen=seen))


def cc_summary_to_numpy(summary: CCSummary) -> tuple[np.ndarray, np.ndarray]:
    return to_numpy(summary.parent), to_numpy(summary.seen)


def cc_compact_summary_from_numpy(croot, vertex_of,
                                  device: torch.device | str = DEFAULT_DEVICE
                                  ) -> CCCompactSummary:
    return CCCompactSummary(*_tensors(
        device, {"croot": (_I32, 1), "vertex_of": (_I32, 1)},
        croot=croot, vertex_of=vertex_of))


def cc_compact_summary_to_numpy(summary: CCCompactSummary
                                ) -> tuple[np.ndarray, np.ndarray]:
    return to_numpy(summary.croot), to_numpy(summary.vertex_of)


_FOREST = {"parent": (_I32, 1), "rel": (_I32, 1), "failed": (_BOOL, 0)}


def parity_forest_from_numpy(parent, rel, failed,
                             device: torch.device | str = DEFAULT_DEVICE
                             ) -> ParityForest:
    return ParityForest(*_tensors(device, _FOREST, parent=parent, rel=rel,
                                  failed=failed))


def parity_forest_to_numpy(forest: ParityForest
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return (to_numpy(forest.parent), to_numpy(forest.rel),
            to_numpy(forest.failed))


def bipartite_summary_from_numpy(parent, rel, failed, seen,
                                 device: torch.device | str = DEFAULT_DEVICE
                                 ) -> BipartiteSummary:
    p, r, f, s = _tensors(device, {**_FOREST, "seen": (_BOOL, 1)},
                          parent=parent, rel=rel, failed=failed, seen=seen)
    return BipartiteSummary(ParityForest(p, r, f), s)


def bipartite_summary_to_numpy(summary: BipartiteSummary
                               ) -> tuple[np.ndarray, ...]:
    return (*parity_forest_to_numpy(summary.forest), to_numpy(summary.seen))


def degrees_from_numpy(deg, device: torch.device | str = DEFAULT_DEVICE
                       ) -> torch.Tensor:
    return _tensors(device, {"deg": (_I64, 1)}, deg=deg)[0]


def degrees_to_numpy(deg: torch.Tensor) -> np.ndarray:
    return to_numpy(deg)
