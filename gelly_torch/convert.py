"""Carry summary state across the two packages as numpy arrays.

``gelly_tpu``'s summaries, taken to numpy with ``np.asarray``, become the
port's on a device and back — so both packages can continue one stream
from the same mid-stream state:

- ``CCSummary`` (``parent`` i32, ``seen`` bool) and ``CCCompactSummary``
  (``croot`` i32, ``vertex_of`` i32);
- ``ParityForest`` (``parent`` i32, ``rel`` i32, ``failed`` 0-d bool) and
  ``BipartiteSummary`` (its forest, ``seen`` bool);
- the degree vector (``int64[n]``);
- ``SpannerSummary`` (``adj`` bool[N, N], ``esrc``/``edst`` i32, ``n``
  0-d i32, ``overflow`` 0-d bool) and ``SparseSpannerSummary`` (``nbr``
  i32[N, D], ``deg`` i32, ``esrc``/``edst`` i32, ``n``, ``overflow``,
  ``deg_overflow`` 0-d i32);
- the device matching state ``MatchingState`` (``partner`` i32,
  ``weight`` f32);
- the device hash set ``HashSetState`` (``keys`` i64[2^k], ``count`` 0-d
  i32);
- the windowed compact plan's pane ``CCWindowPane`` (``croot`` i32,
  ``vertex_of`` i32, ``touched`` bool);
- the capped-degree row table of ``NeighborhoodStream`` as the tuple
  ``(nbr, deg, over)`` (``nbr`` i32[N, D], ``deg`` i32[N], ``over`` 0-d
  i32);
- the exact triangle counts ``TriangleCounts`` (``adj`` i32[N, N],
  ``counts`` i64, ``total`` 0-d i64, ``n_seen`` 0-d i32) and
  ``SparseTriangleCounts`` (``nbr``/``aidx`` i32[N, D], ``deg`` i32,
  ``counts`` i64, ``total`` 0-d i64, ``n_seen``/``overflow`` 0-d i32);
- the sampled estimator's ``SamplerState`` (``src``/``trg``/``third``/
  ``v_at`` i32[S], ``src_found``/``trg_found`` bool[S], ``edge_count``
  0-d i32, ``keys`` as JAX holds them: u32[S, 2] bit patterns, which the
  port keeps as ``int64`` values).

Sharded state (a mesh of S shards): ``gelly_tpu``'s ``P("shards")`` array,
taken to numpy as ``[S, ...]``, is the port's list of S per-shard tensors
(:func:`shards_from_numpy` / :func:`shards_to_numpy`, and per summary
:func:`sharded_summaries_from_numpy` for the engine's ``[S]`` locals);
``ShardedCC`` (``parent`` i32, ``seen`` / ``dirty`` bool stripes plus the
host root and seen caches), the ``ShardedDegrees`` stripes (``int64``) and
``ShardedExactTriangles`` (``nbr`` / ``aidx`` i32 ``[S, per, D]``, ``deg``
i32 and ``counts`` i64 stripes, and its host counters) carry both ways.

Dtypes and shapes are checked, never widened or narrowed silently.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import DEFAULT_DEVICE, resolve_device, to_numpy
from .library.bipartiteness import BipartiteSummary
from .library.connected_components import (
    CCCompactSummary,
    CCSummary,
    CCWindowPane,
)
from .library.matching import MatchingState
from .library.spanner import SparseSpannerSummary, SpannerSummary
from .library.triangles import (
    SamplerState,
    SparseTriangleCounts,
    TriangleCounts,
)
from .ops.hashset import HashSetState
from .ops.parity_unionfind import ParityForest


_I32, _BOOL, _I64, _F32 = np.int32, np.bool_, np.int64, np.float32


# 1-D fields whose length is not the slot count (checked apart).
_OWN_LENGTH = ("esrc", "edst")


def _tensors(device, spec: dict, **arrays) -> list[torch.Tensor]:
    """Each array checked against its ``(dtype, ndim)`` in ``spec`` (the
    1D ones of one length, the edge lists apart) and copied to a tensor on
    ``device``."""
    checked, lengths = [], {}
    for name, a in arrays.items():
        a = np.asarray(a)
        dtype, ndim = spec[name]
        if a.dtype != dtype:
            raise TypeError(
                f"{name} must be {np.dtype(dtype)}, got {a.dtype}")
        if a.ndim != ndim:
            raise ValueError(f"{name} {a.shape} must be {ndim}-d")
        if ndim == 1 and name not in _OWN_LENGTH:
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


def _edge_list(esrc, edst) -> None:
    if np.shape(esrc) != np.shape(edst):
        raise ValueError(f"esrc {np.shape(esrc)} and edst {np.shape(edst)} "
                         "must be of one length")


_LIST = {"esrc": (_I32, 1), "edst": (_I32, 1), "n": (_I32, 0),
         "overflow": (_BOOL, 0)}


def spanner_summary_from_numpy(adj, esrc, edst, n, overflow,
                               device: torch.device | str = DEFAULT_DEVICE
                               ) -> SpannerSummary:
    _edge_list(esrc, edst)
    return SpannerSummary(*_tensors(
        device, {"adj": (_BOOL, 2), **_LIST}, adj=adj, esrc=esrc, edst=edst,
        n=n, overflow=overflow))


def spanner_summary_to_numpy(summary: SpannerSummary
                             ) -> tuple[np.ndarray, ...]:
    return tuple(to_numpy(x) for x in summary)


def _row_count(nbr, deg) -> None:
    if np.shape(nbr)[:1] != np.shape(deg):
        raise ValueError(f"nbr {np.shape(nbr)} and deg {np.shape(deg)} "
                         "must have one row count")


def sparse_spanner_summary_from_numpy(
        nbr, deg, esrc, edst, n, overflow, deg_overflow,
        device: torch.device | str = DEFAULT_DEVICE) -> SparseSpannerSummary:
    _edge_list(esrc, edst)
    _row_count(nbr, deg)
    return SparseSpannerSummary(*_tensors(
        device, {"nbr": (_I32, 2), "deg": (_I32, 1), **_LIST,
                 "deg_overflow": (_I32, 0)},
        nbr=nbr, deg=deg, esrc=esrc, edst=edst, n=n, overflow=overflow,
        deg_overflow=deg_overflow))


def sparse_spanner_summary_to_numpy(summary: SparseSpannerSummary
                                    ) -> tuple[np.ndarray, ...]:
    return tuple(to_numpy(x) for x in summary)


def matching_state_from_numpy(partner, weight,
                              device: torch.device | str = DEFAULT_DEVICE
                              ) -> MatchingState:
    """The device path's state (``weight`` f32, as JAX's device path)."""
    return MatchingState(*_tensors(
        device, {"partner": (_I32, 1), "weight": (_F32, 1)},
        partner=partner, weight=weight))


def matching_state_to_numpy(state: MatchingState
                            ) -> tuple[np.ndarray, np.ndarray]:
    return to_numpy(state.partner), to_numpy(state.weight)


def hashset_state_from_numpy(keys, count,
                             device: torch.device | str = DEFAULT_DEVICE
                             ) -> HashSetState:
    """``keys`` keeps its slot layout, so probes continue where the other
    package left them; its length must be a power of two."""
    cap = np.shape(keys)[0] if np.ndim(keys) == 1 else 0
    if cap < 1 or cap & (cap - 1):
        raise ValueError(f"keys {np.shape(keys)} must be 1-d of a power-of-"
                         "two length")
    return HashSetState(*_tensors(
        device, {"keys": (_I64, 1), "count": (_I32, 0)},
        keys=keys, count=count))


def hashset_state_to_numpy(state: HashSetState
                           ) -> tuple[np.ndarray, np.ndarray]:
    return to_numpy(state.keys), to_numpy(state.count)


def cc_window_pane_from_numpy(croot, vertex_of, touched,
                              device: torch.device | str = DEFAULT_DEVICE
                              ) -> CCWindowPane:
    return CCWindowPane(*_tensors(
        device, {"croot": (_I32, 1), "vertex_of": (_I32, 1),
                 "touched": (_BOOL, 1)},
        croot=croot, vertex_of=vertex_of, touched=touched))


def cc_window_pane_to_numpy(pane: CCWindowPane) -> tuple[np.ndarray, ...]:
    return tuple(to_numpy(x) for x in pane)


def row_table_from_numpy(nbr, deg, over,
                         device: torch.device | str = DEFAULT_DEVICE
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``NeighborhoodStream``'s capped-degree rows (``-1`` free) with the
    degrees and the overflow count."""
    _row_count(nbr, deg)
    return tuple(_tensors(
        device, {"nbr": (_I32, 2), "deg": (_I32, 1), "over": (_I32, 0)},
        nbr=nbr, deg=deg, over=over))


def row_table_to_numpy(nbr: torch.Tensor, deg: torch.Tensor,
                       over: torch.Tensor) -> tuple[np.ndarray, ...]:
    return to_numpy(nbr), to_numpy(deg), to_numpy(over)


def triangle_counts_from_numpy(adj, counts, total, n_seen,
                               device: torch.device | str = DEFAULT_DEVICE
                               ) -> TriangleCounts:
    """The dense exact stream's state (``adj`` holds arrival indices,
    ``INT_MAX`` where absent)."""
    if np.ndim(adj) != 2 or np.shape(adj)[0] != np.shape(adj)[1]:
        raise ValueError(f"adj {np.shape(adj)} must be square")
    return TriangleCounts(*_tensors(
        device, {"adj": (_I32, 2), "counts": (_I64, 1), "total": (_I64, 0),
                 "n_seen": (_I32, 0)},
        adj=adj, counts=counts, total=total, n_seen=n_seen))


def triangle_counts_to_numpy(state: TriangleCounts
                             ) -> tuple[np.ndarray, ...]:
    return tuple(to_numpy(x) for x in state)


def sparse_triangle_counts_from_numpy(
        nbr, aidx, deg, counts, total, n_seen, overflow,
        device: torch.device | str = DEFAULT_DEVICE) -> SparseTriangleCounts:
    """The capped-degree exact stream's state (``nbr`` -1 and ``aidx``
    ``INT_MAX`` where a row slot is free)."""
    if np.shape(nbr) != np.shape(aidx):
        raise ValueError(f"nbr {np.shape(nbr)} and aidx {np.shape(aidx)} "
                         "differ")
    _row_count(nbr, deg)
    return SparseTriangleCounts(*_tensors(
        device, {"nbr": (_I32, 2), "aidx": (_I32, 2), "deg": (_I32, 1),
                 "counts": (_I64, 1), "total": (_I64, 0),
                 "n_seen": (_I32, 0), "overflow": (_I32, 0)},
        nbr=nbr, aidx=aidx, deg=deg, counts=counts, total=total,
        n_seen=n_seen, overflow=overflow))


def sparse_triangle_counts_to_numpy(state: SparseTriangleCounts
                                    ) -> tuple[np.ndarray, ...]:
    return tuple(to_numpy(x) for x in state)


def sampler_state_from_numpy(src, trg, third, src_found, trg_found, v_at,
                             edge_count, keys,
                             device: torch.device | str = DEFAULT_DEVICE
                             ) -> SamplerState:
    """``keys`` are JAX's ``uint32 [S, 2]`` key data; the port holds them
    as ``int64`` values."""
    keys = np.asarray(keys)
    if keys.dtype != np.uint32 or keys.shape != (np.shape(src)[0], 2):
        raise TypeError(f"keys must be uint32 [S, 2], got {keys.dtype} "
                        f"{keys.shape}")
    fields = _tensors(
        device, {"src": (_I32, 1), "trg": (_I32, 1), "third": (_I32, 1),
                 "src_found": (_BOOL, 1), "trg_found": (_BOOL, 1),
                 "v_at": (_I32, 1), "edge_count": (_I32, 0)},
        src=src, trg=trg, third=third, src_found=src_found,
        trg_found=trg_found, v_at=v_at, edge_count=edge_count)
    return SamplerState(*fields, torch.from_numpy(
        keys.astype(np.int64)).to(resolve_device(device)))


def sampler_state_to_numpy(state: SamplerState) -> tuple[np.ndarray, ...]:
    """The state's fields, ``keys`` back as ``uint32`` bit patterns."""
    out = [to_numpy(x) for x in state]
    out[7] = out[7].astype(np.uint32)
    return tuple(out)


# --------------------------------------------------------------------- #
# sharded state


def shards_from_numpy(stacked, mesh, dtype=None) -> list[torch.Tensor]:
    """A ``[S, ...]`` array (``np.asarray`` of a ``P("shards")`` array) as
    S per-shard tensors, shard ``i`` on ``mesh.devices[i]``."""
    a = np.asarray(stacked)
    S = len(mesh.devices)
    if a.ndim < 1 or a.shape[0] != S:
        raise ValueError(f"sharded array {a.shape} must lead with {S} "
                         f"shards")
    if dtype is not None and a.dtype != dtype:
        raise TypeError(f"sharded array must be {np.dtype(dtype)}, got "
                        f"{a.dtype}")
    return [torch.from_numpy(a[i].copy()).to(dev)
            for i, dev in enumerate(mesh.devices)]


def shards_to_numpy(shards: list) -> np.ndarray:
    """S per-shard tensors as one ``[S, ...]`` array."""
    return np.stack([to_numpy(x) for x in shards])


def sharded_summaries_from_numpy(from_numpy, mesh, *stacked) -> list:
    """Per-shard summaries of the engine's ``[S]`` locals: ``from_numpy``
    (e.g. :func:`cc_summary_from_numpy`) applied to each shard's row of
    every ``[S, ...]`` leaf, on that shard's device."""
    S = len(mesh.devices)
    arrays = [np.asarray(x) for x in stacked]
    for a in arrays:
        if a.shape[:1] != (S,):
            raise ValueError(f"sharded leaf {a.shape} must lead with {S} "
                             f"shards")
    return [from_numpy(*(a[i] for a in arrays), device=dev)
            for i, dev in enumerate(mesh.devices)]


def sharded_summaries_to_numpy(to_numpy_fn, summaries: list) -> tuple:
    """The per-shard summaries' leaves stacked to ``[S, ...]`` arrays."""
    rows = [to_numpy_fn(s) for s in summaries]
    return tuple(np.stack(leaf) for leaf in zip(*rows))


def sharded_cc_to_numpy(cc) -> dict:
    """A ``ShardedCC``'s state: ``parent`` i32 / ``seen`` / ``dirty`` bool
    ``[S, per]`` stripes, and the host ``rootcache`` i32 / ``seencache``
    bool ``[n]`` of its last emission. Reads either package's instance."""
    def stripes(x):
        return (shards_to_numpy(x) if isinstance(x, list)
                else np.asarray(x))

    return {"parent": stripes(cc.parent), "seen": stripes(cc.seen),
            "dirty": stripes(cc.dirty),
            "rootcache": np.asarray(cc._rootcache).copy(),
            "seencache": np.asarray(cc._seencache).copy()}


def sharded_cc_from_numpy(cc, parent, seen, dirty, rootcache,
                          seencache) -> None:
    """Load :func:`sharded_cc_to_numpy`'s arrays (from either package)
    into the port's ``ShardedCC`` ``cc`` on its mesh."""
    S, per, n = cc.S, cc.per, cc.n
    for name, a, dt in (("parent", parent, _I32), ("seen", seen, _BOOL),
                        ("dirty", dirty, _BOOL)):
        if np.shape(a) != (S, per):
            raise ValueError(f"{name} {np.shape(a)} must be {(S, per)}")
    for name, a, dt in (("rootcache", rootcache, _I32),
                        ("seencache", seencache, _BOOL)):
        if np.asarray(a).dtype != dt or np.shape(a) != (n,):
            raise TypeError(f"{name} must be {np.dtype(dt)}[{n}]")
    cc.parent = shards_from_numpy(parent, cc.mesh, _I32)
    cc.seen = shards_from_numpy(seen, cc.mesh, _BOOL)
    cc.dirty = shards_from_numpy(dirty, cc.mesh, _BOOL)
    cc._rootcache = np.asarray(rootcache).copy()
    cc._seencache = np.asarray(seencache).copy()


def sharded_exact_to_numpy(t) -> dict:
    """A ``ShardedExactTriangles``' state: ``nbr`` / ``aidx`` i32 ``[S,
    per, D]``, ``deg`` i32 / ``counts`` i64 ``[S, per]`` stripes, and its
    host ``total`` / ``n_seen`` / ``overflow`` counters. Reads either
    package's instance."""
    def stripes(x):
        return (shards_to_numpy(x) if isinstance(x, list)
                else np.asarray(x))

    return {"nbr": stripes(t.nbr), "aidx": stripes(t.aidx),
            "deg": stripes(t.deg), "counts": stripes(t.counts),
            "total": int(t.total), "n_seen": int(t.n_seen),
            "overflow": int(t.overflow)}


def sharded_exact_from_numpy(t, nbr, aidx, deg, counts, total: int,
                             n_seen: int, overflow: int) -> None:
    """Load :func:`sharded_exact_to_numpy`'s state into the port's
    ``ShardedExactTriangles`` ``t`` on its mesh."""
    S, per, D = t.S, t.per, t.D
    for name, a, shape in (("nbr", nbr, (S, per, D)),
                           ("aidx", aidx, (S, per, D)),
                           ("deg", deg, (S, per)),
                           ("counts", counts, (S, per))):
        if np.shape(a) != shape:
            raise ValueError(f"{name} {np.shape(a)} must be {shape}")
    t.nbr = shards_from_numpy(nbr, t.mesh, _I32)
    t.aidx = shards_from_numpy(aidx, t.mesh, _I32)
    t.deg = shards_from_numpy(deg, t.mesh, _I32)
    t.counts = shards_from_numpy(counts, t.mesh, _I64)
    t.total, t.n_seen, t.overflow = int(total), int(n_seen), int(overflow)
