"""Streaming Connected Components — the raw device-fold plan.

Counterpart of ``gelly_tpu/library/connected_components.py`` for the plan
without the ingest codec (``ingest_combine=False``): each raw chunk folds
into a dense ``i32 parent[]`` forest plus a ``bool seen[]`` mask, and every
emitted window is the canonical label array (minimum vertex slot of each
component, ``-1`` for slots never seen). Chunks of at least
:data:`RAW_DEDUP_MIN_CHUNK` edges take the sort-dedup fold
(:func:`~gelly_torch.ops.unionfind.union_edges_dedup`), whose
``fold_backend="kernel"`` runs the hand-written ``sorted_window_gather``;
smaller chunks take the generic :func:`~gelly_torch.ops.unionfind.union_edges`.

The codec plans (``ingest_combine=True``: dense, sparse and compact) come
with the next slice; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import to_numpy
from ..engine.aggregation import SummaryAggregation
from ..ops import segments, unionfind


class CCSummary(NamedTuple):
    parent: torch.Tensor  # i32[N] union-find forest (canonical min-root)
    seen: torch.Tensor  # bool[N] vertices observed in the stream


# Raw folds switch from the generic union_edges fixpoint to the sort-dedup
# fold at this chunk size: below it the dedup sorts cost more than the
# rounds they save. Read at fold time, so it can be patched per run.
RAW_DEDUP_MIN_CHUNK = 1 << 22

_CODEC_ITEM = "ROADMAP.md queue 1 items 3 and 5 (compact plan and host codec)"


def cc_labels_numpy(src: np.ndarray, dst: np.ndarray,
                    valid: np.ndarray | None, n_v: int) -> np.ndarray:
    """Pure-numpy spanning-forest labels i32[n_v] of one chunk (-1 for
    untouched slots) — a copy of ``gelly_tpu``'s oracle."""
    if valid is not None:
        m = np.asarray(valid, bool)
        src, dst = np.asarray(src)[m], np.asarray(dst)[m]
    lab = np.full((n_v,), -1, np.int32)
    if src.size == 0:
        return lab
    touched = np.zeros((n_v,), bool)
    touched[src] = True
    touched[dst] = True
    lab[touched] = np.nonzero(touched)[0].astype(np.int32)
    while True:
        prev = lab.copy()
        mn = np.minimum(lab[src], lab[dst]).astype(np.int32)
        np.minimum.at(lab, src, mn)
        np.minimum.at(lab, dst, mn)
        t = np.nonzero(touched)[0]
        lab[t] = np.minimum(lab[t], lab[lab[t]])
        if np.array_equal(lab, prev):
            break
    return lab


def cc_pairs_numpy(src: np.ndarray, dst: np.ndarray,
                   valid: np.ndarray | None, n_v: int):
    """Pure-numpy counted (vertex, root) pairs of one chunk's spanning
    forest — a copy of ``gelly_tpu``'s sparse-combiner fallback."""
    if valid is not None:
        m = np.asarray(valid, bool)
        src, dst = np.asarray(src)[m], np.asarray(dst)[m]
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.size == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    ids = np.unique(np.concatenate([src, dst]))
    if ids[0] < 0 or ids[-1] >= n_v:
        raise ValueError("cc_pairs_numpy: vertex slot out of range")
    ls = np.searchsorted(ids, src)
    ld = np.searchsorted(ids, dst)
    lab = np.arange(ids.shape[0], dtype=np.int64)
    while True:
        prev = lab
        mn = np.minimum(lab[ls], lab[ld])
        lab = lab.copy()
        np.minimum.at(lab, ls, mn)
        np.minimum.at(lab, ld, mn)
        lab = np.minimum(lab, lab[lab])
        if np.array_equal(lab, prev):
            break
    return ids.astype(np.int32), ids[lab].astype(np.int32)


def resolve_merge_mode(merge_mode: str) -> str:
    """Validate the cross-device merge knob (``"auto"``/``"delta"``/
    ``"replicated"``). It shapes only multi-device merges, which this
    slice's one-device engine never runs."""
    if merge_mode not in ("auto", "delta", "replicated"):
        raise ValueError(
            f"merge_mode must be auto/delta/replicated, got {merge_mode!r}"
        )
    return merge_mode


def resolve_fold_backend(fold_backend: str, vertex_capacity: int) -> str:
    """Validate and resolve ``"auto"``/``"plain"``/``"kernel"`` for the raw
    device fold. ``"auto"`` resolves to ``"plain"`` (as the reference's
    resolves to ``"xla"``); ``"kernel"`` checks the capacity against the
    gather's window blocking at plan-build time."""
    if fold_backend not in ("auto", "plain", "kernel"):
        raise ValueError(
            f"fold_backend must be auto/plain/kernel, got {fold_backend!r}"
        )
    if fold_backend == "kernel":
        from ..ops.kernels import gatherable

        if not gatherable(vertex_capacity):
            raise ValueError(
                f"fold_backend='kernel' needs a window-blockable vertex "
                f"capacity (multiple of 128 lanes spanning >= 2 windows, "
                f"<= 2^24); got {vertex_capacity}"
            )
        return "kernel"
    return "plain"


def connected_components(
    vertex_capacity: int, merge: str = "tree", ingest_combine: bool = True,
    codec: str = "auto", compact_capacity: int | None = None,
    fold_backend: str = "auto", merge_mode: str = "auto",
    delta_auto_rows: int | None = None,
    windowed: int | None = None, ttl_panes: int | None = None,
) -> SummaryAggregation:
    """Build the CC aggregation over a slot space of ``vertex_capacity``.

    Same signature as ``gelly_tpu``'s. This slice builds the raw plan only:
    ``ingest_combine=False`` with ``codec="auto"``; ``merge`` is
    ``"tree"`` or ``"gather"`` (it shapes the ``combine``/``merge_stacked``
    the plan exports). ``fold_backend`` (:func:`resolve_fold_backend`)
    picks the sort-dedup fold's gather: ``"kernel"`` for the hand-written
    CUDA ``sorted_window_gather``, ``"plain"``/``"auto"`` for plain
    PyTorch gathers. The codec plans and the windowed/TTL/delta knobs
    raise ``NotImplementedError``.
    """
    if ingest_combine or codec != "auto" or compact_capacity is not None:
        raise NotImplementedError(
            "connected_components: only the raw plan (ingest_combine=False, "
            f"codec='auto') is ported; the codec plans are {_CODEC_ITEM}"
        )
    if windowed is not None or ttl_panes is not None:
        raise NotImplementedError(
            "connected_components(windowed=/ttl_panes=) is not ported yet: "
            "ROADMAP.md queue 1 item 10 (stream API and windows)"
        )
    if delta_auto_rows is not None:
        raise NotImplementedError(
            "connected_components(delta_auto_rows=) is not ported yet: "
            "ROADMAP.md queue 1 item 8 (multi-GPU merge)"
        )
    if merge not in ("tree", "gather"):
        raise ValueError(f"merge must be tree/gather, got {merge!r}")
    resolve_merge_mode(merge_mode)
    n = vertex_capacity
    backend = resolve_fold_backend(fold_backend, n)

    def init(device) -> CCSummary:
        return CCSummary(
            parent=unionfind.fresh_forest(n, device),
            seen=torch.zeros(n, dtype=torch.bool, device=device),
        )

    def fold(s: CCSummary, chunk) -> CCSummary:
        if chunk.capacity >= RAW_DEDUP_MIN_CHUNK:
            # Large-chunk raw path: sort-dedup + verified hook rounds +
            # compacted exact tail. 3/16 of the chunk covers the
            # distinct-pair counts of power-law streams; overflow only
            # costs speed (exact full-width fallback).
            parent = unionfind.union_edges_dedup(
                s.parent, chunk.src, chunk.dst, chunk.valid,
                unique_cap=max(1 << 20, 3 * (chunk.capacity >> 4)),
                backend=backend,
            )
        else:
            parent = unionfind.union_edges(
                s.parent, chunk.src, chunk.dst, chunk.valid
            )
        seen = segments.mark_seen(s.seen, chunk.src, chunk.valid)
        seen = segments.mark_seen(seen, chunk.dst, chunk.valid)
        return CCSummary(parent, seen)

    def combine(a: CCSummary, b: CCSummary) -> CCSummary:
        return CCSummary(
            parent=unionfind.merge_forests(a.parent, b.parent),
            seen=a.seen | b.seen,
        )

    def merge_stacked(st: CCSummary) -> CCSummary:
        return CCSummary(
            parent=unionfind.merge_forest_stack(st.parent),
            seen=st.seen.any(dim=0),
        )

    def transform(s: CCSummary) -> torch.Tensor:
        return unionfind.component_labels(s.parent, s.seen)

    def flatten(s: CCSummary) -> CCSummary:
        # Label-preserving: pointer_jump only shortcuts chains.
        return CCSummary(unionfind.pointer_jump(s.parent), s.seen)

    return SummaryAggregation(
        init=init,
        fold=fold,
        combine=combine,
        transform=transform,
        merge_stacked=merge_stacked if merge == "gather" else None,
        transient=False,
        flatten=flatten,
        fold_accumulates=True,  # CC forests are pure edge-set summaries
        fold_backend=backend,
        name=f"connected-components-{merge}",
    )


def labels_to_components(labels, ctx) -> list[list[int]]:
    """Decode a label array into sorted component lists of raw vertex ids."""
    lab = to_numpy(labels)
    slots = np.nonzero(lab >= 0)[0]
    raw = ctx.decode(slots)
    comps: dict[int, list[int]] = {}
    for slot, rid in zip(slots.tolist(), raw.tolist()):
        comps.setdefault(int(lab[slot]), []).append(rid)
    return sorted(sorted(c) for c in comps.values())
