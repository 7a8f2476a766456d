"""Streaming Connected Components — the raw, dense, sparse and compact plans.

Counterpart of ``gelly_tpu/library/connected_components.py``. Every plan
emits, per window, the canonical label array (minimum vertex slot of each
component, ``-1`` for slots never seen):

- **raw** (``ingest_combine=False``): each raw chunk folds into a dense
  ``i32 parent[]`` forest plus a ``bool seen[]`` mask. Chunks of at least
  :data:`RAW_DEDUP_MIN_CHUNK` edges take the sort-dedup fold
  (:func:`~gelly_torch.ops.unionfind.union_edges_dedup`), whose
  ``fold_backend="kernel"`` runs the hand-written ``sorted_window_gather``;
  smaller chunks take :func:`~gelly_torch.ops.unionfind.union_edges`.
- **dense** / **sparse** codecs (``ingest_combine=True``): the host codec
  reduces each chunk to its spanning forest (a label array, or counted
  ``(vertex, root)`` pairs) and the device unions the star edges.
- **compact** (``codec="compact"``, :func:`connected_components_compact`):
  the host codec also assigns persistent compact ids, and the device folds
  in an ``M``-slot space with :func:`~gelly_torch.ops.unionfind.union_pairs_star`.

:func:`cc_host_precombine` is the engine's ``host_precombine`` for the
raw plan: it reduces a chunk on the host to its spanning forest.

``windowed=W`` marks a plan for the engine's sliding pane ring; the
compact plan's pane-ring variant (:class:`CCWindowPane`) adds the TTL
decay hooks (``ttl_panes``). On a mesh of S > 1 shards the plans merge
their shards' forests each window (butterfly, ``merge="gather"``'s
stacked union, or :func:`connected_components_tree`'s hierarchical
tree), or with ``merge_mode="delta"`` / ``"auto"`` gather only the
window's dirty rows (:func:`_cc_merge_delta`, and the compact plan's
cid-space delta).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, to_numpy
from ..engine.aggregation import (
    SummaryAggregation,
    bucket_stack_payloads,
    group_combine_payloads,
    lane_form_of,
    lane_offsets,
    resolve_sparse_codec,
    sparse_payload_id_check,
)
from ..ops import segments, unionfind
from ..parallel import collectives
from ..utils import native


class CCSummary(NamedTuple):
    parent: torch.Tensor  # i32[N] union-find forest (canonical min-root)
    seen: torch.Tensor  # bool[N] vertices observed in the stream


class CCCompactSummary(NamedTuple):
    """Compact-space CC summary (``codec="compact"``): the forest over a
    persistent compact id space of M slots, with the cid -> vertex-slot
    table as the decode side."""

    croot: torch.Tensor  # i32[M] union-find forest over compact ids
    vertex_of: torch.Tensor  # i32[M] global vertex slot per cid (-1 unassigned)


class CCWindowPane(NamedTuple):
    """One pane of the windowed compact plan (``windowed=W``): the pane's
    own forest and first-seen decode rows, plus the exact touched-cid mask
    (the window-membership predicate, recorded from the wire payload's
    member lanes: a self-loop-only vertex never moves ``croot`` off the
    identity) and the TTL last-seen source."""

    croot: torch.Tensor  # i32[M] union-find forest over compact ids
    vertex_of: torch.Tensor  # i32[M] global vertex slot per cid (-1 unassigned)
    touched: torch.Tensor  # bool[M] cids referenced by this pane's payloads


# Raw folds switch from the generic union_edges fixpoint to the sort-dedup
# fold at this chunk size: below it the dedup sorts cost more than the
# rounds they save. Read at fold time, so it can be patched per run.
RAW_DEDUP_MIN_CHUNK = 1 << 22


def _host(x) -> np.ndarray:
    """numpy view of a host chunk field (no copy for CPU tensors)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def cc_labels_numpy(src: np.ndarray, dst: np.ndarray,
                    valid: np.ndarray | None, n_v: int) -> np.ndarray:
    """Pure-numpy spanning-forest labels i32[n_v] of one chunk (-1 for
    untouched slots) — a copy of ``gelly_tpu``'s dense-codec fallback."""
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
    forest — a copy of ``gelly_tpu``'s sparse-codec fallback."""
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


def merge_chunk_forest(glob: np.ndarray, lab: np.ndarray) -> np.ndarray:
    """Hook a chunk's spanning-forest labels into a global dense forest on
    the host (numpy): hooks at LABEL (root) indices plus one doubling step
    per round until fixpoint. Returns the updated ``glob``."""
    ok = lab >= 0
    v = np.nonzero(ok)[0].astype(np.int32)
    r = lab[v]
    while True:
        prev = glob
        lab_u = glob[v]
        lab_v = glob[r]
        lab_lo = np.minimum(lab_u, lab_v)
        lab_hi = np.maximum(lab_u, lab_v)
        glob = glob.copy()
        np.minimum.at(glob, lab_hi, lab_lo)
        glob = np.minimum(glob, glob[glob])
        if np.array_equal(glob, prev):
            break
    return glob


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``[K, cap]`` view of a payload leaf (``jnp.atleast_2d``)."""
    return x if x.dim() >= 2 else x.reshape(1, -1)


def _row_offsets(ri: torch.Tensor, cap: int) -> torch.Tensor:
    """Row-local indices of a ``[K, cap]`` leaf to flat lane indices."""
    k = ri.shape[0]
    off = cap * torch.arange(k, dtype=torch.int32, device=ri.device)
    return (ri + off[:, None]).reshape(-1)


def connected_components_compact(
    vertex_capacity: int, merge: str = "gather",
    compact_capacity: int | None = None, wire: str = "auto",
    unit_block: int = 1 << 18, merge_mode: str = "auto",
    delta_auto_rows: int | None = None,
    windowed: int | None = None, ttl_panes: int | None = None,
) -> SummaryAggregation:
    """CC over a persistent compact root space (``codec="compact"``).

    The host codec assigns each touched vertex a persistent first-seen
    compact id (:class:`~gelly_torch.ops.compact_space.CompactIdSession`,
    one table probe per member) and ships members already dense in
    ``[0, M)``; the device fold is a pair-sized union in the M-slot space
    and full-capacity arrays are touched once per window, in
    ``transform``. ``M = compact_capacity`` (default ``min(n, 2^22)``)
    bounds distinct touched vertices per run; overflow raises
    :class:`~gelly_torch.ops.compact_space.CompactSpaceOverflow`.

    ``merge_mode`` / ``delta_auto_rows`` shape the mesh merge as in
    :func:`connected_components` (the auto bound defaults to ``M / 4``).

    ``wire`` picks the payload format:

    - ``"segments"`` — one native call per unit
      (``cc_unit_forest_segments``) emits members grouped by component,
      each component's root first; the device derives each member's
      root-row index as its segment start (cumsum + row-wise searchsorted
      + gather), so a member costs 4 bytes on the wire;
    - ``"pairs"`` — per-chunk sparse combines, merged per unit into
      ``(v, root-row index)`` rows (8 bytes a member);
    - ``"auto"`` — segments when the native unit codec loads.

    The plan folds compressed payloads only. ``windowed=W`` builds the
    pane-ring variant (:func:`_windowed_compact_variant`); ``ttl_panes=T``
    (T >= W) arms its per-vertex decay.
    """
    from ..ops.compact_space import CompactIdSession

    if wire not in ("auto", "segments", "pairs"):
        raise ValueError(f"wire must be auto/segments/pairs, got {wire}")
    if merge not in ("tree", "gather"):
        raise ValueError(f"merge must be tree/gather, got {merge!r}")
    resolve_merge_mode(merge_mode)
    n = vertex_capacity
    m = compact_capacity or min(n, 1 << 22)
    session = CompactIdSession(m)
    use_segments = wire == "segments" or (
        wire == "auto" and native.unit_segments_available()
    )

    def init(device=DEFAULT_DEVICE) -> CCCompactSummary:
        croot = unionfind.fresh_forest(m, device)
        return CCCompactSummary(
            croot=croot, vertex_of=torch.full_like(croot, -1))

    def fold(s, chunk):
        raise NotImplementedError(
            "codec='compact' folds compressed payloads only (its id space "
            "is assigned by the host ingest codec); use codec='sparse' for "
            "raw-chunk folds"
        )

    def host_compress(chunk) -> dict:
        src, dst, valid = (_host(chunk.src), _host(chunk.dst),
                           _host(chunk.valid))
        if native.sparse_codecs_available():
            v, r = native.cc_chunk_combine_sparse(src, dst, valid, n)
        else:
            v, r = cc_pairs_numpy(src, dst, valid, n)
        return {"v": v, "r": r}

    def host_compress_raw(chunk) -> dict:
        # Segment wire: per-chunk compression is zero-copy views; the
        # whole unit combines in one native call in the stacker.
        return {"src": _host(chunk.src), "dst": _host(chunk.dst),
                "valid": _host(chunk.valid)}

    def _combine_pairs_idx(av: np.ndarray, ar: np.ndarray):
        """Merge a group's pairs into one forest, each pair's root given
        as its INDEX in the output (the star fold's wire)."""
        if native.sparse_idx_available():
            return native.cc_chunk_combine_sparse_idx(av, ar, None, n)
        v, r = cc_pairs_numpy(av, ar, None, n)
        return v, r, np.searchsorted(v, r).astype(np.int32)

    def stack_compact(payloads: list, groups: int = 1,
                      seq: int | None = None) -> dict:
        # Stateless group combine first (parallel across stagers).
        size = -(-max(len(payloads), 1) // groups)
        combined = [
            _combine_pairs_idx(
                np.concatenate([q["v"] for q in payloads[i:i + size]]),
                np.concatenate([q["r"] for q in payloads[i:i + size]]),
            )
            for i in range(0, len(payloads), size)
        ]
        # Stateful cid assignment in STREAM order.
        if seq is not None:
            session.await_turn(seq)
        try:
            rows = []
            for v2, _, ri2 in combined:
                cv, new_ids, base = session.assign(v2)
                rows.append({
                    "v": cv, "ri": ri2, "newv": new_ids,
                    "base": np.asarray(base, np.int32),
                })
            while len(rows) < groups:
                rows.append({
                    "v": np.empty(0, np.int32), "ri": np.empty(0, np.int32),
                    "newv": np.empty(0, np.int32),
                    "base": np.asarray(session.assigned, np.int32),
                })
        finally:
            if seq is not None:
                session.complete_turn(seq)
        # Quantum buckets capped at m: a row never exceeds the capacity.
        return bucket_stack_payloads(
            rows, {"v": -1, "ri": 0, "newv": -1},
            min_bucket=min(1024, m), quantum=min(1 << 18, m),
        )

    def stack_segments(payloads: list, groups: int = 1,
                       seq: int | None = None) -> dict:
        # Fused unit combine (stateless, heavy): one native call per group
        # over the group's raw edges, root-first segments in vertex space.
        size = -(-max(len(payloads), 1) // groups)
        combined = []
        for i in range(0, len(payloads), size):
            builder = native.UnitForestBuilder(n, block=unit_block)
            for p in payloads[i:i + size]:
                va = np.asarray(p["valid"])
                builder.add(
                    p["src"], p["dst"], None if bool(va.all()) else va
                )
            combined.append(builder.finish())
        # Stateful cid remap in STREAM order (order-preserving, so the
        # segment structure carries over to cid space).
        if seq is not None:
            session.await_turn(seq)
        try:
            rows = []
            for mv, ln in combined:
                cids, new_ids, base = session.assign(mv)
                rows.append({
                    "m": cids, "len": ln, "newv": new_ids,
                    "base": np.asarray(base, np.int32),
                })
            while len(rows) < groups:
                rows.append({
                    "m": np.empty(0, np.int32),
                    "len": np.empty(0, np.int32),
                    "newv": np.empty(0, np.int32),
                    "base": np.asarray(session.assigned, np.int32),
                })
        finally:
            if seq is not None:
                session.complete_turn(seq)
        # Per-key buckets: lengths and fresh ids run far below members.
        return bucket_stack_payloads(
            rows, {"m": -1, "len": 0, "newv": -1},
            min_bucket=min(1024, m), quantum=min(1 << 18, m),
            per_key={
                "len": (min(1024, m), min(1 << 13, m)),
                "newv": (min(1024, m), min(1 << 16, m)),
            },
        )

    def _append_vertex_of(s: CCCompactSummary, payload) -> torch.Tensor:
        # Decode-table append: rows carry their own base. JAX's
        # mode="drop" scatter becomes a scatter into one spare slot (m).
        newv = _rows(payload["newv"])
        base = payload["base"].reshape(-1)
        cap = newv.shape[1]
        pos = base[:, None] + torch.arange(cap, dtype=torch.int32,
                                           device=newv.device)[None, :]
        okn = (newv >= 0) & (pos < m)
        idx = torch.where(okn, pos, m).reshape(-1).long()
        vo = torch.cat([s.vertex_of, s.vertex_of.new_zeros(1)])
        vo = vo.scatter(0, idx, torch.where(okn, newv, 0).reshape(-1))
        return vo[:m]

    def fold_compressed(s: CCCompactSummary, payload) -> CCCompactSummary:
        # Pairs wire: leaves [K, cap]; ri is row-local.
        vertex_of = _append_vertex_of(s, payload)
        v = _rows(payload["v"])
        ri = _row_offsets(_rows(payload["ri"]), v.shape[1])
        v = v.reshape(-1)
        croot = unionfind.union_pairs_star(s.croot, v, ri, v >= 0)
        return CCCompactSummary(croot, vertex_of)

    def fold_segments(s: CCCompactSummary, payload) -> CCCompactSummary:
        # Segment wire: members [K, capm] grouped by component, root first;
        # lengths [K, capr]. Each member lane's root-row index is its
        # segment START, derived here from the lengths.
        vertex_of = _append_vertex_of(s, payload)
        mm = _rows(payload["m"])
        ln = _rows(payload["len"])
        kb, capm = mm.shape
        cum = torch.cumsum(ln, dim=1, dtype=torch.int32)
        total = cum[:, -1]
        lane = torch.arange(capm, dtype=torch.int32, device=mm.device)
        # Segment of each lane = # cum entries <= lane; the clamp covers
        # padding lanes past the last segment.
        seg = torch.searchsorted(cum, lane.expand(kb, capm).contiguous(),
                                 right=True)
        seg = torch.clamp(seg, max=ln.shape[1] - 1)
        starts = cum - ln
        ri = torch.gather(starts, 1, seg)
        valid = lane[None, :] < total[:, None]
        croot = unionfind.union_pairs_star(
            s.croot, mm.reshape(-1), _row_offsets(ri, capm),
            valid.reshape(-1),
        )
        return CCCompactSummary(croot, vertex_of)

    def combine(a: CCCompactSummary, b: CCCompactSummary) -> CCCompactSummary:
        return CCCompactSummary(
            croot=unionfind.merge_forests(a.croot, b.croot),
            # Each cid's vertex is recorded by exactly one payload row.
            vertex_of=torch.maximum(a.vertex_of, b.vertex_of),
        )

    def merge_stacked(st: CCCompactSummary) -> CCCompactSummary:
        return CCCompactSummary(
            croot=unionfind.merge_forest_stack(st.croot),
            vertex_of=st.vertex_of.max(dim=0).values,
        )

    def _dirty(local: CCCompactSummary) -> torch.Tensor:
        # A window's locals touch a cid by assigning its decode entry
        # (fresh cids) or by hooking its root (cids of earlier windows).
        ident = torch.arange(m, dtype=torch.int32, device=local.croot.device)
        return (local.vertex_of >= 0) | (local.croot != ident)

    def merge_dirty_count(local: CCCompactSummary) -> torch.Tensor:
        return _dirty(local).sum(dtype=torch.int32)

    def merge_delta(base: CCCompactSummary, locals_: list,
                    bucket: int, mesh=None) -> CCCompactSummary:
        # The dirty-delta mesh merge in cid space: every shard's touched
        # (cid, croot, vertex_of) rows; croot rows are union edges, and a
        # cid's vertex is recorded by exactly one row, so a max-scatter
        # reproduces the decode tables' elementwise-max merge.
        rows = [collectives.compact_delta(
            _dirty(l), {"r": l.croot, "v": l.vertex_of}, bucket)
            if l is not None else None for l in locals_]
        gs, gv = collectives.gather_delta(
            [r and r[0] for r in rows], [r and r[1] for r in rows],
            base.croot.device, mesh)
        ok = gs >= 0
        croot = unionfind.union_pairs_rooted(
            base.croot, torch.where(ok, gs, 0), torch.where(ok, gv["r"], 0),
            ok)
        vo = torch.cat([base.vertex_of, base.vertex_of.new_full((1,), -1)])
        vo = vo.scatter_reduce(0, torch.where(ok, gs, m).long(),
                               torch.where(ok, gv["v"], -1), "amax",
                               include_self=True)
        return CCCompactSummary(croot, vo[:m])

    def transform(s: CCCompactSummary) -> torch.Tensor:
        # The plan's only full-capacity op: i32[n] labels per window.
        root = unionfind.pointer_jump(s.croot)
        ok = s.vertex_of >= 0
        canon = torch.full((m + 1,), segments.INT_MAX, dtype=torch.int32,
                           device=root.device)
        canon = canon.scatter_reduce(
            0, torch.where(ok, root, m).long(),
            torch.where(ok, s.vertex_of, segments.INT_MAX), "amin",
            include_self=True,
        )
        lab_c = canon[root]
        out = torch.full((n + 1,), -1, dtype=torch.int32, device=root.device)
        out = out.scatter(0, torch.where(ok, s.vertex_of, n).long(),
                          torch.where(ok, lab_c, -1))
        return out[:n]

    def flatten(s: CCCompactSummary) -> CCCompactSummary:
        # The pair folds skip the global flatten; this bounds chase depth.
        return CCCompactSummary(unionfind.pointer_jump(s.croot), s.vertex_of)

    if windowed is not None:
        return _windowed_compact_variant(
            windowed, ttl_panes, m, n, session,
            init=init, fold=fold, combine=combine,
            merge_stacked=merge_stacked if merge == "gather" else None,
            host_compress=(
                host_compress_raw if use_segments else host_compress),
            fold_compressed=(
                fold_segments if use_segments else fold_compressed),
            stack_payloads=(
                stack_segments if use_segments else stack_compact),
            member_key="m" if use_segments else "v",
        )
    if ttl_panes is not None:
        raise ValueError(
            "ttl_panes requires windowed=W (TTL stamps are last-seen "
            "PANE indices; there is no pane clock without a ring)"
        )
    agg = SummaryAggregation(
        init=init,
        fold=fold,
        combine=combine,
        transform=transform,
        merge_stacked=merge_stacked if merge == "gather" else None,
        transient=False,
        host_compress=host_compress_raw if use_segments else host_compress,
        fold_compressed=fold_segments if use_segments else fold_compressed,
        stack_payloads=stack_segments if use_segments else stack_compact,
        fold_accumulates=True,
        flatten=flatten,
        requires_codec=True,
        stack_ordered=True,
        on_stage_error=session.complete_turn,
        on_run_start=session.reset,
        ordered_wait_s=lambda: session.wait_s,
        on_resume=lambda summary: session.rebuild_from_vertex_of(
            to_numpy(summary.vertex_of)
        ),
        merge_mode=resolve_merge_mode(merge_mode),
        merge_delta=merge_delta,
        merge_dirty_count=merge_dirty_count,
        merge_delta_auto_rows=(
            m // 4 if delta_auto_rows is None else int(delta_auto_rows)
        ),
        name="connected-components-compact",
    )
    agg.session = session
    agg.compact_capacity = m
    agg.wire = "segments" if use_segments else "pairs"
    return agg


def _windowed_compact_variant(
    windowed: int, ttl_panes: int | None, m: int, n: int, session,
    *, init, fold, combine, merge_stacked, host_compress, fold_compressed,
    stack_payloads, member_key: str,
) -> SummaryAggregation:
    """The pane-ring compact plan: the base fold / combine wrapped in
    :class:`CCWindowPane` (an exact touched-cid mask rides every pane),
    plus the engine's windowed hooks.

    ``windowed_evict(panes, persist, stale)`` (the TTL hook; the panes
    and the map are tensors on the summary's device, ``stale`` a host
    mask) renumbers the survivors
    order-preserving onto a dense cid prefix, gathers every live pane's
    leaves through the renumbering and rebuilds the session from the
    compacted persistent map, so ``session.assigned`` drops back to the
    live-slot count. Sound because T >= W (the engine checks it): an
    evicted cid is untouched in every live pane, so its rows are
    identity / -1 / False everywhere.
    """
    if windowed < 1:
        raise ValueError(f"windowed must be >= 1 pane, got {windowed}")
    if ttl_panes is not None and ttl_panes < windowed:
        raise ValueError(
            f"ttl_panes={ttl_panes} < windowed={windowed}: a slot must "
            "outlive the ring (T >= W) so eviction never rewrites a "
            "pane that still references it"
        )

    def init_pane(device=DEFAULT_DEVICE) -> CCWindowPane:
        s = init(device)
        return CCWindowPane(s.croot, s.vertex_of,
                            torch.zeros_like(s.croot, dtype=torch.bool))

    def fold_pane(s: CCWindowPane, payload) -> CCWindowPane:
        base = fold_compressed(CCCompactSummary(s.croot, s.vertex_of),
                               payload)
        mem = payload[member_key].reshape(-1)
        touched = segments.mark_seen(s.touched, mem, mem >= 0)
        return CCWindowPane(base.croot, base.vertex_of, touched)

    def combine_pane(a: CCWindowPane, b: CCWindowPane) -> CCWindowPane:
        # The combine's union_edges hooks the parents it reads, so the
        # forest it merges into must be flat; a pane's star-fold forest
        # is not. gelly_tpu merges it unflattened and loses links on
        # sparse streams (ROADMAP.md queue 3); a flat forest is unchanged.
        c = combine(CCCompactSummary(unionfind.pointer_jump(a.croot),
                                     a.vertex_of),
                    CCCompactSummary(b.croot, b.vertex_of))
        return CCWindowPane(c.croot, c.vertex_of, a.touched | b.touched)

    def merge_stacked_pane(st: CCWindowPane) -> CCWindowPane:
        c = merge_stacked(CCCompactSummary(st.croot, st.vertex_of))
        return CCWindowPane(c.croot, c.vertex_of, st.touched.any(dim=0))

    def transform_pane(s: CCWindowPane) -> torch.Tensor:
        # The base transform with the window-membership predicate: labels
        # cover touched cids only (the engine substitutes the persistent
        # vertex_of first, so every touched cid decodes).
        root = unionfind.pointer_jump(s.croot)
        ok = s.touched & (s.vertex_of >= 0)
        canon = torch.full((m + 1,), segments.INT_MAX, dtype=torch.int32,
                           device=root.device)
        canon = canon.scatter_reduce(
            0, torch.where(ok, root, m).long(),
            torch.where(ok, s.vertex_of, segments.INT_MAX), "amin",
            include_self=True,
        )
        lab_c = canon[root]
        out = torch.full((n + 1,), -1, dtype=torch.int32, device=root.device)
        out = out.scatter(0, torch.where(ok, s.vertex_of, n).long(),
                          torch.where(ok, lab_c, -1))
        return out[:n]

    def flatten_pane(s: CCWindowPane) -> CCWindowPane:
        return CCWindowPane(unionfind.pointer_jump(s.croot), s.vertex_of,
                            s.touched)

    def windowed_evict(panes, persist, stale):
        # At a pane boundary, with the pipeline quiesced (no staged
        # payload carries the old cids). The panes and the map stay on
        # their device; the session rebuilds from the host copy.
        assigned = session.assigned
        surv = np.flatnonzero(~np.asarray(stale)[:assigned])
        k = surv.shape[0]
        dev = persist.device
        si = torch.from_numpy(surv).to(dev)
        perm = torch.full((m,), -1, dtype=torch.int32, device=dev)
        perm[si] = torch.arange(k, dtype=torch.int32, device=dev)
        out = []
        for p in panes:
            croot = torch.arange(m, dtype=torch.int32, device=dev)
            croot[:k] = perm[p.croot[si].long()]
            vof = torch.full((m,), -1, dtype=torch.int32, device=dev)
            vof[:k] = p.vertex_of[si]
            tch = torch.zeros(m, dtype=torch.bool, device=dev)
            tch[:k] = p.touched[si]
            out.append(CCWindowPane(croot, vof, tch))
        p2 = torch.full((m,), -1, dtype=torch.int32, device=dev)
        p2[:k] = persist[si]
        session.rebuild_from_vertex_of(to_numpy(p2))
        return out, p2, surv

    agg = SummaryAggregation(
        init=init_pane,
        fold=fold,
        combine=combine_pane,
        transform=transform_pane,
        merge_stacked=(
            merge_stacked_pane if merge_stacked is not None else None),
        transient=False,
        host_compress=host_compress,
        fold_compressed=fold_pane,
        stack_payloads=stack_payloads,
        fold_accumulates=True,
        flatten=flatten_pane,
        requires_codec=True,
        stack_ordered=True,
        on_stage_error=session.complete_turn,
        on_run_start=session.reset,
        ordered_wait_s=lambda: session.wait_s,
        name="connected-components-compact-windowed",
    )
    agg.session = session
    agg.compact_capacity = m
    agg.windowed_panes = int(windowed)
    if ttl_panes is not None:
        agg.windowed_ttl_panes = int(ttl_panes)
    agg.windowed_persist_init = lambda device=DEFAULT_DEVICE: torch.full(
        (m,), -1, dtype=torch.int32, device=device)
    agg.windowed_persist_update = lambda p, pane: torch.maximum(
        p, pane.vertex_of)
    agg.windowed_query_fixup = lambda q, persist: q._replace(
        vertex_of=persist)
    agg.windowed_touched = lambda pane: pane.touched
    agg.windowed_evict = windowed_evict
    agg.on_resume_windowed = lambda persist: session.rebuild_from_vertex_of(
        np.asarray(persist))
    return agg


def resolve_merge_mode(merge_mode: str) -> str:
    """Validate the cross-shard window merge knob:

    - ``"replicated"`` — merge whole shard summaries (butterfly,
      hierarchical tree or gather + stacked union): cost ∝ capacity;
    - ``"delta"`` — gather only the dirty ``(slot, parent)`` rows of the
      window and union them into the carried global summary: cost ∝ the
      window's hooks;
    - ``"auto"`` — per window, delta while the gathered rows stay within
      the plan's ``merge_delta_auto_rows``, else replicated.
    """
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

    Same signature and plan choice as ``gelly_tpu``'s: ``merge`` is
    ``"tree"`` or ``"gather"`` (it shapes the ``combine``/``merge_stacked``
    the plan exports). ``ingest_combine`` (default on) attaches the host
    codec, and ``codec`` picks its payload:

    - ``"dense"`` — an i32[n] label array per chunk;
    - ``"sparse"`` — counted (vertex, root) pairs, bucket-padded per unit,
      folded by :func:`~gelly_torch.ops.unionfind.union_pairs_compact`;
    - ``"compact"`` — :func:`connected_components_compact`;
    - ``"auto"`` — sparse iff ``vertex_capacity >= 2^20``.

    ``ingest_combine=False`` builds the raw plan; ``fold_backend``
    (:func:`resolve_fold_backend`) picks its sort-dedup gather:
    ``"kernel"`` for the hand-written CUDA ``sorted_window_gather``,
    ``"plain"``/``"auto"`` for plain PyTorch gathers; a raw fold takes
    the sort-dedup path when its chunk (on a mesh: each shard's slice)
    holds at least :data:`RAW_DEDUP_MIN_CHUNK` lanes. ``merge_mode``
    (:func:`resolve_merge_mode`) picks the mesh's window merge and
    ``delta_auto_rows`` the ``"auto"`` crossover (default ``n / 4``
    gathered rows). ``windowed=W`` marks the plan for the engine's
    sliding pane ring (emissions cover the last W merge windows; the
    merge is then replicated); ``ttl_panes`` needs ``codec="compact"``.
    """
    if codec == "compact":
        if not ingest_combine:
            raise ValueError("codec='compact' requires ingest_combine=True")
        return connected_components_compact(
            vertex_capacity, merge=merge, compact_capacity=compact_capacity,
            merge_mode=merge_mode, delta_auto_rows=delta_auto_rows,
            windowed=windowed, ttl_panes=ttl_panes,
        )
    if ttl_panes is not None:
        raise ValueError(
            "ttl_panes needs the compact-id plan (codec='compact'): "
            "per-vertex decay evicts through the CompactIdSession "
            "rebuild hook, which dense/sparse plans have no analog of"
        )
    if windowed is not None:
        if int(windowed) < 1:
            raise ValueError(f"windowed must be >= 1 pane, got {windowed}")
        # A pane ring retires panes: the delta merge, which folds into a
        # CARRIED global summary, cannot engage.
        merge_mode = "replicated"
    if merge not in ("tree", "gather"):
        raise ValueError(f"merge must be tree/gather, got {merge!r}")
    n = vertex_capacity
    sparse = resolve_sparse_codec(codec, n)
    backend = resolve_fold_backend(fold_backend, n)
    mode = resolve_merge_mode(merge_mode)

    def init(device=DEFAULT_DEVICE) -> CCSummary:
        parent = unionfind.fresh_forest(n, device)
        return CCSummary(parent=parent,
                         seen=torch.zeros_like(parent, dtype=torch.bool))

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

    def host_compress(chunk) -> np.ndarray:
        src, dst, valid = (_host(chunk.src), _host(chunk.dst),
                           _host(chunk.valid))
        if native.available("chunk_combiner"):
            return native.cc_chunk_combine(src, dst, valid, n)
        return cc_labels_numpy(src, dst, valid, n)

    def fold_compressed(s: CCSummary, labels: torch.Tensor) -> CCSummary:
        # labels: i32[K, n] — K chunk forests; every (v, labels[k, v] >= 0)
        # is a union edge, all K unioned in one fixpoint.
        k = labels.shape[0]
        present = (labels >= 0).any(dim=0)
        v = torch.arange(n, dtype=torch.int32,
                         device=labels.device).expand(k, n).reshape(-1)
        lab = labels.reshape(-1)
        ok = lab >= 0
        parent = unionfind.union_edges(s.parent, v, torch.where(ok, lab, 0),
                                       ok)
        return CCSummary(parent, s.seen | present)

    def host_compress_sparse(chunk) -> dict:
        src, dst, valid = (_host(chunk.src), _host(chunk.dst),
                           _host(chunk.valid))
        if native.sparse_codecs_available():
            v, r = native.cc_chunk_combine_sparse(src, dst, valid, n)
        else:
            v, r = cc_pairs_numpy(src, dst, valid, n)
        return {"v": v, "r": r}

    def _combine_pairs(av: np.ndarray, ar: np.ndarray):
        # Pairs are union edges: one more sparse-combiner pass merges a
        # group's chunk forests into one.
        if native.sparse_codecs_available():
            return native.cc_chunk_combine_sparse(av, ar, None, n)
        return cc_pairs_numpy(av, ar, None, n)

    def stack_sparse(payloads: list, groups: int = 1) -> dict:
        payloads = group_combine_payloads(
            payloads, groups,
            lambda grp: dict(zip(("v", "r"), _combine_pairs(
                np.concatenate([q["v"] for q in grp]),
                np.concatenate([q["r"] for q in grp]),
            ))),
            {"v": np.empty(0, np.int32), "r": np.empty(0, np.int32)},
        )
        return bucket_stack_payloads(payloads, {"v": -1, "r": 0})

    def fold_compressed_sparse(s: CCSummary, payload) -> CCSummary:
        # payload: {"v", "r"} i32[K, cap], -1-padded (vertex, root) pairs.
        v = payload["v"].reshape(-1)
        r = payload["r"].reshape(-1)
        ok = v >= 0
        vi = torch.where(ok, v, 0)
        if 4 * v.numel() <= n:
            # Compacted-root-space union (per-round work ∝ pairs), while
            # the local space stays well below the capacity.
            parent = unionfind.union_pairs_compact(s.parent, vi, r, ok)
        else:
            parent = unionfind.union_edges(s.parent, vi, r, ok)
        seen = segments.mark_seen(s.seen, vi, ok)
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

    mk_delta, mk_count = _cc_merge_delta(n)
    if windowed is not None:
        mk_delta = mk_count = None
    codec_on = ingest_combine
    agg = SummaryAggregation(
        init=init,
        fold=fold,
        combine=combine,
        transform=transform,
        merge_stacked=merge_stacked if merge == "gather" else None,
        transient=False,
        host_compress=(
            (host_compress_sparse if sparse else host_compress)
            if codec_on else None
        ),
        fold_compressed=(
            (fold_compressed_sparse if sparse else fold_compressed)
            if codec_on else None
        ),
        stack_payloads=stack_sparse if (codec_on and sparse) else None,
        # The sparse payload's pad values (-1 lanes fold as no-ops) and its
        # id range check for producer-compressed payloads.
        codec_pad_values={"v": -1, "r": 0} if (codec_on and sparse) else None,
        codec_payload_check=(
            sparse_payload_id_check(n, "v", "r")
            if (codec_on and sparse) else None
        ),
        flatten=flatten,
        fold_accumulates=True,  # CC forests are pure edge-set summaries
        fold_backend=backend,
        device_fields=("src", "dst", "valid"),  # what the raw fold reads
        merge_mode=mode,
        merge_delta=mk_delta,
        merge_dirty_count=mk_count,
        # Past n/4 gathered rows the replicated merge's whole-forest unions
        # win (gelly_tpu's structural guess; delta_auto_rows overrides).
        merge_delta_auto_rows=(
            None if windowed is not None
            else n // 4 if delta_auto_rows is None
            else int(delta_auto_rows)
        ),
        name=f"connected-components-{merge}",
    )
    if windowed is not None:
        agg.windowed_panes = int(windowed)
    else:
        agg.lane_form = _cc_lane_form(agg, n)
    return agg


def _cc_lane_form(agg: SummaryAggregation, n: int):
    """The plan's lane-offset form (tenant tiers): a ``[L, n]`` stack of
    forests is one forest of ``L * n`` slots once lane ``l``'s ids are
    offset by ``l * n``. ``union_edges`` ends in a full ``pointer_jump``
    and ``union_pairs_compact`` maps every root group to its minimum, so
    each lane's forest comes out as the lane alone would give it. The
    dedup fold (chunks of :data:`RAW_DEDUP_MIN_CHUNK` lanes or more) takes
    per-lane branches and stays lane by lane."""

    def flat(st: CCSummary):
        off = lane_offsets(st.parent.shape[0], n, st.parent.device)
        return (st.parent + off).reshape(-1), st.seen.reshape(-1), off

    def back(parent, seen, off) -> CCSummary:
        lanes = off.shape[0]
        return CCSummary(parent.view(lanes, n) - off, seen.view(lanes, n))

    def fold(st: CCSummary, chunk) -> CCSummary:
        parent, seen, off = flat(st)
        src = (chunk.src + off).reshape(-1)
        dst = (chunk.dst + off).reshape(-1)
        valid = chunk.valid.reshape(-1)
        parent = unionfind.union_edges(parent, src, dst, valid)
        seen = segments.mark_seen(seen, src, valid)
        return back(parent, segments.mark_seen(seen, dst, valid), off)

    def fold_dense(st: CCSummary, labels: torch.Tensor) -> CCSummary:
        # labels: i32[L, K, n]; lane l's pairs (v, labels[l, k, v] >= 0).
        parent, _, off = flat(st)
        lanes, k = labels.shape[:2]
        off3 = off.view(lanes, 1, 1)
        ok = labels >= 0
        v = (torch.arange(n, dtype=torch.int32, device=labels.device)
             + off3).expand(lanes, k, n)
        lab = torch.where(ok, labels + off3, 0)
        parent = unionfind.union_edges(parent, v.reshape(-1),
                                       lab.reshape(-1), ok.reshape(-1))
        present = ok.any(dim=1)
        return CCSummary(parent.view(lanes, n) - off, st.seen | present)

    def fold_sparse(st: CCSummary, payload) -> CCSummary:
        # payload: {"v", "r"} i32[L, K, cap], -1-padded per lane.
        parent, seen, off = flat(st)
        v, r = payload["v"], payload["r"]
        lanes = v.shape[0]
        off3 = off.view(lanes, 1, 1)
        ok = v >= 0
        vi = torch.where(ok, v + off3, off3).reshape(-1)
        ri = (r + off3).reshape(-1)
        ok = ok.reshape(-1)
        if 4 * (v.numel() // lanes) <= n:  # the per-lane plan's choice
            parent = unionfind.union_pairs_compact(parent, vi, ri, ok)
        else:
            parent = unionfind.union_edges(parent, vi, ri, ok)
        return back(parent, segments.mark_seen(seen, vi, ok), off)

    def combine(a: CCSummary, b: CCSummary) -> CCSummary:
        pa, sa, off = flat(a)
        pb = (b.parent + off).reshape(-1)
        idx = torch.arange(pa.shape[0], dtype=torch.int32, device=pa.device)
        parent = unionfind.union_edges(pa, idx, pb,
                                       torch.ones_like(idx, dtype=torch.bool))
        return back(parent, sa | b.seen.reshape(-1), off)

    def transform(st: CCSummary) -> torch.Tensor:
        parent, _, off = flat(st)
        p = unionfind.pointer_jump(parent).view(off.shape[0], n) - off
        return torch.where(st.seen, p, -1)

    def flatten(st: CCSummary) -> CCSummary:
        parent, seen, off = flat(st)
        return back(unionfind.pointer_jump(parent), seen, off)

    return lane_form_of(
        agg, fold=fold,
        fold_compressed=(None if agg.fold_compressed is None
                         else fold_sparse if agg.stack_payloads is not None
                         else fold_dense),
        combine=combine, transform=transform, flatten=flatten, slots=n,
        raw_ok=lambda chunk_capacity: chunk_capacity < RAW_DEDUP_MIN_CHUNK)


def cc_tenant_tier(
    vertex_capacity: int, chunk_capacity: int = 1 << 10,
    fold_backend: str = "auto", delta_auto_rows: int | None = None,
    compressed: bool = False, codec: str = "auto",
) -> tuple[SummaryAggregation, int]:
    """A CC plan for one multi-tenant capacity tier
    (``engine/tenants.py``): returns ``(agg, chunk_capacity)`` for
    ``MultiTenantEngine.add_tier``, as ``gelly_tpu``'s.

    ``compressed=False`` (default) builds the raw-fold tier: lanes fold
    raw per-tenant chunks. ``compressed=True`` keeps the stateless ingest
    codec on, for an ``add_tier(..., compressed=True)`` tier whose lanes
    fold PRE-COMPRESSED payloads (compressed once at the producer;
    ``codec`` picks the payload format, ``"sparse"`` the wire-win shape).
    The compact-id codec stays refused either way: its id session
    consumes payloads in global stream order, which concurrent tenant
    lanes cannot provide. ``vertex_capacity`` is the tier's capacity
    class; every tenant of the tier shares its plan. A tier of chunks
    below :data:`RAW_DEDUP_MIN_CHUNK` folds all its lanes in one call
    (:class:`~gelly_torch.engine.aggregation.LaneForm`); larger chunks
    take the dedup fold lane by lane.
    """
    agg = connected_components(
        vertex_capacity, merge="gather", ingest_combine=compressed,
        codec=codec,
        fold_backend=fold_backend, delta_auto_rows=delta_auto_rows,
    )
    return agg, int(chunk_capacity)


def cc_query(vertex_capacity: int, *, name: str = "cc",
             merge: str = "gather", fold_backend: str = "auto",
             compressed: bool = False, codec: str = "auto"):
    """Fuse-compatible CC query (``engine.multiquery.fuse``), tagged with
    its slot capacity so ``fuse`` can refuse mismatched chunk schemas.

    ``compressed=False`` (default) builds the raw fold
    (``ingest_combine=False``): the fused pipeline stages each chunk once
    for every query. ``compressed=True`` keeps the ingest codec on; when
    every query of a fused set does, the fused plan compresses each chunk
    once into one multi-query payload. ``codec`` picks the payload as in
    :func:`connected_components` (``"compact"`` is stack-ordered and
    cannot be fused)."""
    from ..engine.multiquery import QuerySpec

    return QuerySpec(
        name=name,
        agg=connected_components(vertex_capacity, merge=merge,
                                 ingest_combine=compressed, codec=codec,
                                 fold_backend=fold_backend),
        slot_capacity=vertex_capacity,
    )


def _cc_merge_delta(n: int):
    """The ``CCSummary`` dirty-delta merge: each shard's touched ``(slot,
    parent)`` rows (a fresh-forest local IS its edge set ``{(i,
    parent[i])}`` plus its seen marks), gathered and unioned into the
    carried global summary with :func:`~gelly_torch.ops.unionfind.
    union_pairs_rooted` (pair-sized rounds, no full-capacity flatten; the
    transform's pointer jump chases the depth)."""

    def dirty(local: CCSummary) -> torch.Tensor:
        ident = torch.arange(n, dtype=torch.int32, device=local.parent.device)
        return local.seen | (local.parent != ident)

    def merge_dirty_count(local: CCSummary) -> torch.Tensor:
        return dirty(local).sum(dtype=torch.int32)

    def merge_delta(base: CCSummary, locals_: list, bucket: int,
                    mesh=None) -> CCSummary:
        rows = [collectives.compact_delta(dirty(l), l.parent, bucket)
                if l is not None else None for l in locals_]
        gs, gv = collectives.gather_delta(
            [r and r[0] for r in rows], [r and r[1] for r in rows],
            base.parent.device, mesh)
        ok = gs >= 0
        si = torch.where(ok, gs, 0)
        parent = unionfind.union_pairs_rooted(
            base.parent, si, torch.where(ok, gv, 0), ok)
        return CCSummary(parent, segments.mark_seen(base.seen, si, ok))

    return merge_delta, merge_dirty_count


def connected_components_tree(vertex_capacity: int,
                              degree: int | None = None
                              ) -> SummaryAggregation:
    """ConnectedComponentsTree parity alias (merge-tree combine):
    ``degree`` is the ``SummaryTreeReduce`` partial-parallelism knob
    (ConnectedComponentsTree.java:28-34 -> SummaryTreeReduce.java:75); the
    mesh merge runs as a hierarchical tree with ``degree`` group
    summaries after its first phase."""
    agg = connected_components(vertex_capacity, merge="tree")
    agg.merge_degree = degree
    return agg


def cc_host_precombine(chunk):
    """Host pre-combiner: reduce a host chunk to its spanning forest.

    Numpy min-label propagation over the chunk's unique vertices replaces
    the chunk's edges with ``(vertex, chunk-local root)`` pairs, one per
    unique vertex (self-pairs keep roots seen): connectivity-equivalent
    and near-tree-shaped, so the device fold converges in fewer rounds.
    ``gelly_tpu``'s function, bit for bit; the chunk's other fields are
    kept, its raw ids zeroed."""
    m = to_numpy(chunk.valid).astype(bool)
    s = to_numpy(chunk.src)[m]
    d = to_numpy(chunk.dst)[m]
    if s.size == 0:
        return chunk
    ids = np.unique(np.concatenate([s, d]))
    ls = np.searchsorted(ids, s).astype(np.int64)
    ld = np.searchsorted(ids, d).astype(np.int64)
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
    n_out = ids.shape[0]
    cap = chunk.capacity
    src2 = np.zeros((cap,), np.int32)
    dst2 = np.zeros((cap,), np.int32)
    valid2 = np.zeros((cap,), bool)
    src2[:n_out] = ids
    dst2[:n_out] = ids[lab]
    valid2[:n_out] = True
    return chunk._replace(
        src=torch.from_numpy(src2), dst=torch.from_numpy(dst2),
        raw_src=torch.zeros(cap, dtype=torch.int64),
        raw_dst=torch.zeros(cap, dtype=torch.int64),
        valid=torch.from_numpy(valid2),
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
