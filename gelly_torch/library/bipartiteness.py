"""Streaming bipartiteness check — the raw, dense and sparse plans.

Counterpart of ``gelly_tpu/library/bipartiteness.py``
(``BipartitenessCheck.java``): the reference's ``Candidates`` sign maps
become a parity union-find (:mod:`gelly_torch.ops.parity_unionfind`). Each
edge asserts opposite colors on its endpoints; an odd cycle sets the
sticky ``failed`` bit, the analog of the merge collapsing to
``(false, {})``. Each window emits a :class:`BipartitenessResult`;
:func:`to_candidates` renders the reference's observable.

- **raw** (``ingest_combine=False``): the device unions each chunk's edges;
- **dense** codec: each chunk becomes its spanning forest, per-slot parity
  and odd-cycle flag (``i32[n]`` labels, ``i8[n]`` parity) on the host;
- **sparse** codec: counted (vertex, root, parity) triples, bucket-padded
  per unit; the fold takes the compacted-root-space union while four times
  the unit's padded lanes fit in the capacity.

``bipartiteness_query`` (the fused engines) raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, to_numpy
from ..engine.aggregation import (
    SummaryAggregation,
    bucket_stack_payloads,
    resolve_sparse_codec,
    sparse_payload_id_check,
)
from ..ops import parity_unionfind as puf, segments
from ..utils import native
from .connected_components import cc_labels_numpy

_BATCHED_ITEM = "ROADMAP.md queue 1 item 11 (batched engines)"


class BipartiteSummary(NamedTuple):
    forest: puf.ParityForest
    seen: torch.Tensor  # bool[N]


class BipartitenessResult(NamedTuple):
    ok: torch.Tensor  # bool[] — graph (still) 2-colorable
    labels: torch.Tensor  # i32[N] component label (min slot), -1 unseen
    colors: torch.Tensor  # i32[N] 0/1 parity color, -1 unseen


def parity_labels_numpy(src: np.ndarray, dst: np.ndarray,
                        valid: np.ndarray | None, n_v: int):
    """Pure-numpy fallback for the native parity combiner — a copy of
    ``gelly_tpu``'s. Returns ``(labels i32[n_v], parity u8[n_v], conflict
    bool)``: the chunk's spanning forest, each touched vertex's parity
    relative to its root (propagated along the chunk's edges from the
    roots) and whether the chunk alone holds an odd cycle."""
    if valid is not None:
        m = np.asarray(valid, bool)
        src, dst = np.asarray(src)[m], np.asarray(dst)[m]
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    labels = cc_labels_numpy(src, dst, None, n_v)
    parity = np.zeros((n_v,), np.uint8)
    if src.size == 0:
        return labels, parity, False
    known = labels == np.arange(n_v)  # roots seed color 0
    # Each round extends the colored frontier by one hop.
    for _ in range(n_v):
        fwd = known[src] & ~known[dst]
        bwd = known[dst] & ~known[src]
        if not (fwd.any() or bwd.any()):
            break
        parity[dst[fwd]] = parity[src[fwd]] ^ 1
        known[dst[fwd]] = True
        parity[src[bwd]] = parity[dst[bwd]] ^ 1
        known[src[bwd]] = True
    conflict = bool((parity[src] == parity[dst]).any())
    return labels, parity, conflict


def parity_pairs_numpy(src: np.ndarray, dst: np.ndarray,
                       valid: np.ndarray | None, n_v: int):
    """Pure-numpy fallback for the native sparse parity combiner: counted
    (vertex, root, parity) triples + the chunk's odd-cycle flag."""
    if valid is not None:
        m = np.asarray(valid, bool)
        src, dst = np.asarray(src)[m], np.asarray(dst)[m]
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if src.size == 0:
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty(0, np.uint8), False)
    ids = np.unique(np.concatenate([src, dst]))
    if ids[0] < 0 or ids[-1] >= n_v:
        raise ValueError("parity_pairs_numpy: vertex slot out of range")
    ls = np.searchsorted(ids, src)
    ld = np.searchsorted(ids, dst)
    labels, parity, conflict = parity_labels_numpy(ls, ld, None,
                                                   ids.shape[0])
    return (ids.astype(np.int32), ids[labels].astype(np.int32),
            parity.astype(np.uint8), conflict)


def bipartiteness_check(vertex_capacity: int, ingest_combine: bool = True,
                        codec: str = "auto") -> SummaryAggregation:
    """Build the bipartiteness aggregation over ``vertex_capacity`` slots.

    Same signature and plan choice as ``gelly_tpu``'s: ``ingest_combine``
    (default on) attaches the host codec, ``codec`` picks ``"dense"``,
    ``"sparse"`` or ``"auto"`` (sparse iff ``vertex_capacity >= 2^20``);
    ``ingest_combine=False`` builds the raw plan.
    """
    n = vertex_capacity
    sparse = resolve_sparse_codec(codec, n)

    def init(device=DEFAULT_DEVICE) -> BipartiteSummary:
        forest = puf.fresh_parity_forest(n, device)
        return BipartiteSummary(
            forest, torch.zeros_like(forest.parent, dtype=torch.bool))

    def fold(s: BipartiteSummary, chunk) -> BipartiteSummary:
        # Each edge asks for opposite colors (q = 1), the +/- signs of
        # edgeToCandidate.
        q = torch.ones_like(chunk.src, dtype=torch.int32)
        forest = puf.union_edges_parity(s.forest, chunk.src, chunk.dst, q,
                                        chunk.valid)
        seen = segments.mark_seen(s.seen, chunk.src, chunk.valid)
        seen = segments.mark_seen(seen, chunk.dst, chunk.valid)
        return BipartiteSummary(forest, seen)

    def combine(a: BipartiteSummary, b: BipartiteSummary) -> BipartiteSummary:
        return BipartiteSummary(puf.merge_parity_forests(a.forest, b.forest),
                                a.seen | b.seen)

    def merge_stacked(st: BipartiteSummary) -> BipartiteSummary:
        return BipartiteSummary(puf.merge_parity_stack(st.forest),
                                st.seen.any(dim=0))

    def transform(s: BipartiteSummary) -> BipartitenessResult:
        labels, colors = puf.two_coloring(s.forest, s.seen)
        return BipartitenessResult(~s.forest.failed, labels, colors)

    def host_compress(chunk) -> dict:
        src, dst, valid = (to_numpy(chunk.src), to_numpy(chunk.dst),
                           to_numpy(chunk.valid))
        if native.parity_combine_available():
            labels, parity, conflict = native.parity_chunk_combine(
                src, dst, valid, n)
        else:
            labels, parity, conflict = parity_labels_numpy(src, dst, valid, n)
        return {"labels": labels, "parity": parity.astype(np.int8),
                "conflict": np.bool_(conflict)}

    def fold_compressed(s: BipartiteSummary, payload) -> BipartiteSummary:
        # payload: [K, n] stacked chunk forests and parities, [K] conflicts.
        labels = payload["labels"]
        k = labels.shape[0]
        present = (labels >= 0).any(dim=0)
        v = torch.arange(n, dtype=torch.int32,
                         device=labels.device).expand(k, n).reshape(-1)
        lab = labels.reshape(-1)
        ok = lab >= 0
        q = payload["parity"].reshape(-1).to(torch.int32)
        forest = puf.union_edges_parity(
            s.forest._replace(
                failed=s.forest.failed | payload["conflict"].any()),
            v, torch.where(ok, lab, 0), q, ok,
        )
        return BipartiteSummary(forest, s.seen | present)

    def host_compress_sparse(chunk) -> dict:
        src, dst, valid = (to_numpy(chunk.src), to_numpy(chunk.dst),
                           to_numpy(chunk.valid))
        if native.parity_sparse_available():
            v, r, p, conflict = native.parity_chunk_combine_sparse(
                src, dst, valid, n)
        else:
            v, r, p, conflict = parity_pairs_numpy(src, dst, valid, n)
        return {"v": v, "r": r, "p": p.astype(np.int8),
                "conflict": np.bool_(conflict)}

    def stack_sparse(payloads: list, groups: int = 1) -> dict:
        # No group combine: one row per chunk.
        return bucket_stack_payloads(payloads, {"v": -1, "r": 0, "p": 0})

    def fold_compressed_sparse(s: BipartiteSummary,
                               payload) -> BipartiteSummary:
        # payload: K chunks' -1-padded (vertex, root, parity) triples and
        # [K] chunk-local conflict flags.
        v = payload["v"].reshape(-1)
        ok = v >= 0
        vi = torch.where(ok, v, 0)
        q = payload["p"].reshape(-1).to(torch.int32)
        base = s.forest._replace(
            failed=s.forest.failed | payload["conflict"].any())
        union = (puf.union_pairs_parity_compact if 4 * v.numel() <= n
                 else puf.union_edges_parity)
        forest = union(base, vi, payload["r"].reshape(-1), q, ok)
        return BipartiteSummary(forest, segments.mark_seen(s.seen, vi, ok))

    codec_on = ingest_combine
    return SummaryAggregation(
        init=init,
        fold=fold,
        combine=combine,
        transform=transform,
        merge_stacked=merge_stacked,
        host_compress=(
            (host_compress_sparse if sparse else host_compress)
            if codec_on else None
        ),
        fold_compressed=(
            (fold_compressed_sparse if sparse else fold_compressed)
            if codec_on else None
        ),
        stack_payloads=stack_sparse if (codec_on and sparse) else None,
        codec_pad_values=(
            {"v": -1, "r": 0, "p": 0} if (codec_on and sparse) else None
        ),
        codec_payload_check=(
            sparse_payload_id_check(n, "v", "r")
            if (codec_on and sparse) else None
        ),
        fold_accumulates=True,  # parity forests are pure edge-set summaries
        device_fields=("src", "dst", "valid"),  # what the raw fold reads
        name="bipartiteness-check",
    )


def bipartiteness_query(vertex_capacity: int, *, name: str = "bipartiteness",
                        compressed: bool = False, codec: str = "auto"):
    """The fused-engine query form; not ported yet."""
    raise NotImplementedError(
        f"bipartiteness_query is not ported yet: {_BATCHED_ITEM}"
    )


def to_candidates(result: BipartitenessResult, ctx):
    """The reference's observable ``(success, {component root: {vertex:
    sign}})``, with sign True on the root's color side
    (BipartitenessCheckTest); ``(False, {})`` on failure."""
    if not bool(result.ok):
        return False, {}
    lab = to_numpy(result.labels)
    col = to_numpy(result.colors)
    comps: dict[int, dict[int, bool]] = {}
    slots = np.nonzero(lab >= 0)[0]
    raw = ctx.decode(slots)
    for slot, rid in zip(slots.tolist(), raw.tolist()):
        root_raw = int(ctx.decode(np.array([lab[slot]]))[0])
        comps.setdefault(root_raw, {})[rid] = bool(col[slot] == 0)
    return True, comps
