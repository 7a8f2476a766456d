"""Streaming k-spanner.

Counterpart of ``gelly_tpu/library/spanner.py`` (``M/library/
Spanner.java:40-118``): keep an edge iff its endpoints are not already
within k hops in the spanner built so far; the cross-window combine
re-gates the smaller spanner's edges while inserting them into the larger
(``CombineSpanners.reduce``). The plans leave ``fold_accumulates`` unset:
they run through the engine's per-window Merger plan.

Two summaries, as in ``gelly_tpu``, with the same fields in the same
order (so checkpoints flatten alike):

- :class:`SpannerSummary` (:func:`spanner`): a dense ``bool[N, N]``
  adjacency plus a fixed-capacity edge list; plain PyTorch (small ``N``);
- :class:`SparseSpannerSummary` (:func:`sparse_spanner`, or
  ``spanner(max_degree=)``): capped-degree ``i32[N, D]`` rows. Its
  sequential gates run on the card as hand kernels
  (:func:`gelly_torch.ops.kernels.sparse_insert_edges` for the per-edge
  fold and the ingest codec's re-gate,
  :func:`~gelly_torch.ops.kernels.sparse_insert_edges_batched` for the
  combine, :func:`~gelly_torch.ops.kernels.sparse_fold_chunk_k2` for
  the ``gate_batch`` fold :func:`_sparse_fold_chunk_k2`), bit for bit
  ``gelly_tpu``'s ``lax.scan`` and ``lax.while_loop``.

Where ``gelly_tpu`` returns new arrays, the folds and combines here update
the summary they are given in place and return it (a Twitter-scale sparse
summary is 1.6 GiB); the engine never reads a summary after passing it to
a fold, and clones an emission that has no ``transform``.
:class:`HostSpannerStream` is the native host spanner
(``native/spanner.cc``), unchanged.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device, to_numpy
from ..engine.aggregation import SummaryAggregation
from ..ops import kernels
from ..ops.rowtable import put_where_, row_append_batch
from ..utils import native


class SpannerSummary(NamedTuple):
    adj: torch.Tensor  # bool[N, N] spanner adjacency (undirected)
    esrc: torch.Tensor  # i32[E] accepted edges, insertion order
    edst: torch.Tensor  # i32[E]
    n: torch.Tensor  # i32[] number of accepted edges
    overflow: torch.Tensor  # bool[] edge-list capacity exceeded (sticky)


def _within_k(adj: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              k: int) -> torch.Tensor:
    """``dist(u[i], v[i]) <= k`` in ``adj`` for each candidate (``bool[B]``;
    ``u``, ``v`` 1-D): k rounds of frontier expansion, the frontier's
    neighbours taken as a 0/1 product (exact: counts stay below 2^24)."""
    n = adj.shape[0]
    B = u.shape[0]
    f = torch.zeros((B, n), dtype=torch.bool, device=adj.device)
    f[torch.arange(B, device=adj.device), u.long()] = True
    a = adj.to(torch.float32)
    for _ in range(k):
        f = f | ((f.to(torch.float32) @ a) > 0)
    return f.gather(1, v.long()[:, None])[:, 0]


def _insert_edges(summary: SpannerSummary, src, dst, valid, k: int
                  ) -> SpannerSummary:
    """Gate and insert the lanes one at a time, in order (the dense plan's
    fold; plain PyTorch, one host read of the lanes). Updates ``summary``
    in place and returns it."""
    adj = summary.adj
    # The dense gate walks the lanes on the host by design.
    live = (valid.cpu() & (src.cpu() != dst.cpu())).nonzero().flatten()  # graphlint: disable=GL003 -- one read of the lanes a chunk
    for i in live.tolist():
        u, v = src[i:i + 1], dst[i:i + 1]  # index without a host sync
        take = ~_within_k(adj, u, v, k)
        adj[u, v] = adj[u, v] | take
        adj[v, u] = adj[v, u] | take
        kernels.append_edges_plain(summary.esrc, summary.edst, summary.n,
                                   summary.overflow, u, v, take)
    return summary


def _insert_edges_batched(s: SpannerSummary, esrc, edst, n_valid,
                          k: int, batch: int = 64) -> SpannerSummary:
    """Dense analog of :func:`_sparse_insert_edges_batched` — the combine's
    batch gate (same batch size and candidate order). Updates ``s`` in
    place and returns it."""
    n = s.adj.shape[0]
    flat = s.adj.view(-1)
    true = torch.ones(batch, dtype=torch.bool, device=s.adj.device)
    for u, v, ok in kernels.batches_plain(esrc, edst, n_valid, batch):
        take = ok & (u != v) & ~_within_k(s.adj, u, v, k)
        put_where_(flat, u.long() * n + v.long(), true, take)
        put_where_(flat, v.long() * n + u.long(), true, take)
        kernels.append_edges_plain(s.esrc, s.edst, s.n, s.overflow, u, v,
                                   take)
    return s


# ------------------------------------------------------------------ #
# sparse (capped-degree) spanner — the N >= 1M path


class SparseSpannerSummary(NamedTuple):
    nbr: torch.Tensor  # i32[N, D] spanner adjacency rows (-1 empty)
    deg: torch.Tensor  # i32[N]
    esrc: torch.Tensor  # i32[E] accepted edges, insertion order
    edst: torch.Tensor  # i32[E]
    n: torch.Tensor  # i32[] accepted edges
    overflow: torch.Tensor  # bool[] edge-list capacity exceeded (sticky)
    deg_overflow: torch.Tensor  # i32[] adjacency inserts dropped by the cap


# boundedBFS over capped-degree rows with a bounded frontier, for each
# candidate of the 1-D u, v: a frontier or degree overflow can only
# under-report reachability (an extra accepted edge, never a broken
# stretch bound).
_within_k_sparse = kernels.within_k_sparse_plain


def _fields(s: SparseSpannerSummary):
    return (s.nbr, s.deg, s.deg_overflow, s.esrc, s.edst, s.n, s.overflow)


def _sparse_insert_edges(s: SparseSpannerSummary, src, dst, valid, k: int,
                         max_degree: int, frontier_cap: int
                         ) -> SparseSpannerSummary:
    """Sequential gate-and-insert over the capped-degree table (in place):
    entry 1 of the gate kernel on the card, its plain version on the
    CPU."""
    kernels.sparse_insert_edges(*_fields(s), src, dst, valid, k,
                                max_degree, frontier_cap)
    return s


def _sparse_fold_chunk_k2(s: SparseSpannerSummary, src, dst, valid,
                          max_degree: int, sub: int
                          ) -> SparseSpannerSummary:
    """Whole-chunk batched gate for k == 2 (``gate_batch``): ``dist(u, v)
    <= 2`` iff v is a direct neighbour of u or the two rows share an
    entry — one D x D row intersection per candidate. The chunk folds in
    ``sub``-lane sub-batches, each gated against the adjacency including
    every earlier sub-batch's acceptances; a sub-batch accepts all its
    gate-passers at once (exact duplicates deduped by the ``int64`` key
    ``min * N + max``). The hand kernel ``csrc/spanner_fold_k2.cu`` on the
    card, its plain version on the CPU; updates ``s`` in place and returns
    it."""
    kernels.sparse_fold_chunk_k2(*_fields(s), src, dst, valid, max_degree,
                                 sub)
    return s


# Batched row append, conflicting appends to one row in consecutive slots.
_row_append_batch = row_append_batch


def _sparse_insert_edges_batched(s: SparseSpannerSummary, esrc, edst,
                                 n_valid, k: int, max_degree: int,
                                 frontier_cap: int,
                                 batch: int = 64) -> SparseSpannerSummary:
    """Batch-gated combine insert: gate ``batch`` candidates at once
    against the current adjacency, accept every candidate the gate clears,
    insert, advance, until ``min(n_valid, len(esrc))`` — cost ∝ the
    donor's accepted edges. ``n_valid`` is the donor's 0-d ``n``. Entry 2
    of the gate kernel on the card (the whole loop in one launch), its
    plain version on the CPU; in place."""
    kernels.sparse_insert_edges_batched(*_fields(s), esrc, edst, n_valid, k,
                                        max_degree, frontier_cap, batch)
    return s


def _big_small(a, b):
    """``(big, small)``: merge the smaller spanner into the larger, ``a``
    when ``a.n >= b.n`` (one host read)."""
    return (a, b) if bool(a.n >= b.n) else (b, a)  # graphlint: disable=GL003 -- the merge direction, one read a combine


def sparse_spanner(vertex_capacity: int, k: int, max_degree: int,
                   max_edges: int | None = None,
                   frontier_cap: int | None = None,
                   ingest_combine: bool = False,
                   payload_cap: int | None = None,
                   local_degree: int | None = None,
                   gate_batch: int | None = None) -> SummaryAggregation:
    """k-spanner over a capped-degree adjacency: O(N*D) memory instead of
    the dense path's O(N^2). Degree/frontier caps degrade conservatively
    (extra accepted edges, never a broken stretch bound); ``deg_overflow``
    counts how often. ``ingest_combine`` attaches the chunk-local spanner
    codec (native toolchain; explicit ``payload_cap``); ``gate_batch``
    (k == 2 only) folds with :func:`_sparse_fold_chunk_k2`. Same plan
    choices and errors as ``gelly_tpu``'s."""
    n = vertex_capacity
    D = max_degree
    if gate_batch is not None and k != 2:
        raise ValueError(
            "gate_batch uses the closed-form distance-2 gate; only k == 2 "
            "is supported (general k runs the BFS gate)"
        )
    e_cap = max_edges if max_edges is not None else 4 * n
    F = frontier_cap if frontier_cap is not None else max(32, 4 * D)

    def init(device=DEFAULT_DEVICE) -> SparseSpannerSummary:
        dev = resolve_device(device)
        return SparseSpannerSummary(
            nbr=torch.full((n, D), -1, dtype=torch.int32, device=dev),
            deg=torch.zeros(n, dtype=torch.int32, device=dev),
            esrc=torch.zeros(e_cap, dtype=torch.int32, device=dev),
            edst=torch.zeros(e_cap, dtype=torch.int32, device=dev),
            n=torch.zeros((), dtype=torch.int32, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            deg_overflow=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def fold(s, chunk):
        if gate_batch is not None:
            return _sparse_fold_chunk_k2(
                s, chunk.src, chunk.dst, chunk.valid, D, gate_batch
            )
        return _sparse_insert_edges(
            s, chunk.src, chunk.dst, chunk.valid, k, D, F
        )

    def combine(a, b):
        # Merge smaller into larger (CombineSpanners.reduce), batch
        # re-gating the donor's accepted edges.
        big, small = _big_small(a, b)
        big = _sparse_insert_edges_batched(
            big, small.esrc, small.edst, small.n, k, D, F
        )
        big.overflow.logical_or_(small.overflow)
        big.deg_overflow.add_(small.deg_overflow)
        return big

    hc = fc = None
    if ingest_combine:
        if payload_cap is None:
            raise ValueError(
                "ingest_combine requires an explicit payload_cap (bound "
                "the chunk-local spanner size; device re-gate cost and "
                "wire bytes scale with it)"
            )
        if native.available("spanner"):
            def _insert_payload(st, pl):
                out = _sparse_insert_edges(
                    st, pl["src"], pl["dst"], pl["valid"], k, D, F
                )
                out.deg_overflow.add_(pl["dover"])
                return out

            hc, fc = _spanner_codec(
                k, payload_cap, n,
                local_degree if local_degree is not None else max(128, D),
                _insert_payload,
            )
    return SummaryAggregation(
        init=init,
        fold=fold,
        combine=combine,
        transform=None,
        host_compress=hc,
        fold_compressed=fc,
        device_fields=("src", "dst", "valid"),  # what the raw fold reads
        name=f"sparse-spanner-k{k}",
    )


def _spanner_codec(k: int, payload_cap: int, n_v: int, local_degree: int,
                   insert_fn):
    """``(host_compress, fold_compressed)`` of the spanner ingest codec:
    each chunk reduces on the host to its chunk-local spanner (the native
    fold, per-thread reused buffers), and the device re-gates only those
    edges, payload by payload in batch order. The payload carries the
    chunk's local degree-cap overflow count (``dover``)."""
    tls = threading.local()

    def host_compress(chunk):
        h = chunk.to_numpy()
        st = getattr(tls, "st", None)
        if st is None:
            st = tls.st = {
                "nbr": np.full((n_v, local_degree), -1, np.int32),
                "deg": np.zeros((n_v,), np.int32),
                "stamp": np.zeros((n_v,), np.int32),
                "meta": np.zeros((3,), np.int64),
            }
        # Per-chunk logical reset without touching the big buffers: rows
        # past deg[u] are never read, and the stamp epoch (meta[0])
        # persists across chunks by design.
        st["deg"][:] = 0
        st["meta"][1] = 0
        dover0 = int(st["meta"][2])
        psrc = np.zeros((payload_cap,), np.int32)
        pdst = np.zeros((payload_cap,), np.int32)
        try:
            native.spanner_chunk_fold(
                h.src, h.dst, h.valid, n_v, k, local_degree,
                st["nbr"], st["deg"], st["stamp"], st["meta"], psrc, pdst,
            )
        except ValueError as e:
            if "overflow" in str(e):
                raise ValueError(
                    f"chunk-local spanner exceeded payload_cap="
                    f"{payload_cap}; raise it (or disable ingest_combine)"
                ) from e
            raise
        m = int(st["meta"][1])
        pvalid = np.zeros((payload_cap,), bool)
        pvalid[:m] = True
        return {
            "src": psrc, "dst": pdst, "valid": pvalid,
            "dover": np.int32(int(st["meta"][2]) - dover0),
        }

    def fold_compressed(s, payload):
        # Leaves are [K, ...]: re-gate each chunk-local spanner into the
        # summary, in batch order (CombineSpanners semantics).
        for i in range(payload["src"].shape[0]):
            s = insert_fn(s, {key: x[i] for key, x in payload.items()})
        return s

    return host_compress, fold_compressed


def spanner(vertex_capacity: int, k: int,
            max_edges: int | None = None,
            max_degree: int | None = None,
            ingest_combine: bool = False,
            payload_cap: int | None = None,
            local_degree: int = 128,
            gate_batch: int | None = None) -> SummaryAggregation:
    """Build the k-spanner aggregation (``Spanner.java``'s (window, k); the
    merge cadence is the engine's ``merge_every``). ``max_degree`` switches
    to the capped-degree :func:`sparse_spanner`. ``ingest_combine``
    (needs the native toolchain and an explicit ``payload_cap``) attaches
    the spanner codec; each re-gate level relaxes the stretch bound by a
    factor of k. Same plans and errors as ``gelly_tpu``'s."""
    if max_degree is not None:
        return sparse_spanner(vertex_capacity, k, max_degree, max_edges,
                              ingest_combine=ingest_combine,
                              payload_cap=payload_cap,
                              local_degree=local_degree,
                              gate_batch=gate_batch)
    n = vertex_capacity
    e_cap = max_edges if max_edges is not None else 4 * n
    if ingest_combine and payload_cap is None:
        raise ValueError(
            "ingest_combine requires an explicit payload_cap (bound the "
            "chunk-local spanner size; device re-gate cost and wire bytes "
            "scale with it)"
        )

    def init(device=DEFAULT_DEVICE) -> SpannerSummary:
        dev = resolve_device(device)
        return SpannerSummary(
            adj=torch.zeros((n, n), dtype=torch.bool, device=dev),
            esrc=torch.zeros(e_cap, dtype=torch.int32, device=dev),
            edst=torch.zeros(e_cap, dtype=torch.int32, device=dev),
            n=torch.zeros((), dtype=torch.int32, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
        )

    def fold(s: SpannerSummary, chunk) -> SpannerSummary:
        return _insert_edges(s, chunk.src, chunk.dst, chunk.valid, k)

    def combine(a: SpannerSummary, b: SpannerSummary) -> SpannerSummary:
        big, small = _big_small(a, b)
        big = _insert_edges_batched(big, small.esrc, small.edst, small.n, k)
        big.overflow.logical_or_(small.overflow)
        return big

    hc = fc = None
    if ingest_combine and native.available("spanner"):
        # The dense summary has no deg_overflow field; the chunk-local
        # degree cap's count is dropped here, as in gelly_tpu.
        hc, fc = _spanner_codec(
            k, payload_cap, n, local_degree,
            lambda st, pl: _insert_edges(
                st, pl["src"], pl["dst"], pl["valid"], k
            ),
        )
    return SummaryAggregation(
        init=init,
        fold=fold,
        combine=combine,
        transform=None,
        host_compress=hc,
        fold_compressed=fc,
        device_fields=("src", "dst", "valid"),  # what the raw fold reads
        name=f"spanner-k{k}",
    )


def spanner_query(vertex_capacity: int, k: int, *, name: str = "spanner",
                  every: int = 1, max_edges: int | None = None,
                  max_degree: int | None = None,
                  gate_batch: int | None = None):
    """Fuse-compatible k-spanner query (``engine.multiquery.fuse``).

    The spanner is the one non-accumulating plan of the library quartet:
    the fused plan carries ``{local, global}`` sub-state and runs the
    cross-window merge (``CombineSpanners``) in the fused fold every
    ``every`` chunks, the query's own merge window. Its emission is
    ``combine(local, global)`` on copies (merge-on-read), so the window's
    tail is always included, as in the standalone plan."""
    from ..engine.multiquery import QuerySpec

    return QuerySpec(
        name=name,
        agg=spanner(vertex_capacity, k, max_edges=max_edges,
                    max_degree=max_degree, gate_batch=gate_batch),
        every=every,
        slot_capacity=vertex_capacity,
    )


class HostSpannerStream:
    """Centralized native host spanner (``native/spanner.cc``): the
    order-exact fast path for the sequential fold, with ``max_degree`` at
    least the spanner's true max degree equal to the dense plan's accepted
    list. Host numpy state; the stream's chunks are read on the host."""

    def __init__(self, stream, k: int, max_degree: int = 64,
                 max_edges: int | None = None):
        if not native.available("spanner"):
            raise RuntimeError(
                "native spanner kernel unavailable (no toolchain); use "
                "spanner()/sparse_spanner() through stream.aggregate()"
            )
        self.stream = stream
        self.k = k
        self.max_degree = max_degree
        n = stream.ctx.vertex_capacity
        self.e_cap = max_edges if max_edges is not None else 4 * n
        self._nbr = np.full((n, max_degree), -1, np.int32)
        self._deg = np.zeros((n,), np.int32)
        self._stamp = np.zeros((n,), np.int32)
        self._meta = np.zeros((3,), np.int64)
        self._esrc = np.zeros((self.e_cap,), np.int32)
        self._edst = np.zeros((self.e_cap,), np.int32)
        self._drained = False
        self._failed: Exception | None = None

    def _drain(self):
        if self._drained:
            return
        if self._failed is not None:
            # Re-draining would re-fold the restarted stream into the
            # already-populated state: fail fast.
            raise RuntimeError(
                "spanner fold previously failed; build a new "
                "HostSpannerStream (with a larger max_edges) and re-run"
            ) from self._failed
        n = self.stream.ctx.vertex_capacity
        try:
            for c in self.stream:
                h = c.to_numpy()
                native.spanner_chunk_fold(
                    h.src, h.dst, h.valid, n, self.k, self.max_degree,
                    self._nbr, self._deg, self._stamp, self._meta,
                    self._esrc, self._edst,
                )
        except Exception as e:
            self._failed = e
            raise
        self._drained = True

    @property
    def deg_overflow(self) -> int:
        """Row inserts dropped by the degree cap."""
        self._drain()
        return int(self._meta[2])

    def final_edges(self) -> list[tuple[int, int]]:
        """Accepted edges as raw-id pairs, insertion order."""
        self._drain()
        m = int(self._meta[1])
        src = self.stream.ctx.decode(self._esrc[:m])
        dst = self.stream.ctx.decode(self._edst[:m])
        return list(zip(src.tolist(), dst.tolist()))


def host_spanner(stream, k: int, max_degree: int = 64,
                 max_edges: int | None = None) -> HostSpannerStream:
    return HostSpannerStream(stream, k, max_degree, max_edges)


def spanner_edges(summary, ctx) -> list[tuple[int, int]]:
    """Decode the accepted edge list to raw-id pairs, set-deduped (the
    sparse path can re-take an edge whose row inserts the degree cap
    dropped), in insertion order."""
    if bool(summary.overflow):
        raise RuntimeError("spanner edge list overflowed; raise max_edges")
    m = int(summary.n)
    src = to_numpy(summary.esrc[:m])
    dst = to_numpy(summary.edst[:m])
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    _, first = np.unique(lo.astype(np.int64) * (1 << 32) + hi,
                         return_index=True)
    keep = np.sort(first)  # preserve insertion order
    src = ctx.decode(src[keep])
    dst = ctx.decode(dst[keep])
    return list(zip(src.tolist(), dst.tolist()))
