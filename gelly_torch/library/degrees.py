"""Fully-dynamic degrees: the degree aggregate and the degree distribution.

Counterpart of ``gelly_tpu/library/degrees.py``. :func:`degree_aggregate`
is ``getDegrees`` (``SimpleEdgeStream.java:413-478``, BASELINE workload #1)
as a summary aggregation: the summary is the ``int64[n]`` degree vector,
the fold a ±1 endpoint scatter (deletion events count -1), the combine an
elementwise add. Its codecs ship each chunk's net deltas instead of its
edges:

- **dense**: ``i32[n]`` per chunk (the native ``degree_chunk_deltas``),
  summed over the unit in ``int64`` on the device;
- **sparse**: counted (vertex, net-delta) pairs; the stacker sums a unit's
  chunks by vertex in ``int64`` before the device scatter-add.

:class:`DegreeDistributionStream` (``DegreeDistribution.java``) yields the
degree histogram after every chunk. ``degree_aggregate(windowed=W)``
marks the plan for the engine's sliding pane ring (degrees over the last
W merge windows). :class:`ShardedDegrees` stripes the degree vector
over a mesh's shards and routes each endpoint to its owner (the keyed
exchange), with a broadcast fallback for skewed chunks.
:func:`degrees_query` is the plan as a fused multi-query query
(``engine/multiquery.py``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device, to_numpy
from ..core.stream import DEGREE_FIELDS, scatter_degrees
from ..engine.aggregation import (
    SummaryAggregation,
    bucket_stack_payloads,
    group_combine_payloads,
    lane_form_of,
    lane_offsets,
    resolve_sparse_codec,
    sparse_payload_id_check,
)
from ..ops import segments
from ..ops.unionfind import host_sync
from ..utils import native


def degree_aggregate(vertex_capacity: int, count_out: bool = True,
                     count_in: bool = True, ingest_combine: bool = True,
                     codec: str = "auto",
                     windowed: int | None = None) -> SummaryAggregation:
    """The continuous degree aggregate over ``vertex_capacity`` slots.

    Same signature and plan choice as ``gelly_tpu``'s: ``ingest_combine``
    (default on) attaches the delta codec, ``codec`` picks ``"dense"``,
    ``"sparse"`` or ``"auto"`` (sparse iff ``vertex_capacity >= 2^20``);
    ``ingest_combine=False`` builds the raw plan. ``windowed=W`` marks the
    plan for the engine's sliding pane ring: degree vectors add
    elementwise, so panes fold from fresh zeros and the ring sums the
    live suffix.
    """
    if windowed is not None and int(windowed) < 1:
        raise ValueError(f"windowed must be >= 1 pane, got {windowed}")
    n = vertex_capacity
    sparse = resolve_sparse_codec(codec, n)

    def init(device=DEFAULT_DEVICE) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.int64,
                           device=resolve_device(device))

    def fold(deg, chunk):
        return scatter_degrees(deg, chunk, count_out, count_in)

    def host_compress(chunk) -> np.ndarray:
        src, dst = to_numpy(chunk.src), to_numpy(chunk.dst)
        m = to_numpy(chunk.valid)
        ev = to_numpy(chunk.event)
        if native.degree_deltas_available():
            return native.degree_chunk_deltas(
                src, dst, ev if ev.any() else None, None if m.all() else m,
                n, count_out, count_in,
            )
        all_valid = bool(m.all())
        # Insertion-only chunks pass weights=None: np.bincount's integer
        # path, much faster than the float-weights path deletions need.
        if not ev.any():
            sign = None
        else:
            sign = np.where(ev == 1, -1, 1)
            if not all_valid:
                sign = sign[m]
        out = np.zeros((n,), np.int32)
        for on, ids in ((count_out, src), (count_in, dst)):
            if on:
                out += np.bincount(ids if all_valid else ids[m],
                                   weights=sign, minlength=n).astype(np.int32)
        return out

    def fold_compressed(deg, deltas):  # deltas: i32[K, n]
        return deg + deltas.sum(dim=0, dtype=torch.int64)

    def host_compress_sparse(chunk) -> dict:
        src, dst = to_numpy(chunk.src), to_numpy(chunk.dst)
        m = to_numpy(chunk.valid)
        ev = to_numpy(chunk.event)
        if native.degree_sparse_available():
            v, d = native.degree_chunk_deltas_sparse(
                src, dst, ev if ev.any() else None, None if m.all() else m,
                n, count_out, count_in,
            )
        else:
            v, d = degree_pairs_numpy(src, dst, ev, m, n, count_out, count_in)
        return {"v": v, "d": d}

    def stack_sparse(payloads: list, groups: int = 1) -> dict:
        def combine(grp: list) -> dict:
            # A group sums fold_batch chunks' i32 nets: i64 output, the
            # per-chunk bound no longer holds.
            v, d = _sum_deltas(
                np.concatenate([q["v"] for q in grp]),
                np.concatenate([q["d"] for q in grp]).astype(np.int64),
            )
            return {"v": v, "d": d}

        payloads = group_combine_payloads(
            payloads, groups, combine,
            {"v": np.empty(0, np.int32), "d": np.empty(0, np.int64)},
        )
        return bucket_stack_payloads(payloads, {"v": -1, "d": 0})

    def fold_compressed_sparse(deg, payload):
        # payload: {"v": i32[K, cap], "d": int[K, cap]}, -1-padded. "d" is
        # i32 from the per-chunk codec and i64 after the group combine —
        # never narrowed here.
        v = payload["v"].reshape(-1)
        ok = v >= 0
        return segments.masked_scatter_add(
            deg, torch.where(ok, v, 0), payload["d"].reshape(-1), ok)

    codec_on = ingest_combine
    agg = SummaryAggregation(
        init=init,
        fold=fold,
        combine=lambda a, b: a + b,
        transform=None,
        host_compress=(
            (host_compress_sparse if sparse else host_compress)
            if codec_on else None
        ),
        fold_compressed=(
            (fold_compressed_sparse if sparse else fold_compressed)
            if codec_on else None
        ),
        stack_payloads=stack_sparse if (codec_on and sparse) else None,
        codec_pad_values={"v": -1, "d": 0} if (codec_on and sparse) else None,
        codec_payload_check=(
            sparse_payload_id_check(n, "v") if (codec_on and sparse) else None
        ),
        fold_accumulates=True,  # degree vectors add elementwise
        device_fields=DEGREE_FIELDS,
        name="degree-aggregate",
    )
    if windowed is not None:
        agg.windowed_panes = int(windowed)
    else:
        agg.lane_form = _degree_lane_form(agg, n, count_out, count_in)
    return agg


def _degree_lane_form(agg: SummaryAggregation, n: int, count_out: bool,
                      count_in: bool):
    """The plan's lane-offset form (tenant tiers): a ``[L, n]`` stack of
    degree vectors is one vector of ``L * n`` slots once lane ``l``'s ids
    are offset by ``l * n``; integer sums do not depend on the order of
    the scatter, so each lane's row is what the lane alone would give."""

    def fold(deg, chunk):
        off = lane_offsets(deg.shape[0], n, deg.device)
        flat = chunk._replace(
            src=(chunk.src + off).reshape(-1),
            dst=(chunk.dst + off).reshape(-1),
            event=chunk.event.reshape(-1), valid=chunk.valid.reshape(-1))
        return scatter_degrees(deg.reshape(-1), flat, count_out,
                               count_in).view(deg.shape)

    def fold_dense(deg, deltas):  # deltas: i32[L, K, n]
        return deg + deltas.sum(dim=1, dtype=torch.int64)

    def fold_sparse(deg, payload):  # {"v", "d"}: [L, K, cap], -1-padded
        v = payload["v"]
        off = lane_offsets(deg.shape[0], n, deg.device).view(-1, 1, 1)
        ok = v >= 0
        return segments.masked_scatter_add(
            deg.reshape(-1), torch.where(ok, v + off, off).reshape(-1),
            payload["d"].reshape(-1), ok.reshape(-1)).view(deg.shape)

    return lane_form_of(
        agg, fold=fold,
        fold_compressed=(None if agg.fold_compressed is None
                         else fold_sparse if agg.stack_payloads is not None
                         else fold_dense),
        combine=lambda a, b: a + b, transform=None, flatten=None, slots=n)


def degrees_query(vertex_capacity: int, *, name: str = "degrees",
                  count_out: bool = True, count_in: bool = True,
                  compressed: bool = False, codec: str = "auto"):
    """Fuse-compatible degree query (``engine.multiquery.fuse``): the
    ±1-scatter fold (``ingest_combine=False`` by default: the fused
    pipeline stages each chunk once for every query; ``compressed=True``
    keeps the delta codec on for the fused shared codec).
    ``count_out``/``count_in`` pick the direction, so out- and in-degree
    can ride one fused fold as two named queries."""
    from ..engine.multiquery import QuerySpec

    return QuerySpec(
        name=name,
        agg=degree_aggregate(vertex_capacity, count_out=count_out,
                             count_in=count_in,
                             ingest_combine=compressed, codec=codec),
        slot_capacity=vertex_capacity,
    )


def _sum_deltas(ids: np.ndarray, deltas: np.ndarray):
    """Sum deltas by vertex id, dropping zero nets. Accumulates in the
    deltas dtype — callers summing across chunks pass i64."""
    uniq, inv = np.unique(ids, return_inverse=True)
    acc = np.zeros(uniq.shape[0], deltas.dtype)
    np.add.at(acc, inv, deltas)
    nz = acc != 0
    return uniq[nz].astype(np.int32), acc[nz]


def degree_pairs_numpy(src, dst, event, valid, n_v: int,
                       count_out: bool = True, count_in: bool = True):
    """Pure-numpy fallback for the native sparse degree codec: counted
    (vertex, net-delta) pairs, zero nets omitted — a copy of
    ``gelly_tpu``'s."""
    m = None if valid is None else np.asarray(valid, bool)
    ev = None if event is None else np.asarray(event)
    ids_parts, delta_parts = [], []
    for on, col in ((count_out, src), (count_in, dst)):
        if not on:
            continue
        col = np.asarray(col)
        d = (
            np.ones(col.shape[0], np.int64) if ev is None or not ev.any()
            else np.where(ev == 1, -1, 1).astype(np.int64)
        )
        if m is not None and not m.all():
            col, d = col[m], d[m]
        ids_parts.append(col)
        delta_parts.append(d)
    if not ids_parts:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    ids = np.concatenate(ids_parts)
    deltas = np.concatenate(delta_parts)
    if ids.size == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    if ids.min() < 0 or ids.max() >= n_v:
        raise ValueError("degree_pairs_numpy: vertex slot out of range")
    v, d = _sum_deltas(ids, deltas)
    return v, d.astype(np.int32)  # per-chunk nets fit i32 (native parity)


def degree_distribution(stream, max_degree: int | None = None
                        ) -> "DegreeDistributionStream":
    return DegreeDistributionStream(stream, max_degree)


class DegreeDistributionStream:
    """The degree histogram after every chunk (``DegreeDistribution``):
    ``int64[max_degree + 1]``, entry ``d`` the number of vertices of degree
    ``d``; vertices at degree 0 or below are left out, as
    ``VertexDegreeCounts`` removes them. ``max_degree`` defaults to the
    vertex capacity; a chunk that takes a degree past it raises
    ``ValueError`` (one counted host sync a chunk reads the peak)."""

    def __init__(self, stream, max_degree: int | None = None):
        self.stream = stream
        self.max_degree = (
            int(max_degree) if max_degree is not None
            else stream.ctx.vertex_capacity
        )

    def __iter__(self) -> Iterator[torch.Tensor]:
        ctx = self.stream.ctx
        d_max = self.max_degree
        deg = torch.zeros(ctx.vertex_capacity, dtype=torch.int64,
                          device=ctx.device)
        for c in self.stream.device_chunks(DEGREE_FIELDS):
            deg = scatter_degrees(deg, c)
            live = deg > 0
            idx = torch.where(live, deg.clamp(0, d_max), 0)
            hist = torch.zeros(d_max + 1, dtype=torch.int64,
                               device=ctx.device)
            hist = hist.scatter_add(0, idx, live.to(torch.int64))
            peak = host_sync(deg.max())
            if peak > d_max:
                raise ValueError(
                    f"degree {peak} exceeds max_degree {d_max}; "
                    f"raise max_degree"
                )
            yield hist

    def final_distribution(self) -> dict[int, int]:
        hist = None
        for hist in self:
            pass
        if hist is None:
            return {}
        h = hist.cpu().numpy()
        return {int(d): int(h[d]) for d in np.nonzero(h)[0]}


class ShardedDegrees:
    """Vertex-striped degree state over a mesh — the ``keyBy``
    parallelism (the reference co-locates a vertex's edges on one subtask,
    ``M/SimpleEdgeStream.java:492``). Shard ``d`` holds the ``int64``
    degrees of slots ``{g : g % S == d}`` at offset ``g // S``.

    - ``mode="auto"`` (default): the keyed exchange, but a chunk whose
      exchange buckets overflow is left unapplied and replayed through
      the broadcast step (``stats["fallback_chunks"]`` counts them);
    - ``mode="exchange"``: each shard takes an even slice of the chunk
      and one ``all_to_all``
      (:func:`~gelly_torch.parallel.partition.repartition_by_key`)
      delivers every ``(endpoint, ±1)`` to its owner; overflow is counted
      in ``stats["dropped"]`` and raises;
    - ``mode="broadcast"``: every shard scans the whole chunk and keeps
      its owned endpoints.

    Drops are read every 8 chunks (one host read a chunk then), as
    ``gelly_tpu`` checks them.

    On a mesh that spans processes every process iterates the same
    stream: each folds its own shards' stripes, the drop counts are the
    exchange's global sums (the same in every process, so every process
    replays the same chunks), and :meth:`final_degrees` all-gathers the
    stripes, so every process returns the single controller's dict.
    """

    def __init__(self, stream, mesh=None, count_out=True, count_in=True,
                 mode: str = "auto", bucket_slack: float = 2.0):
        from ..parallel import mesh as mesh_lib, partition

        if mode not in ("auto", "exchange", "broadcast"):
            raise ValueError(
                f"mode must be auto/exchange/broadcast, got {mode}")
        self.stream = stream
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh()
        self.count_out = count_out
        self.count_in = count_in
        self.mode = mode
        self.bucket_slack = bucket_slack
        self.stats = {"dropped": 0}
        n = stream.ctx.vertex_capacity
        self.per_shard = partition.slots_per_shard(
            n, mesh_lib.num_shards(self.mesh))

    def _broadcast_step(self, deg: list, chunk) -> list:
        from ..parallel import partition

        S = len(deg)
        out = []
        for me, (d, dev) in enumerate(zip(deg, self.mesh.devices)):
            if dev is None:  # another process's shard
                out.append(None)
                continue
            c = chunk.to_fields(dev, ("src", "dst", "event", "valid"))
            delta = torch.where(c.event == 1, -1, 1).to(torch.int64)
            for on, ends in ((self.count_out, c.src),
                             (self.count_in, c.dst)):
                if on:
                    mine = partition.owned_mask(ends, S, me)
                    d = segments.masked_scatter_add(
                        d, partition.to_local_slot(ends, S), delta,
                        c.valid & mine)
            out.append(d)
        return out

    def _exchange_step(self, deg: list, chunk):
        from ..parallel import partition

        S = len(deg)
        if not (self.count_out or self.count_in):
            # gelly_tpu's jnp.concatenate of no keys raises this.
            raise ValueError("Need at least one array to concatenate.")
        keys, deltas, valids = [], [], []
        for part, dev in zip(partition.split_chunk(chunk, S),
                             self.mesh.devices):
            if dev is None:  # another process's shard
                keys.append(None)
                deltas.append(None)
                valids.append(None)
                continue
            c = part.to_fields(dev, ("src", "dst", "event", "valid"))
            delta = torch.where(c.event == 1, -1, 1).to(torch.int64)
            k, dd, vv = [], [], []
            if self.count_out:
                k.append(c.src)
                dd.append(delta)
                vv.append(c.valid)
            if self.count_in:
                k.append(c.dst)
                dd.append(delta)
                vv.append(c.valid)
            keys.append(torch.cat(k))
            deltas.append(torch.cat(dd))
            valids.append(torch.cat(vv))
        first = self.mesh.local_shards[0]
        cap = partition.default_bucket_capacity(
            keys[first].shape[0], S, self.bucket_slack)
        key_r, dd_r, valid_r, dropped = partition.repartition_by_key(
            self.mesh, keys, deltas, valids, S, cap)
        out = []
        for d, k, dd, v, dr in zip(deg, key_r, dd_r, valid_r, dropped):
            if d is None:
                out.append(None)
                continue
            applied = segments.masked_scatter_add(
                d, partition.to_local_slot(k, S), dd, v)
            # An overflowing chunk is left UNAPPLIED on every shard (the
            # count is global): auto replays it, strict mode raises.
            out.append(torch.where(dr == 0, applied, d))
        return out, dropped[first]

    def final_degrees(self) -> dict[int, int]:
        from ..parallel import partition

        n = self.stream.ctx.vertex_capacity
        S = len(self.mesh.devices)
        mode = self.mode
        deg = [torch.zeros(self.per_shard, dtype=torch.int64, device=dev)
               if dev is not None else None for dev in self.mesh.devices]
        seen = np.zeros((n,), bool)
        pending: list = []  # (chunk, dropped) awaiting the drop check
        self.stats["fallback_chunks"] = 0

        def check_drops():
            nonlocal deg
            dropped_total = 0
            for c, d in pending:
                nd = int(host_sync(d))
                if not nd:
                    continue
                if mode == "auto":
                    # The overflowing chunk was left unapplied: replay it
                    # through the skew-proof broadcast step.
                    deg = self._broadcast_step(deg, c)
                    self.stats["fallback_chunks"] += 1
                else:
                    dropped_total += nd
            pending.clear()
            if dropped_total:
                self.stats["dropped"] += dropped_total
                raise ValueError(
                    f"{dropped_total} endpoint updates overflowed the "
                    f"exchange buckets; raise bucket_slack or use "
                    f"mode='auto' (no silent drops)"
                )

        for i, c in enumerate(self.stream):
            ok = to_numpy(c.valid).astype(bool)
            # An endpoint is "touched" only for the directions counted.
            if self.count_out:
                seen[to_numpy(c.src)[ok]] = True
            if self.count_in:
                seen[to_numpy(c.dst)[ok]] = True
            if mode == "broadcast":
                deg = self._broadcast_step(deg, c)
                continue
            deg, dropped = self._exchange_step(deg, c)
            pending.append((c, dropped))
            if i % 8 == 7:
                check_drops()
        check_drops()
        # De-stripe the shard-concatenated state to global slot order
        # (every process's stripes, gathered in shard order).
        from ..parallel.mesh import all_gather_shards

        out = partition.unstripe(
            torch.cat(all_gather_shards(self.mesh, deg)).numpy(), S)
        slots = np.nonzero(seen)[0]
        raw = self.stream.ctx.decode(slots)
        return {int(r): int(out[s]) for s, r in zip(slots, raw)}


def sharded_degrees(stream, mesh=None, count_out=True, count_in=True,
                    mode: str = "auto", bucket_slack: float = 2.0
                    ) -> ShardedDegrees:
    return ShardedDegrees(stream, mesh, count_out, count_in, mode,
                          bucket_slack)
