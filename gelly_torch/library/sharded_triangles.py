"""Mesh-sharded EXACT triangle counting — vertex-striped adjacency state.

Counterpart of ``gelly_tpu/library/sharded_triangles.py``, the reference's
keyed ``ExactTriangleCount`` (``M/example/ExactTriangleCount.java:74-134``)
over a vertex-striped mesh:

- the capped-degree arrival-index table (``SparseTriangleCounts``' ``nbr``
  / ``aidx`` / ``deg`` rows) is striped over the shards: shard ``d`` owns
  the rows of slots ``{g : g % S == d}``;
- each chunk runs three keyed routes:

  1. **presence + append**: both directions go to their row owners
     through :func:`~gelly_torch.parallel.partition.repartition_by_key`
     (its order decides the in-row append order, so it is kept exactly);
     owners test presence, append fresh edges, and answer the canonical
     direction's freshness;
  2. **row fetch**: each fresh canonical edge ``(a, b)`` asks ``b``'s
     owner for row(b) and delivers it to ``a``'s owner;
  3. **counts**: ``a``'s owner intersects row(a) with row(b) under the
     arrival-index rule (only earlier edges close a triangle) and routes
     the ``b``-side and common-vertex increments to their owners.

Steps 2 and 3 only add integers, so the port routes just their live
entries (variable-length, in shard order) where ``gelly_tpu`` scatters
into worst-case ``S * L`` buckets of ``[L, D]`` rows; and it intersects
two rows with one sort and a ``searchsorted`` a row (a row's live
neighbours are distinct) where ``gelly_tpu`` compares ``D x D`` pairs.
Counts equal ``gelly_tpu``'s and :class:`SparseExactTriangleStream`'s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.segments import INT_MAX
from ..parallel import mesh as mesh_lib
from ..parallel.partition import (
    all_to_all,
    owner_of,
    psum_scalar,
    repartition_by_key,
    slots_per_shard,
    to_local_slot,
    unstripe,
)
from .triangles import _row_append

# Rows of a [R, D] gather taken at once (bounds the transient memory).
_ROW_SLAB_BYTES = 1 << 28


def _route(mesh, keys: list, payloads: list, valids: list,
           num_shards: int):
    """Deliver every VALID entry to the shard owning its key: shard ``j``
    gets, in shard order, each sender's entries for ``j`` in lane order.
    ``payloads`` is a list (a shard) of tuples of ``[L, ...]`` tensors."""
    out_k = [[] for _ in range(num_shards)]
    out_p = [[] for _ in range(num_shards)]
    for k, p, v in zip(keys, payloads, valids):
        own = owner_of(k, num_shards)
        for j, dev in enumerate(mesh.devices):
            sel = v & (own == j)
            out_k[j].append(k[sel].to(dev))
            out_p[j].append(tuple(x[sel].to(dev) for x in p))
    keys_r = [torch.cat(ks) for ks in out_k]
    pays_r = [tuple(torch.cat([p[i] for p in ps])
                    for i in range(len(ps[0]))) for ps in out_p]
    return keys_r, pays_r


def _present(nbr_loc: torch.Tensor, loc: torch.Tensor,
             other: torch.Tensor) -> torch.Tensor:
    """``any(nbr_loc[loc] == other[:, None], axis=1)``, in row slabs."""
    d = nbr_loc.shape[1]
    slab = max(1, _ROW_SLAB_BYTES // (4 * d))
    out = []
    for lo in range(0, loc.shape[0], slab):
        rows = nbr_loc[loc[lo:lo + slab].long()]
        out.append((rows == other[lo:lo + slab, None]).any(dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.bool, device=nbr_loc.device)
    return torch.cat(out)


def _intersect(rowa_nbr, rowa_aidx, rowb_nbr, rowb_aidx, lim):
    """Per row pair, the row(a) entries whose neighbour also sits in
    row(b), both arrived before ``lim``: ``(hits bool[R, D], c_e
    i64[R])``. A row's live neighbours are distinct, so this is
    ``gelly_tpu``'s ``D x D`` match summed over row(b)."""
    ok_u = (rowa_nbr >= 0) & (rowa_aidx < lim)
    ok_v = (rowb_nbr >= 0) & (rowb_aidx < lim)
    bs = torch.sort(torch.where(ok_v, rowb_nbr, INT_MAX), dim=1).values
    probe = torch.where(ok_u, rowa_nbr, -2).contiguous()
    pos = torch.searchsorted(bs, probe).clamp(max=bs.shape[1] - 1)
    hits = ok_u & (bs.gather(1, pos) == probe)
    return hits, hits.sum(dim=1, dtype=torch.int64)


def _sharded_exact_chunk(mesh, nbr, aidx, deg, counts, a, b, idx, ok,
                         num_shards: int, max_degree: int):
    """One chunk over every shard: ``a < b`` canonical pairs (deduped in
    the chunk on the host), ``idx`` their arrival indices, all lists of S
    per-shard ``[L]`` tensors. Updates the stripes in place; returns the
    global overflow count and the total's delta (ints)."""
    S, D = num_shards, max_degree
    per = nbr[0].shape[0]
    L = a[0].shape[0]
    devs = mesh.devices

    # Phase 1: presence check + append, both directions.
    k2, pay2, ok2 = [], [], []
    for me in range(S):
        lane = me * L + torch.arange(L, dtype=torch.int32, device=devs[me])
        k2.append(torch.cat([a[me], b[me]]))
        pay2.append((torch.cat([b[me], a[me]]),
                     torch.cat([idx[me], idx[me]]),
                     torch.cat([lane, torch.full_like(lane, -1)])))
        ok2.append(torch.cat([ok[me], ok[me]]))
    k_r, pl_r, ok_r, _ = repartition_by_key(mesh, k2, pay2, ok2, S, 2 * L)
    overflow = []
    back_ok, back_lane, back_fresh = [], [], []
    for me in range(S):
        o_r, i_r, lane_r = pl_r[me]
        loc_r = to_local_slot(torch.where(ok_r[me], k_r[me], 0), S)
        present = _present(nbr[me], loc_r, o_r) & ok_r[me]
        fresh_r = ok_r[me] & ~present
        _, _, _, ov = _row_append(
            nbr[me], aidx[me], deg[me],
            torch.zeros((), dtype=torch.int32, device=devs[me]),
            loc_r, o_r, torch.where(fresh_r, i_r, INT_MAX), fresh_r, D)
        overflow.append(ov)
        back_ok.append(ok_r[me] & (lane_r >= 0))
        back_lane.append(lane_r)
        back_fresh.append(fresh_r)
    back_ok = all_to_all(mesh, back_ok, S)
    back_lane = all_to_all(mesh, back_lane, S)
    back_fresh = all_to_all(mesh, back_fresh, S)
    fresh = []
    for me in range(S):
        my_lane = torch.where(back_ok[me], back_lane[me] - me * L, L)
        f = torch.zeros(L + 1, dtype=torch.bool, device=devs[me])
        f[my_lane.long()] = back_fresh[me]
        fresh.append(f[:L] & ok[me])

    # Phase 2: fetch row(b) to owner(a).
    kb, plb = _route(mesh, b, [(a[me], idx[me]) for me in range(S)],
                     fresh, S)
    fetched_k, fetched_p = [], []
    for me in range(S):
        a_r, idx_r = plb[me]
        locb = to_local_slot(kb[me], S).long()
        fetched_k.append(a_r)
        fetched_p.append((kb[me], idx_r, nbr[me][locb], aidx[me][locb]))
    ka, pla = _route(mesh, fetched_k, fetched_p,
                     [torch.ones_like(k, dtype=torch.bool)
                      for k in fetched_k], S)

    # Phase 3: intersect at owner(a); a-side counts locally, b-side and
    # common-vertex increments routed to their owners.
    upd_k, upd_v, upd_ok, total = [], [], [], []
    for me in range(S):
        b_f, idx_f, rbn, rba = pla[me]
        loca = to_local_slot(ka[me], S).long()
        rowa_nbr = nbr[me][loca]
        hits, c_e = _intersect(rowa_nbr, aidx[me][loca], rbn, rba,
                               idx_f[:, None])
        counts[me].index_add_(0, loca, c_e)
        upd_k.append(torch.cat([b_f, rowa_nbr.reshape(-1)]))
        upd_v.append((torch.cat([c_e, hits.reshape(-1).to(torch.int64)]),))
        upd_ok.append(torch.cat([c_e > 0, hits.reshape(-1)]))
        total.append(c_e.sum())
    ku, vu = _route(mesh, upd_k, upd_v, upd_ok, S)
    for me in range(S):
        counts[me].index_add_(0, to_local_slot(ku[me], S).long(), vu[me][0])
    return (int(psum_scalar(mesh, [o.to(torch.int64) for o in overflow])[0]),
            int(psum_scalar(mesh, total)[0]))


class ShardedExactTriangles:
    """Streaming exact triangle counts over a vertex-striped mesh.

    ``run()`` consumes the stream; ``final_counts()`` returns the
    per-vertex counts by raw id with key ``-1`` = the global total, equal
    to :func:`~gelly_torch.library.triangles.exact_triangle_count`'s.
    ``nbr`` / ``aidx`` / ``deg`` / ``counts`` are lists of S per-shard
    stripes. Degree overflow raises at the fold that overflowed (a dropped
    adjacency entry could hide triangles)."""

    def __init__(self, stream, max_degree: int, capacity: int | None = None,
                 mesh=None):
        self.stream = stream
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh()
        self.S = mesh_lib.num_shards(self.mesh)
        self.n = capacity or stream.ctx.vertex_capacity
        self.per = slots_per_shard(self.n, self.S)
        self.D = max_degree
        per, D = self.per, self.D
        devs = self.mesh.devices
        self.nbr = [torch.full((per, D), -1, dtype=torch.int32, device=d)
                    for d in devs]
        self.aidx = [torch.full((per, D), INT_MAX, dtype=torch.int32,
                                device=d) for d in devs]
        self.deg = [torch.zeros(per, dtype=torch.int32, device=d)
                    for d in devs]
        self.counts = [torch.zeros(per, dtype=torch.int64, device=d)
                       for d in devs]
        self.total = 0
        self.n_seen = 0
        self.overflow = 0

    def _fold_chunk(self, chunk) -> None:
        src = chunk.src.cpu().numpy()
        dst = chunk.dst.cpu().numpy()
        okc = chunk.valid.cpu().numpy()
        # Host prep as the single-device step: arrival indices count every
        # valid lane; canonical orientation; in-chunk dedup (presence
        # against earlier chunks is phase 1's job).
        arrivals = self.n_seen + np.cumsum(okc.astype(np.int64)) - 1
        self.n_seen += int(okc.sum())
        a = np.minimum(src, dst).astype(np.int32)
        b = np.maximum(src, dst).astype(np.int32)
        ok = okc & (a != b)
        pack = a.astype(np.int64) * self.n + b
        seen_first = np.zeros(ok.shape, bool)
        if ok.any():
            _, first_pos = np.unique(pack[ok], return_index=True)
            live_pos = np.nonzero(ok)[0]
            seen_first[live_pos[first_pos]] = True
        ok = ok & seen_first
        if ok.any() and (a[ok].min() < 0 or b[ok].max() >= self.n):
            raise ValueError("vertex slot out of range")
        S = self.S
        L = -(-a.shape[0] // S)
        pad = L * S - a.shape[0]
        if pad:
            a = np.concatenate([a, np.zeros(pad, np.int32)])
            b = np.concatenate([b, np.zeros(pad, np.int32)])
            arrivals = np.concatenate([arrivals, np.zeros(pad, np.int64)])
            ok = np.concatenate([ok, np.zeros(pad, bool)])

        def shards(x):
            x = torch.from_numpy(np.ascontiguousarray(x.reshape(S, L)))
            return [x[i].to(dev) for i, dev in enumerate(self.mesh.devices)]

        ov, td = _sharded_exact_chunk(
            self.mesh, self.nbr, self.aidx, self.deg, self.counts,
            shards(a), shards(b), shards(arrivals.astype(np.int32)),
            shards(ok), S, self.D)
        self.overflow += ov
        if self.overflow:
            raise ValueError(
                f"adjacency rows overflowed max_degree={self.D} "
                f"({self.overflow} entries dropped); raise max_degree"
            )
        self.total += td

    def run(self) -> "ShardedExactTriangles":
        for chunk in self.stream:
            self._fold_chunk(chunk)
        return self

    def final_counts(self) -> dict[int, int]:
        """Per-vertex counts by raw id, key ``-1`` the global total (the
        reference's ``(-1, count)`` marker,
        ``M/example/ExactTriangleCount.java:112``)."""
        counts = unstripe(torch.cat([c.cpu() for c in self.counts]).numpy(),
                          self.S)
        out = {-1: int(self.total)}
        nz = np.nonzero(counts)[0]
        raw = self.stream.ctx.decode(nz)
        for s, r in zip(nz.tolist(), raw.tolist()):
            out[int(r)] = int(counts[s])
        return out
