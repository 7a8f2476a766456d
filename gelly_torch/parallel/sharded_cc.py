"""Slot-sharded Connected Components — vertex-partitioned summary state.

Counterpart of ``gelly_tpu/parallel/sharded_cc.py``. Every other CC plan
holds the whole ``parent[vertex_capacity]`` forest on each shard; here
shard ``d`` of an S-shard mesh owns the striped slots ``{g : g % S == d}``
(``partition.owner_of``) and holds only

  ``parent_loc: i32[capacity / S]`` — global parent pointer per owned slot
  ``seen_loc:   bool[capacity / S]`` — owned slots observed in the stream
  ``dirty_loc:  bool[capacity / S]`` — owned entries changed since the
  last emission

(the reference's keyed state layout, ``M/SimpleEdgeStream.java:157-158``).
A fold of a pair batch routes every request over the keyed exchange
(:func:`~gelly_torch.parallel.partition.repartition_by_key`):

1. both endpoints' labels chase to TRUE roots by owner lookups (a level
   is a request and a response ``all_to_all``);
2. root-to-root hooks ``(hi, lo)`` route to ``hi``'s owner and apply as a
   scatter-min masked to self-roots (add-only);
3. repeat while any pair is live.

``gelly_tpu`` runs the loops as ``lax.while_loop`` s on a ``psum``-ed flag;
the port runs each round as per-shard work, the collectives, and one host
read of the global flag (counted by ``unionfind.host_sync``; ``stats``
counts the hook rounds and chase levels). Emission (:meth:`ShardedCC.
labels`) pulls only the dirty rows and resolves them against host root
and seen caches of the previous emission.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import bus as obs_bus
from ..ops.segments import INT_MAX
from ..ops.unionfind import host_sync
from . import collectives
from .mesh import make_mesh, num_shards as _num_shards, require_one_process
from .partition import (
    all_to_all,
    psum_scalar,
    repartition_by_key,
    slots_per_shard,
    to_local_slot,
)


def _scatter_set(L: int, idx: torch.Tensor, ok: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``zeros(L).at[where(ok, idx, L)].set(vals, mode="drop")``."""
    out = vals.new_zeros(L + 1)
    out[torch.where(ok, idx, L).long()] = vals
    return out[:L]


def sharded_lookup(mesh, state_locs: list, slots: list, valids: list,
                   num_shards: int, bucket_capacity: int):
    """Value of each global slot over the sharded state: queries route to
    their owners (keyed exchange), gather there, and route back.

    Returns ``(values, answered, dropped)`` (lists of S per-shard values);
    ``answered`` is False where the query was invalid or overflowed a
    bucket (counted in the global ``dropped``): such lanes keep value 0
    and the caller retries next round."""
    Ls = [s.shape[0] for s in slots]
    idx = [torch.arange(L, dtype=torch.int32, device=s.device)
           for L, s in zip(Ls, slots)]
    k, home, ok, dropped = repartition_by_key(
        mesh, slots, idx, valids, num_shards, bucket_capacity)
    vals = [torch.where(o, st[to_local_slot(kk, num_shards).long()],
                        torch.zeros((), dtype=st.dtype, device=st.device))
            for st, kk, o in zip(state_locs, k, ok)]
    vals_h = all_to_all(mesh, vals, num_shards)
    idx_h = all_to_all(mesh, home, num_shards)
    ok_h = all_to_all(mesh, ok, num_shards)
    out = [_scatter_set(L, i, o, v)
           for L, i, o, v in zip(Ls, idx_h, ok_h, vals_h)]
    answered = [_scatter_set(L, i, o, torch.ones_like(o))
                for L, i, o in zip(Ls, idx_h, ok_h)]
    return out, answered, dropped


def _any_global(mesh, masks: list) -> bool:
    """The ``psum(sum(mask)) > 0`` flag of a ``while_loop``: one host
    read."""
    counts = [m.sum(dtype=torch.int64) for m in masks]
    return bool(host_sync(
        psum_scalar(mesh, counts)[mesh.local_shards[0]] > 0))


def _chase_sharded(mesh, parent_locs: list, x: list, valid: list,
                   num_shards: int, bucket_capacity: int, stats=None):
    """Distributed pointer chase of global slots ``x`` to TRUE roots, one
    :func:`sharded_lookup` a level. An unanswered (overflowed) lookup
    leaves its lane pending for the next level."""
    settled = [~v for v in valid]
    drops = 0
    pending = _any_global(mesh, valid)
    while pending:
        ask = [v & ~s for v, s in zip(valid, settled)]
        nxt, answered, d = sharded_lookup(
            mesh, parent_locs, x, ask, num_shards, bucket_capacity)
        new_x = []
        for i in range(num_shards):
            moved = answered[i] & (nxt[i] != x[i])
            settled[i] = settled[i] | (answered[i] & (nxt[i] == x[i]))
            new_x.append(torch.where(moved, nxt[i], x[i]))
        x = new_x
        drops = drops + d[0]
        if stats is not None:
            stats["chase_levels"] += 1
        pending = _any_global(
            mesh, [v & ~s for v, s in zip(valid, settled)])
    return x, drops


def _mark_hits(mesh, endpoints: list, ok: list, num_shards: int,
               bucket_capacity: int, per: int) -> list:
    """Owned-slot hit masks of a routed endpoint batch."""
    k, _, got, _ = repartition_by_key(
        mesh, endpoints, [torch.zeros_like(e) for e in endpoints], ok,
        num_shards, bucket_capacity)
    hits = []
    for kk, g in zip(k, got):
        hit = torch.zeros(per + 1, dtype=torch.bool, device=kk.device)
        hit[torch.where(g, to_local_slot(kk, num_shards), per).long()] = True
        hits.append(hit[:per])
    return hits


def _fold_pairs(mesh, parent_locs, seen_locs, dirty_locs, a, b, ok,
                num_shards: int, bucket_capacity: int, stats=None):
    """Every shard's view of the pair fold (``gelly_tpu``'s
    ``_fold_pairs_body``); returns the new per-shard state and the global
    drop count."""
    S = num_shards
    per = parent_locs[0].shape[0]
    # Mark seen at the owners; newly seen slots are also dirty, so a
    # never-hooked singleton reaches the host seen cache.
    for endpoint in (a, b):
        hits = _mark_hits(mesh, endpoint, ok, S, bucket_capacity, per)
        dirty_locs = [d | (h & ~s)
                      for d, h, s in zip(dirty_locs, hits, seen_locs)]
        seen_locs = [s | h for s, h in zip(seen_locs, hits)]
    p_locs = list(parent_locs)
    drops = 0
    live_any = True
    while live_any:
        ra, d1 = _chase_sharded(mesh, p_locs, a, ok, S, bucket_capacity,
                                stats)
        rb, d2 = _chase_sharded(mesh, p_locs, b, ok, S, bucket_capacity,
                                stats)
        lo = [torch.minimum(x, y) for x, y in zip(ra, rb)]
        hi = [torch.maximum(x, y) for x, y in zip(ra, rb)]
        live = [o & (l != h) for o, l, h in zip(ok, lo, hi)]
        # Hook root-to-root at hi's owner, masked to self-roots: never
        # overwrite a real parent edge from an earlier fold.
        k, lo_r, got, d3 = repartition_by_key(
            mesh, hi, lo, live, S, bucket_capacity)
        new_p = []
        for me in range(S):
            p = p_locs[me]
            loc = torch.where(got[me], to_local_slot(k[me], S), per).long()
            upd = torch.full((per + 1,), INT_MAX, dtype=torch.int32,
                             device=p.device)
            upd = upd.scatter_reduce(
                0, loc, torch.where(got[me], lo_r[me], INT_MAX), "amin",
                include_self=True)[:per]
            own = (torch.arange(per, dtype=torch.int32, device=p.device)
                   * S + me)
            p2 = torch.where(p == own, torch.minimum(p, upd), p)
            dirty_locs[me] = dirty_locs[me] | (p2 != p)
            new_p.append(p2)
        p_locs = new_p
        drops = drops + d1 + d2 + d3[0]
        if stats is not None:
            stats["rounds"] += 1
        live_any = _any_global(mesh, live)
    return p_locs, seen_locs, dirty_locs, drops


class ShardedCC:
    """Vertex-striped CC summary over a mesh — state ∝ capacity/S a shard.
    ``fold(a, b, valid)`` unions a global-id pair batch; ``labels()``
    returns the full ``i32[capacity]`` label array (canonical min slot, -1
    unseen). ``stats["dropped"]`` counts exchange-bucket overflows (0 with
    the built-in worst-case buckets; an invariant check), ``stats
    ["rounds"]`` / ``["chase_levels"]`` the hook rounds and lookup levels
    of every fold, ``["emissions_dense"]`` / ``["emissions_sparse"]`` how
    emissions pulled their rows."""

    def __init__(self, vertex_capacity: int, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        require_one_process(self.mesh, "ShardedCC")
        self.S = _num_shards(self.mesh)
        self.n = vertex_capacity
        self.per = slots_per_shard(vertex_capacity, self.S)
        self.stats = {"dropped": 0, "rounds": 0, "chase_levels": 0,
                      "emissions_dense": 0, "emissions_sparse": 0}
        S, per = self.S, self.per
        # Striped init: shard d's local slot j is global slot j*S + d.
        self.parent = [torch.arange(per, dtype=torch.int32, device=dev) * S
                       + d for d, dev in enumerate(self.mesh.devices)]
        self.seen = [torch.zeros(per, dtype=torch.bool, device=dev)
                     for dev in self.mesh.devices]
        self.dirty = [torch.zeros(per, dtype=torch.bool, device=dev)
                      for dev in self.mesh.devices]
        # Host caches as of the last emission: flat roots and seen marks.
        self._rootcache = np.arange(vertex_capacity, dtype=np.int32)
        self._seencache = np.zeros(vertex_capacity, bool)
        self.pull_buckets: set = set()  # buckets of the sparse pulls

    def _bucket(self, L: int) -> int:
        # Worst case: all of a shard's L entries route to one owner. A
        # smaller bucket would drop the same lanes every retry and
        # livelock the loops, so this is not a knob.
        return L

    def fold(self, a, b, valid=None) -> None:
        """Union a batch of global-id pairs (host arrays, padded evenly
        across the shards here)."""
        a = np.asarray(a, np.int32)
        b = np.asarray(b, np.int32)
        ok = (np.ones(a.shape, bool) if valid is None
              else np.asarray(valid, bool))
        # An out-of-range slot would gather/scatter onto a real one.
        for name, arr in (("src", a), ("dst", b)):
            live = arr[ok]
            if live.size and (live.min() < 0 or live.max() >= self.n):
                raise ValueError(
                    f"ShardedCC.fold: {name} slot out of range "
                    f"[0, {self.n}) (got "
                    f"{int(live.min())}..{int(live.max())})"
                )
        S = self.S
        L = -(-a.shape[0] // S)
        pad = L * S - a.shape[0]
        if pad:
            a = np.concatenate([a, np.zeros(pad, np.int32)])
            b = np.concatenate([b, np.zeros(pad, np.int32)])
            ok = np.concatenate([ok, np.zeros(pad, bool)])

        def shards(x):
            x = torch.from_numpy(np.ascontiguousarray(x.reshape(S, L)))
            return [x[i].to(dev) for i, dev in enumerate(self.mesh.devices)]

        (self.parent, self.seen, self.dirty, drops) = _fold_pairs(
            self.mesh, self.parent, self.seen, self.dirty, shards(a),
            shards(b), shards(ok), S, self._bucket(L), self.stats)
        self.stats["dropped"] += int(drops)

    def _pull_delta(self, bucket: int):
        """Each shard's dirty ``(global slot, parent)`` rows compacted to
        ``bucket`` lanes on its device: only those rows cross to the
        host."""
        self.pull_buckets.add(bucket)
        gs, vs = [], []
        for me, (p, d) in enumerate(zip(self.parent, self.dirty)):
            slots, vals, _ = collectives.compact_delta(d, p, bucket)
            gs.append(torch.where(slots >= 0, slots * self.S + me, -1))
            vs.append(vals)
        return gs, vs

    def labels(self) -> np.ndarray:
        """Emit global labels ``i32[capacity]`` (the window close),
        incrementally: pull the dirty ``(slot, parent)`` entries, chase the
        delta chains among themselves against the host root cache, and
        map every slot's cached root through them (the one O(capacity)
        step, the output's size)."""
        S = self.S
        counts = torch.stack([d.sum(dtype=torch.int32).cpu()
                              for d in self.dirty]).numpy()
        mx = int(counts.max()) if counts.size else 0
        # Per-window dirty-row gauges: labels() moves dirty rows, not
        # capacity, and these make that cost visible per window close.
        bus = obs_bus.get_bus()
        bus.gauge("sharded_cc.window_dirty_rows", int(counts.sum()))
        bus.gauge("sharded_cc.window_dirty_max_shard", mx)
        bucket = max(64, 1 << max(0, mx - 1).bit_length())
        if S * bucket * 2 >= self.n:
            # Dense delta: the full pull moves fewer bytes than S padded
            # buckets would.
            par = torch.stack([p.cpu() for p in self.parent]).numpy()
            dirty = torch.stack([d.cpu() for d in self.dirty]).numpy()
            sg, sl = np.nonzero(dirty)
            g = (sl * S + sg).astype(np.int32)
            pv = par[sg, sl]
            self.stats["emissions_dense"] += 1
            bus.inc("sharded_cc.emissions_dense")
        else:
            gs, vals = self._pull_delta(bucket)
            gs = torch.cat([x.cpu() for x in gs]).numpy()
            pv = torch.cat([x.cpu() for x in vals]).numpy()
            okm = gs >= 0
            g = gs[okm].astype(np.int32)
            pv = pv[okm]
            self.stats["emissions_sparse"] += 1
            bus.inc("sharded_cc.emissions_sparse")
        bus.inc("sharded_cc.dirty_rows_gathered", int(g.size))
        self._seencache[g] = True  # dirty ⊇ newly seen
        rc = self._rootcache
        tmp = rc.copy()
        tmp[g] = pv
        if g.size:
            # Delta-chain fixpoint over the dirty entries only: a
            # non-dirty target r has tmp[r] == r.
            cur = tmp[g]
            while True:
                nxt = tmp[cur]
                if np.array_equal(nxt, cur):
                    break
                cur = nxt
            tmp[g] = cur
        flat = tmp[rc]
        self._rootcache = flat
        if g.size:
            self.dirty = [torch.zeros_like(d) for d in self.dirty]
        return np.where(self._seencache, flat, -1).astype(np.int32)

    def per_device_state_bytes(self) -> int:
        return self.per * 4 + self.per  # parent i32 + seen bool
