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

On a mesh that spans processes every process calls ``fold`` and
``labels`` with the same global batch: each holds, routes and hooks its
own shards' state (``None`` at the others), each round's flag is one
reduction across processes, and ``labels`` all-gathers the dirty rows,
so every process gets the single controller's labels and ``stats``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import bus as obs_bus
from ..ops.segments import INT_MAX
from ..ops.unionfind import host_sync
from . import collectives
from .mesh import (
    all_gather_shards,
    global_max,
    global_sum,
    make_mesh,
    num_shards as _num_shards,
    shard_map_fn,
)
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
    idx = _each(mesh, lambda s: torch.arange(
        s.shape[0], dtype=torch.int32, device=s.device), slots)
    k, home, ok, dropped = repartition_by_key(
        mesh, slots, idx, valids, num_shards, bucket_capacity)
    vals = _each(mesh, lambda st, kk, o: torch.where(
        o, st[to_local_slot(kk, num_shards).long()],
        torch.zeros((), dtype=st.dtype, device=st.device)), state_locs, k, ok)
    vals_h = all_to_all(mesh, vals, num_shards)
    idx_h = all_to_all(mesh, home, num_shards)
    ok_h = all_to_all(mesh, ok, num_shards)
    out = _each(mesh, lambda s, i, o, v: _scatter_set(s.shape[0], i, o, v),
                slots, idx_h, ok_h, vals_h)
    answered = _each(mesh, lambda s, i, o: _scatter_set(
        s.shape[0], i, o, torch.ones_like(o)), slots, idx_h, ok_h)
    return out, answered, dropped


def _each(mesh, fn, *lists) -> list:
    """``fn`` of every shard this process holds (its entries of
    ``lists``), ``None`` at the others."""
    return shard_map_fn(mesh, lambda _, *args: fn(*args))(*lists)


def _any_global(mesh, masks: list) -> bool:
    """The ``psum(sum(mask)) > 0`` flag of a ``while_loop``: one host
    read."""
    counts = _each(mesh, lambda m: m.sum(dtype=torch.int64), masks)
    return bool(host_sync(
        psum_scalar(mesh, counts)[mesh.local_shards[0]] > 0))


def _chase_sharded(mesh, parent_locs: list, x: list, valid: list,
                   num_shards: int, bucket_capacity: int, stats=None):
    """Distributed pointer chase of global slots ``x`` to TRUE roots, one
    :func:`sharded_lookup` a level. An unanswered (overflowed) lookup
    leaves its lane pending for the next level."""
    first = mesh.local_shards[0]
    settled = _each(mesh, lambda v: ~v, valid)
    drops = 0
    pending = _any_global(mesh, valid)
    while pending:
        ask = _each(mesh, lambda v, s: v & ~s, valid, settled)
        nxt, answered, d = sharded_lookup(
            mesh, parent_locs, x, ask, num_shards, bucket_capacity)
        settled = _each(mesh, lambda s, a, n, xx: s | (a & (n == xx)),
                        settled, answered, nxt, x)
        x = _each(mesh, lambda a, n, xx: torch.where(a & (n != xx), n, xx),
                  answered, nxt, x)
        drops = drops + d[first]
        if stats is not None:
            stats["chase_levels"] += 1
        pending = _any_global(
            mesh, _each(mesh, lambda v, s: v & ~s, valid, settled))
    return x, drops


def _mark_hits(mesh, endpoints: list, ok: list, num_shards: int,
               bucket_capacity: int, per: int) -> list:
    """Owned-slot hit masks of a routed endpoint batch."""
    k, _, got, _ = repartition_by_key(
        mesh, endpoints, _each(mesh, torch.zeros_like, endpoints), ok,
        num_shards, bucket_capacity)
    def hit_mask(kk, g):
        hit = torch.zeros(per + 1, dtype=torch.bool, device=kk.device)
        hit[torch.where(g, to_local_slot(kk, num_shards), per).long()] = True
        return hit[:per]

    return _each(mesh, hit_mask, k, got)


def _fold_pairs(mesh, parent_locs, seen_locs, dirty_locs, a, b, ok,
                num_shards: int, bucket_capacity: int, stats=None):
    """Every shard's view of the pair fold (``gelly_tpu``'s
    ``_fold_pairs_body``); returns the new per-shard state and the global
    drop count."""
    S = num_shards
    first = mesh.local_shards[0]
    per = parent_locs[first].shape[0]
    # Mark seen at the owners; newly seen slots are also dirty, so a
    # never-hooked singleton reaches the host seen cache.
    for endpoint in (a, b):
        hits = _mark_hits(mesh, endpoint, ok, S, bucket_capacity, per)
        dirty_locs = _each(mesh, lambda d, h, s: d | (h & ~s),
                           dirty_locs, hits, seen_locs)
        seen_locs = _each(mesh, lambda s, h: s | h, seen_locs, hits)
    p_locs = list(parent_locs)
    drops = 0
    live_any = True
    while live_any:
        ra, d1 = _chase_sharded(mesh, p_locs, a, ok, S, bucket_capacity,
                                stats)
        rb, d2 = _chase_sharded(mesh, p_locs, b, ok, S, bucket_capacity,
                                stats)
        lo = _each(mesh, torch.minimum, ra, rb)
        hi = _each(mesh, torch.maximum, ra, rb)
        live = _each(mesh, lambda o, l, h: o & (l != h), ok, lo, hi)
        # Hook root-to-root at hi's owner, masked to self-roots: never
        # overwrite a real parent edge from an earlier fold.
        k, lo_r, got, d3 = repartition_by_key(
            mesh, hi, lo, live, S, bucket_capacity)
        new_p = [None] * S
        for me in mesh.local_shards:
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
            new_p[me] = p2
        p_locs = new_p
        drops = drops + d1 + d2 + d3[first]
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
        self.S = _num_shards(self.mesh)
        self.n = vertex_capacity
        self.per = slots_per_shard(vertex_capacity, self.S)
        self.stats = {"dropped": 0, "rounds": 0, "chase_levels": 0,
                      "emissions_dense": 0, "emissions_sparse": 0}
        S, per = self.S, self.per
        # Striped init: shard d's local slot j is global slot j*S + d.
        # Across processes: this process's shards only (None elsewhere).
        self.parent = [torch.arange(per, dtype=torch.int32, device=dev) * S
                       + d if dev is not None else None
                       for d, dev in enumerate(self.mesh.devices)]
        self.seen = [torch.zeros(per, dtype=torch.bool, device=dev)
                     if dev is not None else None
                     for dev in self.mesh.devices]
        self.dirty = [torch.zeros(per, dtype=torch.bool, device=dev)
                      if dev is not None else None
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
            return [x[i].to(dev) if dev is not None else None
                    for i, dev in enumerate(self.mesh.devices)]

        (self.parent, self.seen, self.dirty, drops) = _fold_pairs(
            self.mesh, self.parent, self.seen, self.dirty, shards(a),
            shards(b), shards(ok), S, self._bucket(L), self.stats)
        self.stats["dropped"] += int(drops)

    def _pull_delta(self, bucket: int):
        """Each shard's dirty ``(global slot, parent)`` rows compacted to
        ``bucket`` lanes on its device: only those rows cross to the
        host."""
        self.pull_buckets.add(bucket)
        gs, vs = [None] * self.S, [None] * self.S
        for me in self.mesh.local_shards:
            slots, vals, _ = collectives.compact_delta(
                self.dirty[me], self.parent[me], bucket)
            gs[me] = torch.where(slots >= 0, slots * self.S + me, -1)
            vs[me] = vals
        return gs, vs

    def labels(self) -> np.ndarray:
        """Emit global labels ``i32[capacity]`` (the window close),
        incrementally: pull the dirty ``(slot, parent)`` entries, chase the
        delta chains among themselves against the host root cache, and
        map every slot's cached root through them (the one O(capacity)
        step, the output's size)."""
        S, mesh = self.S, self.mesh
        counts = [d.sum(dtype=torch.int32) if d is not None else None
                  for d in self.dirty]
        mx = global_max(mesh, counts)
        # Per-window dirty-row gauges: labels() moves dirty rows, not
        # capacity, and these make that cost visible per window close.
        bus = obs_bus.get_bus()
        bus.gauge("sharded_cc.window_dirty_rows", global_sum(mesh, counts))
        bus.gauge("sharded_cc.window_dirty_max_shard", mx)
        bucket = max(64, 1 << max(0, mx - 1).bit_length())
        if S * bucket * 2 >= self.n:
            # Dense delta: the full pull moves fewer bytes than S padded
            # buckets would (across processes, an all-gather of both).
            rows = all_gather_shards(mesh, [
                (p, d) if p is not None else None
                for p, d in zip(self.parent, self.dirty)])
            # all_gather_shards with no device gives host tensors.
            par = torch.stack([r[0] for r in rows]).numpy()  # graphlint: disable=GL003 -- host rows: no sync
            dirty = torch.stack([r[1] for r in rows]).numpy()  # graphlint: disable=GL003 -- host rows: no sync
            sg, sl = np.nonzero(dirty)
            g = (sl * S + sg).astype(np.int32)
            pv = par[sg, sl]
            self.stats["emissions_dense"] += 1
            bus.inc("sharded_cc.emissions_dense")
        else:
            gs, vals = self._pull_delta(bucket)
            rows = all_gather_shards(mesh, [
                (g, v) if g is not None else None for g, v in zip(gs, vals)])
            gs = torch.cat([r[0] for r in rows]).numpy()  # graphlint: disable=GL003 -- host rows: no sync
            pv = torch.cat([r[1] for r in rows]).numpy()  # graphlint: disable=GL003 -- host rows: no sync
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
            self.dirty = [torch.zeros_like(d) if d is not None else None
                          for d in self.dirty]
        return np.where(self._seencache, flat, -1).astype(np.int32)

    def per_device_state_bytes(self) -> int:
        return self.per * 4 + self.per  # parent i32 + seen bool
