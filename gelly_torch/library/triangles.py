"""Triangle counting: windowed, exact streaming, and sampled estimation.

Counterpart of ``gelly_tpu/library/triangles.py``, the reference's three
triangle programs, held to it bit for bit:

- **Window triangles** (``WindowTriangles.java:48-139``): per tumbling
  window, the number of triangles among the window's edges, each counted
  once from its minimum vertex ``u`` as a wedge ``u < a < b`` closed by
  the window edge ``(a, b)``. Four paths:

  - the dense packed path (``n*n < 2^31``): the host dedups the window's
    undirected edges into one packed ``i32`` column (``a*n + b``), the
    device rebuilds the adjacency, takes the upper-triangle wedge mask
    ``M[u, x] = edge(u, x) & x > u`` and sums ``Σ_u M[u,a]·M[u,b]`` over
    the window's edges;
  - the unpacked dense path (``n*n >= 2^31`` without ``max_degree``):
    the same count over the window's sorted ALL-direction view, one
    window at a time;
  - the capped-degree sparse path (``max_degree=``): the window's
    adjacency in an ``i32[n, D]`` row table, each canonical edge
    intersecting its endpoints' rows (``D x D``), with the entries the
    cap dropped counted and raised;
  - the degree-bucketed path (:func:`window_triangles_bucketed`): host
    prep (dedup, a compact row table over the touched vertices, edges in
    power-of-two buckets of their rows' fill, rows above
    :data:`DENSE_ROW_CAP` as bitmaps), then one device count a group.

  ``method`` picks how the dense paths take the sum: ``"mxu"`` computes
  ``W = MᵀM`` with :func:`~gelly_torch.ops.kernels.wedge_count_matrix`
  (the hand-written CUDA kernel on a card, its plain version on the CPU),
  ``"mxu_interpret"`` with the plain version always, ``"gather"`` per edge
  as ``(M[:, a] & M[:, b]).sum``, and ``"auto"`` takes ``"mxu"`` on a card
  for dense windows.

- **Exact streaming counts** (``ExactTriangleCount.java:41-207``): the
  adjacency stores each edge's arrival index, and whole slabs of edges
  intersect their rows at once; a triangle counts when its closing edge
  arrives. A dense ``i32[N, N]`` matrix (small ``N``) or a capped-degree
  ``i32[N, D]`` table (``max_degree=``, degree overflow raises). Arrival
  indices are rebased losslessly before they can wrap.

- **The sampled estimator** (Buriol et al., behind
  ``BroadcastTriangleCount.java:60-207`` and
  ``IncidenceSamplingTriangleCount.java:23-337``): ``S`` reservoir
  instances advance over every chunk lane in stream order, each with its
  own Threefry key stream (:mod:`gelly_torch.ops.threefry`, JAX's PRNG),
  through :func:`~gelly_torch.ops.kernels.sampler_step` (the hand CUDA
  kernel on a card, one thread an instance; its plain version on the CPU).

The slab loops of the sparse, bucketed and exact paths are plain PyTorch:
a few launches a slab of a vectorised step. The mesh paths:
:func:`sharded_window_triangles` (the keyed exchange, per-shard partial
adjacencies summed across the shards) and ``sampled_triangle_count
(mesh=)`` (the instance axis split over the shards, each running the
sampler kernel).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..core.device import to_numpy
from ..ops import kernels, segments, threefry
from ..ops.rowtable import put_where_
from ..ops.segments import INT_MAX
from ..utils.prefetch import prefetch_map

_I64_MAX = torch.iinfo(torch.int64).max
# The packed wire holds a*n + b in i32: capacities with n*n at or past
# this take the unpacked dense path.
PACKED_LIMIT = 1 << 31

# --------------------------------------------------------------------- #
# windowed


def _check_slot_range(capacity: int, full_capacity: int, *arrays_with_mask):
    """Raise when a live slot exceeds a narrowed adjacency capacity —
    scatters would silently drop and gathers clamp otherwise."""
    if capacity >= full_capacity:
        return
    for arr, mask in arrays_with_mask:
        a = to_numpy(arr)
        m = to_numpy(mask).astype(bool)
        hi = int(a[m].max(initial=0))
        if hi >= capacity:
            raise ValueError(
                f"vertex slot {hi} exceeds triangle capacity {capacity}"
            )


def _wedge_per_edge(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    method: str) -> torch.Tensor:
    """Common smaller neighbours of each lane's ``(a, b)`` under the wedge
    mask ``m``: ``W[a, b]`` of the wedge kernel (or its plain version for
    ``"mxu_interpret"``), or the column AND for ``"gather"``. ``i32``."""
    if method.startswith("mxu"):
        wedge = (kernels.wedge_count_matrix_plain if method == "mxu_interpret"
                 else kernels.wedge_count_matrix)
        return wedge(m)[a, b].to(torch.int32)
    return (m[:, a] & m[:, b]).sum(dim=0, dtype=torch.int32)


def _wedge_count_from_adj(adj: torch.Tensor, key: torch.Tensor,
                          nbr: torch.Tensor, valid: torch.Tensor, n: int,
                          method: str = "gather") -> torch.Tensor:
    """Triangles of a window adjacency ``adj`` (``bool[n, n]``, cut to its
    wedge mask IN PLACE) over its ``(key, nbr)`` edge list: per unique
    canonical edge ``(a, b)``, ``a < b``, the wedge centres ``u`` adjacent
    to both with ``u < a`` — the candidate/match semantics of
    GenerateCandidateEdges + CountTriangles (WindowTriangles.java:82-139).
    Returns an ``int64`` scalar."""
    m = adj.triu_(diagonal=1)
    canon = valid & (key < nbr)
    uniq = segments.unique_pairs_mask(key, nbr, canon, n)
    # Gathers clamp into the matrix, as the reference's do (padding keys
    # are INT_MAX); those lanes are masked by ``uniq``.
    a = key.long().clamp(0, n - 1)
    b = nbr.long().clamp(0, n - 1)
    per_edge = _wedge_per_edge(m, a, b, method)
    return torch.where(uniq, per_edge, 0).sum(dtype=torch.int64)


def _window_triangle_count(view, capacity: int,
                           method: str = "gather") -> torch.Tensor:
    """Triangles inside one window's (ALL-direction) sorted view, over a
    ``bool[capacity, capacity]`` adjacency: the unpacked dense path.

    ``method="gather"`` takes per-edge column pairs (``O(N·E)``);
    ``"mxu"`` / ``"mxu_interpret"`` the full wedge matrix ``W = MᵀM``
    (the win for dense windows). Slots at or past ``capacity`` are
    dropped, as the reference's scatter drops them."""
    n = capacity
    inside = view.valid & (view.key < n) & (view.nbr < n)
    adj = torch.zeros((n, n), dtype=torch.bool, device=view.key.device)
    put_where_(adj.view(-1), view.key.long() * n + view.nbr.long(),
               torch.ones_like(inside), inside)
    return _wedge_count_from_adj(adj, view.key, view.nbr, view.valid, n,
                                 method)


def _wedge_mask(packed: torch.Tensor, n: int, capacity: int):
    """``(M, a, b)`` of one packed window column: ``M`` the bool
    ``[capacity, capacity]`` wedge mask, ``a``/``b`` the endpoints of its
    live lanes (``int64``, clamped into the matrix like the reference's
    gathers). Scatters drop endpoints outside ``capacity``, as the
    reference's ``mode="drop"`` does.

    One window's dense state: the adjacency is symmetrized and then cut to
    its upper triangle in place, so the mask costs one ``capacity^2``-byte
    tensor and no comparison temporary."""
    valid = packed != INT_MAX
    live = packed[valid]  # non-negative i32: padding is masked first
    a = torch.div(live, n, rounding_mode="floor").long()
    b = torch.remainder(live, n).long()
    inside = (a < capacity) & (b < capacity)
    ai, bi = a[inside], b[inside]
    adj = torch.zeros((capacity, capacity), dtype=torch.bool,
                      device=packed.device)
    adj[ai, bi] = True
    adj[bi, ai] = True
    m = adj.triu_(diagonal=1)
    top = capacity - 1
    return m, a.clamp_(max=top), b.clamp_(max=top)


def _window_triangle_count_packed(packed: torch.Tensor, n: int,
                                  capacity: int, method: str) -> torch.Tensor:
    """Triangles of one window from its packed column ``packed[i] = a*n + b``
    (``a < b``, the window's UNIQUE canonical undirected edges, self-loops
    removed, ``INT_MAX`` padding). Returns an ``int64`` scalar on the
    column's device."""
    m, a, b = _wedge_mask(packed, n, capacity)
    return _wedge_per_edge(m, a, b, method).sum(dtype=torch.int64)


def _window_triangle_count_packed_group(packed_kl: torch.Tensor, n: int,
                                        capacity: int, method: str
                                        ) -> torch.Tensor:
    """``i64[K]`` counts of ``K`` stacked packed window columns, one window
    after the other, so the device holds one window's dense state at a
    time."""
    return torch.stack([
        _window_triangle_count_packed(p, n, capacity, method)
        for p in packed_kl
    ])


def _slab_sum(body, arrays, slab: int) -> torch.Tensor:
    """``Σ body(slab of each array)`` as an ``int64`` scalar, over
    ``[slab]``-long pieces of 1-D arrays (the last one shorter): the
    reference's padded ``lax.map``, whose padding lanes add nothing."""
    e = arrays[0].shape[0]
    total = torch.zeros((), dtype=torch.int64, device=arrays[0].device)
    for lo in range(0, e, slab):
        total += body(*(x[lo:lo + slab] for x in arrays))
    return total


def _window_triangle_count_sparse(key: torch.Tensor, nbr: torch.Tensor,
                                  valid: torch.Tensor, n: int,
                                  max_degree: int, slab: int | None = None):
    """Window triangle count over a capped-degree row table — the large-N
    path (the dense ``bool[N, N]`` adjacency is infeasible past N ~ 46k).

    Input is the single-copy OUT-direction window ``(key, nbr, valid)``;
    the doubled view is built here. The window's deduped adjacency is
    scattered into ``i32[n, D]`` neighbour rows (ranks from a sorted
    segment scan), and each canonical edge ``(a, b)`` counts common
    neighbours ``u < a`` by a slab-mapped ``D x D`` row intersection.

    Returns ``(count i64, overflow i32)`` scalars: ``overflow`` is the
    number of adjacency entries the degree cap dropped (any overflow is an
    error for the caller: a dropped entry could hide triangles)."""
    D = max_degree
    if slab is None:
        slab = max(8, (1 << 22) // max(1, D * D))
    k2 = torch.cat([key, nbr])
    n2 = torch.cat([nbr, key])
    ok = torch.cat([valid, valid]) & (k2 != n2)
    # Sort by (key, nbr): duplicates become adjacent, rows fill ascending.
    pack = torch.where(ok, k2.long() * n + n2.long(), _I64_MAX)
    sp, order = torch.sort(pack, stable=True)
    sk, sn, so = k2[order], n2[order], ok[order]
    fresh = segments.segment_starts(sp, so)  # drop duplicate directed pairs
    run = segments.segment_starts(torch.where(so, sk, INT_MAX), so)
    # Rank among fresh entries within each key run: the cumulative fresh
    # count minus the run's base, carried forward by a running max.
    f32 = fresh.to(torch.int32)
    cf = torch.cumsum(f32, 0, dtype=torch.int32)
    base = torch.cummax(torch.where(run, cf - f32, 0), 0).values
    rank = cf - f32 - base
    fits = fresh & (rank < D)
    overflow = (fresh & ~fits).sum(dtype=torch.int32)
    table = torch.full((n, D), -1, dtype=torch.int32, device=key.device)
    put_where_(table.view(-1), sk.long() * D + rank.clamp(max=D - 1), sn,
               fits & (sk < n))

    canon = fresh & (sk < sn)

    def body(a_id, b_id, live):
        rows_a = table[torch.where(live, a_id, 0).long()]  # [slab, D]
        rows_b = table[torch.where(live, b_id, 0).long()]
        ra = rows_a[:, :, None]
        m = ((ra == rows_b[:, None, :]) & (ra >= 0)
             # wedge-min convention: count centres u < a = min(a, b)
             & (ra < a_id[:, None, None]))
        per = m.sum(dim=(1, 2))
        return torch.where(live, per, 0).sum(dtype=torch.int64)

    return _slab_sum(body, (sk, sn, canon), slab), overflow


def _window_triangle_count_sparse_group(keys_kl, nbrs_kl, valids_kl,
                                        n: int, max_degree: int):
    """``(counts i64[K], overflows i32[K])`` for ``K`` stacked sparse
    windows, one after the other."""
    out = [_window_triangle_count_sparse(k, m, v, n, max_degree)
           for k, m, v in zip(keys_kl, nbrs_kl, valids_kl)]
    return (torch.stack([c for c, _ in out]),
            torch.stack([o for _, o in out]))


DENSE_ROW_CAP = 64  # fill above this makes a row "hot" (bitmap path)


def _ladder(d: int) -> tuple[int, ...]:
    """Power-of-two degree buckets 4, 8, ..., d (shared by the window
    bucketizer and the stacker)."""
    out = []
    db = 4
    while True:
        out.append(min(db, d))
        if db >= d:
            break
        db *= 2
    return tuple(out)


def _pow2_cap(longest: int, floor: int) -> int:
    """Smallest power of two >= max(longest, 1), floored."""
    return max(floor, 1 << max(0, longest - 1).bit_length())


def _in_groups(it, batch: int):
    g: list = []
    for item in it:
        g.append(item)
        if len(g) == batch:
            yield g
            g = []
    if g:
        yield g


def _run_starts(x: np.ndarray) -> np.ndarray:
    """Mask of the positions of a sorted array that start a run."""
    first = np.ones(x.shape[0], bool)
    first[1:] = x[1:] != x[:-1]
    return first


def _sorted_unique(x: np.ndarray) -> np.ndarray:
    """``np.unique(x)`` by a sort: numpy 2.3's ``np.unique`` without
    ``return_*`` takes a hash path, many times slower than a sort on the
    tens of millions of ``int64`` keys of a large window."""
    x = np.sort(x)
    return x[_run_starts(x)]


def _bucketize_window(bk: np.ndarray, bn: np.ndarray, bo: np.ndarray,
                      n: int, max_degree: int | None) -> dict:
    """Host-side window prep for the bucketed sparse count (numpy, on the
    prefetch side): dedup directed pairs, build the COMPACT row table
    layout (row ids over touched vertices only), split canonical edges
    into power-of-two degree buckets by ACTUAL row fill, and carve out the
    SKEW SPLIT — rows with fill > :data:`DENSE_ROW_CAP` become per-window
    BITMAPS over the compact row space instead of D-capped rows, so a Zipf
    hot vertex costs its edges O(fill_sparse) membership gathers
    (hot-sparse) or O(T) bitmap ANDs (hot-hot) instead of a ``max_fill^2``
    intersection.

    With ``max_degree=None`` (default) nothing can overflow; an explicit
    cap bounds the HOT row fill and raises HERE, before any count is
    produced, so yielded counts are always exact.
    """
    k = bk[bo].astype(np.int64)
    m = bn[bo].astype(np.int64)
    k2 = np.concatenate([k, m])
    n2 = np.concatenate([m, k])
    keep = k2 != n2  # self-loops close no triangles
    pack = _sorted_unique(k2[keep] * n + n2[keep])
    a = (pack // n).astype(np.int32)
    b = (pack % n).astype(np.int32)
    # ``a`` is sorted: its runs are the rows (np.unique's rows, inverse
    # and counts without a second sort).
    first = _run_starts(a)
    starts = np.flatnonzero(first)
    rows = a[starts]
    inv = np.cumsum(first) - 1
    fill = np.diff(np.append(starts, a.shape[0]))
    max_fill = int(fill.max()) if fill.size else 1
    if max_degree is not None and max_fill > max_degree:
        raise ValueError(
            f"window adjacency row fill {max_fill} exceeds "
            f"max_degree={max_degree}; raise max_degree or drop the cap "
            "(the bucketed path raises before yielding, so no corrupt "
            "count escapes; hot rows go to the bitmap path regardless)"
        )
    d = 1 << max(2, (min(max_fill, DENSE_ROW_CAP) - 1).bit_length())
    rank = (np.arange(a.shape[0]) - starts[inv]).astype(np.int32)
    inv32 = inv.astype(np.int32)
    # rid of each nbr: the pairs are symmetric, so the nbrs' distinct
    # values are ``rows`` and their inverse is the rid (a sort, where a
    # binary search a nbr misses the cache across the whole row array).
    ridb = np.unique(b, return_inverse=True)[1].astype(np.int32)

    hot_row = fill > DENSE_ROW_CAP
    hot_rows = np.nonzero(hot_row)[0].astype(np.int32)
    hidx_of = np.full(rows.shape[0], -1, np.int32)
    hidx_of[hot_rows] = np.arange(hot_rows.shape[0], dtype=np.int32)

    # Table entries: non-hot rows only (hot rows live in the bitmap).
    in_table = ~hot_row[inv] & (rank < d)
    pos = np.where(in_table, inv32 * d + rank, -1).astype(np.int32)
    # Bitmap entries: directed pairs whose source row is hot.
    bm = hot_row[inv]
    bh = hidx_of[inv32[bm]]
    brid = ridb[bm]

    c = a < b  # one canonical lane per undirected edge
    ra = inv32[c]
    rb = ridb[c]
    av = a[c]
    a_hot = hot_row[ra]
    b_hot = hot_row[rb]
    hh = a_hot & b_hot
    hs = a_hot ^ b_hot
    ss = ~(a_hot | b_hot)
    ladder = _ladder(d)
    prev = 0
    buckets = []
    need = np.maximum(fill[ra], fill[rb])
    for db in ladder:
        sel = ss & (need > prev) & (need <= db)
        buckets.append((ra[sel], rb[sel], av[sel]))
        prev = db
    # Hot-sparse: iterate the SPARSE side's row, test membership in the
    # hot side's bitmap; hot-hot: AND the two bitmaps over the row space.
    h_side = np.where(a_hot, ra, rb)[hs]
    s_side = np.where(a_hot, rb, ra)[hs]
    return {
        "pos": pos, "nbr": b, "rid": ridb, "t": rows.shape[0], "d": d,
        "ladder": ladder, "buckets": buckets,
        "rows": rows.astype(np.int32),
        "n_hot": hot_rows.shape[0], "bh": bh, "brid": brid,
        "hs": (hidx_of[h_side], s_side, av[hs]),
        "hh": (hidx_of[ra[hh]], hidx_of[rb[hh]], av[hh]),
    }


def _stack_bucketed(group: list[dict]) -> tuple:
    """Pad + stack K windows' bucketed payloads to shared pow-2 caps.

    Shared caps: table depth d and ladder take the group max (a window
    with smaller d still counts correctly — its rows simply leave the
    upper lanes empty); per-bucket/bitmap/edge caps are pow-2 of the
    group max.
    """
    d = max(p["d"] for p in group)
    ladder = _ladder(d)
    t_cap = _pow2_cap(max(p["t"] for p in group), 64)
    p_cap = _pow2_cap(max(p["pos"].shape[0] for p in group), 64)
    h_cap = _pow2_cap(max(p["n_hot"] for p in group), 1)
    b_cap = _pow2_cap(max(p["bh"].shape[0] for p in group), 8)

    def pad_to(x, cap, fillv):
        out = np.full((cap,), fillv, np.int32)
        out[: x.shape[0]] = x
        return out

    pos_k, nbr_k, rid_k, val_k, bpos_k = [], [], [], [], []
    for p in group:
        # Re-express pos in the SHARED depth d (row*d + rank).
        live = p["pos"] >= 0
        rows_p = np.where(live, p["pos"] // p["d"], 0)
        rank_p = np.where(live, p["pos"] % p["d"], 0)
        pos_k.append(pad_to(
            np.where(live, rows_p * d + rank_p, -1), p_cap, -1
        ))
        nbr_k.append(pad_to(p["nbr"], p_cap, 0))
        rid_k.append(pad_to(p["rid"], p_cap, 0))
        val_k.append(pad_to(p["rows"], t_cap, INT_MAX))
        bpos_k.append(pad_to(p["bh"] * t_cap + p["brid"], b_cap, -1))
    stacked_buckets = []
    for bi, db in enumerate(ladder):
        e_cap = _pow2_cap(
            max(
                (p["buckets"][bi][0].shape[0]
                 if bi < len(p["buckets"]) else 0)
                for p in group
            ), 8,
        )
        ras, rbs, avs = [], [], []
        for p in group:
            if bi < len(p["buckets"]):
                ra, rb, av = p["buckets"][bi]
            else:
                ra = rb = av = np.empty(0, np.int32)
            ras.append(pad_to(ra, e_cap, -1))
            rbs.append(pad_to(rb, e_cap, 0))
            avs.append(pad_to(av, e_cap, 0))
        stacked_buckets.append(
            (np.stack(ras), np.stack(rbs), np.stack(avs))
        )

    def stack_cls(key):
        e_cap = _pow2_cap(max(p[key][0].shape[0] for p in group), 8)
        return tuple(
            np.stack([pad_to(p[key][j], e_cap, fv) for p in group])
            for j, fv in ((0, -1), (1, 0), (2, 0))
        )

    return (
        {
            "pos": np.stack(pos_k), "nbr": np.stack(nbr_k),
            "rid": np.stack(rid_k), "val": np.stack(val_k),
            "bpos": np.stack(bpos_k),
            "buckets": tuple(stacked_buckets),
            "hs": stack_cls("hs"), "hh": stack_cls("hh"),
        },
        t_cap, d, h_cap, tuple(ladder),
    )


def _scatter_table(size: int, fill: int, pos: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """``full((size,), fill).at[pos].set(vals)`` over the lanes with
    ``pos >= 0`` (live positions are distinct)."""
    out = torch.full((size,), fill, dtype=torch.int32, device=pos.device)
    put_where_(out, pos, vals, pos >= 0)
    return out


def _bucketed_window_count(p: dict, t_cap: int, d: int, h_cap: int,
                           ladder: tuple) -> torch.Tensor:
    """One bucketized window's ``int64`` count: scatter the compact row
    table (ranks came from the host) and the hot-row bitmap, then the
    three edge classes, each slab-mapped:

    - sparse-sparse: ``[E_b, db, db]`` row intersections a degree bucket;
    - hot-sparse: the sparse side's row (<= DENSE_ROW_CAP entries) tested
      against the hot side's bitmap — ``O(fill_sparse)`` an edge;
    - hot-hot: the two bitmaps ANDed over the compact row space — ``O(T)``
      an edge.

    Centres ``u < a = min(a, b)``, as the dense kernel counts them."""
    table = _scatter_table(t_cap * d, -1, p["pos"], p["nbr"]).view(t_cap, d)
    table_rid = _scatter_table(t_cap * d, 0, p["pos"], p["rid"]).view(
        t_cap, d)
    bpos = p["bpos"]
    bitmap = torch.zeros((h_cap * t_cap,), dtype=torch.bool,
                         device=bpos.device)
    put_where_(bitmap, bpos, torch.ones_like(bpos, dtype=torch.bool),
               bpos >= 0)
    total = torch.zeros((), dtype=torch.int64, device=bpos.device)
    for db, (ra, rb, av) in zip(ladder, p["buckets"]):

        def ss_body(ra_s, rb_s, av_s, db=db):
            ok_s = ra_s >= 0
            rows_a = table[torch.where(ok_s, ra_s, 0).long()][:, :db]
            rows_b = table[torch.where(ok_s, rb_s, 0).long()][:, :db]
            r = rows_a[:, :, None]
            mt = ((r == rows_b[:, None, :]) & (r >= 0)
                  & (r < av_s[:, None, None]))
            per = mt.sum(dim=(1, 2))
            return torch.where(ok_s, per, 0).sum(dtype=torch.int64)

        total += _slab_sum(ss_body, (ra, rb, av),
                           max(8, (1 << 22) // (db * db)))

    def hs_body(h_s, srow_s, av_s):
        ok_s = h_s >= 0
        srow = torch.where(ok_s, srow_s, 0).long()
        vals = table[srow]  # [slab, d]
        rids = table_rid[srow]
        member = bitmap[torch.where(ok_s, h_s, 0).long()[:, None] * t_cap
                        + rids]
        mt = member & (vals >= 0) & (vals < av_s[:, None])
        return torch.where(ok_s, mt.sum(dim=1), 0).sum(dtype=torch.int64)

    total += _slab_sum(hs_body, p["hs"], max(8, (1 << 22) // d))

    bm2 = bitmap.view(h_cap, t_cap)
    val = p["val"]

    def hh_body(ha_s, hb_s, av_s):
        ok_s = ha_s >= 0
        ma = bm2[torch.where(ok_s, ha_s, 0).long()]
        mb = bm2[torch.where(ok_s, hb_s, 0).long()]
        mt = ma & mb & (val[None, :] < av_s[:, None])
        per = mt.sum(dim=1)
        return torch.where(ok_s, per, 0).sum(dtype=torch.int64)

    total += _slab_sum(hh_body, p["hh"], max(4, (1 << 22) // t_cap))
    return total


def _window_triangle_count_bucketed_group(payload: dict, t_cap: int, d: int,
                                          h_cap: int, ladder: tuple
                                          ) -> torch.Tensor:
    """``i64[K]`` counts for ``K`` stacked bucketized windows, one window
    after the other."""
    k = payload["pos"].shape[0]
    return torch.stack([
        _bucketed_window_count(_tree_map(lambda x: x[i], payload), t_cap,
                               d, h_cap, ladder)
        for i in range(k)
    ])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _stage_to(device: torch.device):
    """``put(tree) -> (tree on device, ready event or None)``: host numpy
    arrays copied to ``device``. On a card each copy is pinned and runs on
    a side stream; the consumer calls :func:`_await_staged` before the
    first kernel that reads them."""
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def put(tree):
        host = _tree_map(torch.from_numpy, tree)
        if copy_stream is None:
            return _tree_map(lambda t: t.to(device), host), None
        with torch.cuda.stream(copy_stream):
            dev = _tree_map(lambda t: t.pin_memory().to(device,
                                                        non_blocking=True),
                            host)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return dev, ready

    return put


def _await_staged(tree, ready, device: torch.device) -> None:
    """The consumer's stream waits for a staged copy, and the copies'
    memory is kept until the consumer's work on it is done."""
    if ready is None:
        return
    consumer = torch.cuda.current_stream(device)
    consumer.wait_event(ready)
    _tree_map(lambda t: t.record_stream(consumer), tree)


def window_triangles_bucketed(stream, window_ms: int,
                              capacity: int | None = None,
                              window_capacity: int | None = None,
                              max_degree: int | None = None,
                              batch: int = 8) -> Iterator[tuple]:
    """Per-window triangle counts on the degree-bucketed sparse path — the
    large-N workhorse: host-side dedup/rank/bucketize on a worker thread
    (overlapping the device's count of the previous group, with the copy
    on a side stream), a compact row table over the touched vertices, and
    ``D x D`` intersections sized by each edge's ACTUAL row fill.

    Yields ``(window, count)`` (an ``int64`` scalar on
    ``stream.ctx.device``) in groups of up to ``batch`` windows.
    ``max_degree=None`` (default) adapts the table depth to each window's
    true max degree — no overflow possible; an explicit cap raises on the
    host BEFORE any count of its group is yielded.
    """
    n = capacity if capacity is not None else stream.ctx.vertex_capacity
    device = torch.device(stream.ctx.device)
    put = _stage_to(device)

    def stage(group):
        wins = [w for w, _ in group]
        payloads = [
            _bucketize_window(bk, bn, bo, n, max_degree)
            for _, (bk, bn, bo) in group
        ]
        payload, t_cap, d, h_cap, ladder = _stack_bucketed(payloads)
        dev, ready = put(payload)
        return wins, dev, ready, (t_cap, d, h_cap, ladder)

    def gen():
        for wins, payload, ready, shape in prefetch_map(
            stage,
            _in_groups(_out_windows(stream, window_ms, window_capacity, n),
                       batch),
            depth=2, workers=1,
        ):
            _await_staged(payload, ready, device)
            counts = _window_triangle_count_bucketed_group(payload, *shape)
            yield from zip(wins, counts)

    return gen()


def _pick_method(method: str, n: int):
    """Resolve ``method="auto"`` per window or group: ``"mxu"`` for a dense
    window (``view_len >= n``, ``n % 128 == 0``) whose data lies on a
    card, else ``"gather"``. Returns ``pick(view_len, device)``."""
    if method != "auto":
        return lambda view_len, device: method
    return lambda view_len, device: (
        "mxu" if (view_len >= n and n % kernels.TILE == 0
                  and torch.device(device).type == "cuda") else "gather"
    )


def _out_windows(stream, window_ms: int, window_capacity: int | None,
                 n: int) -> Iterator[tuple[int, tuple]]:
    """(window, (key, nbr, valid) host columns) per closed window.

    OUT-direction windows carry each edge once; the count rebuilds both
    directions on the device (both share the edge's timestamp window, so
    symmetrizing after the transfer is exact). ``window_capacity`` is
    calibrated by callers for the doubled ALL-direction buffer; the
    single-copy buffer needs half of it. Unsorted (the count is
    order-independent).
    """
    snap = stream.slice(
        window_ms, "out",
        window_capacity=None if window_capacity is None
        else max(1, window_capacity // 2),
    )
    try:
        for w, (bk, bn, _bv, bo) in snap.host_buffers(sort=False):
            _check_slot_range(n, stream.ctx.vertex_capacity,
                              (bk, bo), (bn, bo))
            yield w, (bk, bn, bo)
    except ValueError as e:
        if "window buffer overflow" in str(e):
            raise ValueError(
                f"{e} — note: the triangle paths store each window "
                "edge once and size their buffer as window_capacity // 2 "
                "(window_capacity keeps the ALL-direction doubled-buffer "
                "calibration)"
            ) from e
        raise


def _packed_out_windows(stream, window_ms: int, window_capacity: int | None,
                        n: int) -> Iterator[tuple[int, np.ndarray]]:
    """(window, packed i32 host column): ``key*n + nbr`` of the window's
    UNIQUE canonical undirected edges, ascending, no padding (requires
    n^2 < 2^31). Deduping on the host ships one lane per edge instead of
    the padded window."""
    for w, (bk, bn, bo) in _out_windows(stream, window_ms,
                                        window_capacity, n):
        a = np.minimum(bk[bo], bn[bo]).astype(np.int64)
        b = np.maximum(bk[bo], bn[bo]).astype(np.int64)
        keep = a != b  # self-loops close no triangles
        yield w, _sorted_unique(a[keep] * n + b[keep]).astype(np.int32)


def window_triangle_counts_device(stream, window_ms: int,
                                  capacity: int | None = None,
                                  window_capacity: int | None = None,
                                  method: str = "auto") -> Iterator[tuple]:
    """Like :func:`window_triangles` but yields (window, device scalar)
    without a host sync per window: pull the counts once at the end.

    When ``capacity^2 < 2^31`` this is the ``batch=1`` case of
    :func:`window_triangle_counts_batched` (one packed column a window).
    Past that, the unpacked dense path: each window's sorted ALL-direction
    view goes to the device and is counted over a ``bool[n, n]``
    adjacency, one window at a time."""
    n = capacity if capacity is not None else stream.ctx.vertex_capacity
    if n * n < PACKED_LIMIT:
        return window_triangle_counts_batched(
            stream, window_ms, capacity, window_capacity, method, batch=1
        )
    pick = _pick_method(method, n)

    def gen():
        snap = stream.slice(window_ms, "all",
                            window_capacity=window_capacity)
        for w, view in snap.views():
            _check_slot_range(
                n, stream.ctx.vertex_capacity,
                (view.key, view.valid), (view.nbr, view.valid),
            )
            yield w, _window_triangle_count(
                view, n, pick(view.key.shape[0], view.key.device))

    return gen()


def window_triangle_counts_batched(stream, window_ms: int,
                                   capacity: int | None = None,
                                   window_capacity: int | None = None,
                                   method: str = "auto",
                                   batch: int = 4,
                                   max_degree: int | None = None,
                                   yield_overflow: bool = False
                                   ) -> Iterator[tuple]:
    """Per-window counts with up to ``batch`` closed windows per staged
    copy: yields (window_index, ``int64`` scalar on ``stream.ctx.device``).
    Emission latency grows by up to ``batch - 1`` windows; the final
    partial group stages only its own windows.

    Host assembly, dedup and the host-to-device copy of the next group run
    on a worker thread while the device counts the current one. On a card
    the copy goes on a side stream and the consumer's stream waits on its
    event before the count's first kernel.

    ``max_degree`` selects the capped-degree sparse count
    (:func:`_window_triangle_count_sparse`), the path for large vertex
    capacities. Degree-cap overflow raises ``ValueError``; the check is
    deferred by one group, so up to ``batch`` counts of the overflowing
    group may be yielded (corrupt) before the raise. ``yield_overflow=True``
    yields ``(window, count, overflow)`` triples on this path instead, so
    a consumer can reject exactly the corrupt windows (the deferred raise
    still follows).

    Without ``max_degree``, capacities with ``capacity^2 >= 2^31`` take
    the unpacked dense per-window path (see
    :func:`window_triangle_counts_device`).
    """
    n = capacity if capacity is not None else stream.ctx.vertex_capacity
    if max_degree is None and n * n >= PACKED_LIMIT:
        return window_triangle_counts_device(
            stream, window_ms, capacity, window_capacity, method
        )
    device = torch.device(stream.ctx.device)
    if max_degree is not None:
        return _sparse_window_counts(stream, window_ms, window_capacity, n,
                                     batch, max_degree, yield_overflow,
                                     device)
    pick = _pick_method(method, n)
    put = _stage_to(device)

    def stage(group):
        # Columns are deduped/compact; pad the group to a shared
        # power-of-two bucket. k rows, not batch: a padding row would
        # still build a full adjacency and count it.
        k = len(group)
        wins = [w for w, _ in group]
        longest = max(c.shape[0] for _, c in group)
        bucket = max(1024, 1 << max(0, longest - 1).bit_length())
        stacked = np.full((k, bucket), INT_MAX, np.int32)
        for i, (_, c) in enumerate(group):
            stacked[i, : c.shape[0]] = c
        dev, ready = put(stacked)
        return wins, dev, ready

    def gen():
        for wins, stacked, ready in prefetch_map(
            stage,
            _in_groups(
                _packed_out_windows(stream, window_ms, window_capacity, n),
                batch,
            ),
            depth=2, workers=1,
        ):
            _await_staged(stacked, ready, device)
            counts = _window_triangle_count_packed_group(
                stacked, n, n, pick(2 * stacked.shape[1], stacked.device)
            )
            yield from zip(wins, counts)

    return gen()


def _sparse_window_counts(stream, window_ms, window_capacity, n, batch,
                          max_degree, yield_overflow, device):
    """The ``max_degree`` path of :func:`window_triangle_counts_batched`.

    Overflow checks are deferred by one group (and finalized after the
    loop): pulling the overflow scalar at once would sync the host per
    group and forfeit the pipelining."""
    def check(pending):
        if pending is None:
            return
        overs = to_numpy(pending)
        if overs.any():
            raise ValueError(
                f"window adjacency rows overflowed max_degree="
                f"{max_degree} ({int(overs.sum())} entries "
                "dropped); raise max_degree"
            )

    pending = None
    for group in _in_groups(
        _out_windows(stream, window_ms, window_capacity, n), batch
    ):
        wins = [w for w, _ in group]
        kk, nn, vv = (torch.from_numpy(np.stack(x)).to(device)
                      for x in zip(*(c for _, c in group)))
        counts, overs = _window_triangle_count_sparse_group(
            kk, nn, vv, n, max_degree)
        if yield_overflow:
            out = list(zip(wins, counts, overs))
        else:
            out = list(zip(wins, counts))
        check(pending)
        pending = overs
        yield from out
    check(pending)


def window_triangles(stream, window_ms: int, capacity: int | None = None,
                     window_capacity: int | None = None,
                     method: str = "auto",
                     max_degree: int | None = None) -> Iterator[tuple]:
    """Per-window triangle counts: yields (window_index, count).

    The reference emits (count, window.maxTimestamp) per window;
    ``window_index * window_ms + window_ms - 1`` recovers that timestamp.

    ``method``: ``"gather"`` (sparse windows), ``"mxu"`` (the wedge kernel,
    dense windows; needs ``capacity % 128 == 0``), ``"mxu_interpret"`` (the
    kernel's plain version) or ``"auto"`` (``"mxu"`` on a card when the
    window buffer is dense relative to capacity). ``max_degree`` selects
    the capped-degree sparse count (see
    :func:`window_triangle_counts_batched`).
    """
    if max_degree is not None:
        counts = window_triangle_counts_batched(
            stream, window_ms, capacity, window_capacity, method,
            batch=1, max_degree=max_degree)
    else:
        counts = window_triangle_counts_device(
            stream, window_ms, capacity, window_capacity, method)
    return ((w, int(c)) for w, c in counts)


def _wedge_count_slabbed(adj: torch.Tensor, key: torch.Tensor,
                         nbr: torch.Tensor, valid: torch.Tensor, n: int,
                         slab_bytes: int = 1 << 28) -> torch.Tensor:
    """:func:`_wedge_count_from_adj`'s ``"gather"`` count with the
    ``m[:, a] & m[:, b]`` product taken in slabs of lanes, so at most
    ``slab_bytes`` booleans are live at once (integer sums: the same
    count)."""
    m = adj.triu_(diagonal=1)
    canon = valid & (key < nbr)
    uniq = segments.unique_pairs_mask(key, nbr, canon, n)
    a = key.long().clamp(0, n - 1)
    b = nbr.long().clamp(0, n - 1)
    slab = max(1, slab_bytes // max(n, 1))
    total = torch.zeros((), dtype=torch.int64, device=adj.device)
    for lo in range(0, a.shape[0], slab):
        hi = lo + slab
        per_edge = (m[:, a[lo:hi]] & m[:, b[lo:hi]]).sum(
            dim=0, dtype=torch.int32)
        total = total + torch.where(uniq[lo:hi], per_edge, 0).sum(
            dtype=torch.int64)
    return total


def sharded_window_triangles(stream, window_ms: int,
                             capacity: int | None = None,
                             window_capacity: int | None = None,
                             mesh=None,
                             bucket_slack: float = 2.0) -> Iterator[tuple]:
    """Mesh-parallel window triangle count (``WindowTriangles.java:61-139``
    at parallelism > 1): yields ``(window_index, count)``, the count an
    ``int64`` 0-d tensor on the first shard's device.

    The direction-ALL keyed exchange
    (:class:`~gelly_torch.parallel.sharded_window.ShardedSnapshotStream`)
    puts each group vertex's window neighbourhood on its owner shard.
    Each shard scatters a ``uint8`` partial adjacency; the partials are
    summed across the shards (``gelly_tpu``'s ``psum``); then each shard
    counts the wedges closed by its owned canonical edges (the gather
    method, slabbed) and the counts are summed. Exact parity with
    :func:`window_triangles`."""
    from ..parallel import mesh as mesh_lib
    from ..parallel.sharded_window import ShardedSnapshotStream

    n = capacity if capacity is not None else stream.ctx.vertex_capacity
    m = mesh if mesh is not None else mesh_lib.make_mesh()
    snap = ShardedSnapshotStream(stream, window_ms, "all", window_capacity,
                                 m, bucket_slack)
    dev0 = m.devices[0]

    def gen():
        for w, views in snap.views():
            parts = []
            for v in views:
                part = torch.zeros((n, n), dtype=torch.uint8,
                                   device=v.key.device)
                ok = v.valid
                part[v.key[ok].long(), v.nbr[ok].long()] = 1
                parts.append(part)
            total = parts[0].clone()
            for p in parts[1:]:
                total += p.to(total.device)
            counts = [_wedge_count_slabbed(
                (total.to(v.key.device) > 0), v.key, v.nbr, v.valid, n
            ).to(dev0) for v in views]
            yield w, torch.stack(counts).sum()

    return gen()


# --------------------------------------------------------------------- #
# exact streaming


class TriangleCounts(NamedTuple):
    adj: torch.Tensor  # i32[N, N] arrival index of each edge (INT_MAX absent)
    counts: torch.Tensor  # i64[N] per-vertex triangle counters
    total: torch.Tensor  # i64[] global triangle count
    n_seen: torch.Tensor  # i32[] edges consumed (arrival-index base)


def fresh_triangle_counts(capacity: int, device="cpu") -> TriangleCounts:
    return TriangleCounts(
        adj=torch.full((capacity, capacity), INT_MAX, dtype=torch.int32,
                       device=device),
        counts=torch.zeros((capacity,), dtype=torch.int64, device=device),
        total=torch.zeros((), dtype=torch.int64, device=device),
        n_seen=torch.zeros((), dtype=torch.int32, device=device),
    )


def _needs_rebase(seen_host: int, chunk, budget: int) -> bool:
    """Arrival indices are i32: rebase the summary before they can wrap
    (a wrapped index would silently invert the closing-edge comparison).

    The rebase is LOSSLESS: stored indices are only ever compared against
    the arrival index of a *later* edge, so collapsing every present entry
    to -1 and resetting ``n_seen`` to 0 preserves all future comparisons.
    ``budget`` is INT_MAX in production; tests shrink it."""
    return seen_host + int(to_numpy(chunk.valid).sum()) >= (
        budget - chunk.capacity
    )


def _rebase_dense(state: TriangleCounts) -> TriangleCounts:
    adj = torch.where(state.adj != INT_MAX, -1, INT_MAX).to(torch.int32)
    return state._replace(adj=adj, n_seen=torch.zeros_like(state.n_seen))


def _rebase_sparse(state: "SparseTriangleCounts") -> "SparseTriangleCounts":
    aidx = torch.where(state.aidx != INT_MAX, -1, INT_MAX).to(torch.int32)
    return state._replace(aidx=aidx, n_seen=torch.zeros_like(state.n_seen))


def _exact_step_scan(state: TriangleCounts, chunk) -> TriangleCounts:
    """Sequential per-edge intersection within the chunk — the literal
    shape of IntersectNeighborhoods (ExactTriangleCount.java:74-116): a
    triangle increments when its closing edge arrives. The parity oracle
    of :func:`_exact_step` (one Python step an edge)."""
    adj = state.adj.clone()
    counts = state.counts.clone()
    total = state.total.clone()
    n_seen = state.n_seen.clone()
    for u, v, ok in zip(to_numpy(chunk.src).tolist(),
                        to_numpy(chunk.dst).tolist(),
                        to_numpy(chunk.valid).tolist()):
        fresh = ok and u != v and int(adj[u, v]) == INT_MAX
        if fresh:
            common = (adj[u] != INT_MAX) & (adj[v] != INT_MAX)
            c = common.sum(dtype=torch.int64)
            counts += common.to(torch.int64)
            counts[u] += c
            counts[v] += c
            total += c
            idx = torch.minimum(adj[u, v], n_seen)
            adj[u, v] = idx
            adj[v, u] = torch.minimum(adj[v, u], n_seen)
        n_seen += int(ok)
    return TriangleCounts(adj, counts, total, n_seen)


_EXACT_SLAB = 2048  # edges intersected per vectorized sub-step


def _pad(x: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,), value, dtype=x.dtype,
                                    device=x.device)])


def _arrivals(n_seen: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Global arrival index of every chunk position (valid edges count)."""
    return n_seen + torch.cumsum(valid.to(torch.int32), 0,
                                 dtype=torch.int32) - 1


def _exact_step(state: TriangleCounts, chunk) -> TriangleCounts:
    """Vectorized chunk step with exact per-edge closing semantics.

    The adjacency stores each edge's global *arrival index*; a triangle is
    attributed to edge e iff both wedge edges have smaller indices — i.e.
    exactly when its closing edge arrives (ExactTriangleCount.java:74-116)
    — with whole slabs of edges intersecting at once as masked
    ``[slab, N]`` row ops. All accumulation is integer. Slots lie in
    ``[0, N)`` (the streams check a narrowed capacity first). Returns a
    new state (the input's tensors are not changed)."""
    n = state.adj.shape[0]
    cap = chunk.capacity
    slab = min(_EXACT_SLAB, cap)
    pad = (-cap) % slab
    src = _pad(chunk.src, pad).long()
    dst = _pad(chunk.dst, pad).long()
    valid = _pad(chunk.valid, pad, False)
    ok0 = valid & (src != dst)
    idx = torch.where(ok0, _arrivals(state.n_seen, valid), INT_MAX)
    # Insert the whole chunk first: scatter-min keeps first arrivals, so
    # in-chunk wedges/duplicates resolve by global order.
    flat = state.adj.clone().view(-1)
    for a, b in ((src, dst), (dst, src)):
        flat.scatter_reduce_(0, a * n + b, idx, "amin")
    adj = flat.view(n, n)

    counts = state.counts.clone()
    total = state.total.clone()
    for lo in range(0, cap + pad, slab):
        su, sv, sidx = src[lo:lo + slab], dst[lo:lo + slab], idx[lo:lo + slab]
        rows_u = adj[su]  # [slab, N] arrival indices of u's neighbours
        rows_v = adj[sv]
        fresh = (sidx != INT_MAX) & (adj[su, sv] == sidx)
        lim = sidx[:, None]
        common = (rows_u < lim) & (rows_v < lim) & fresh[:, None]
        c_e = common.sum(dim=1, dtype=torch.int64)
        counts += common.sum(dim=0, dtype=torch.int64)
        add = torch.where(fresh, c_e, 0)
        counts.index_add_(0, su, add)
        counts.index_add_(0, sv, add)
        total += c_e.sum()
    return TriangleCounts(adj, counts, total,
                          state.n_seen + chunk.num_valid())


_STEP_FIELDS = ("src", "dst", "valid")


class ExactTriangleStream:
    """Insertion-only exact triangle counts, chunk-grained emission.

    Iterating yields :class:`TriangleCounts` after each chunk (on
    ``stream.ctx.device``); ``final()`` drains and returns the last.
    ``final_counts`` renders the reference's observable
    ``{vertex: count, -1: global}`` map (SumAndEmitCounters,
    ExactTriangleCount.java:121-134)."""

    def __init__(self, stream, capacity: int | None = None,
                 arrival_budget: int = INT_MAX):
        self.stream = stream
        self.capacity = (
            int(capacity) if capacity is not None
            else stream.ctx.vertex_capacity
        )
        self.arrival_budget = int(arrival_budget)
        self.stats = {"rebases": 0}

    def __iter__(self) -> Iterator[TriangleCounts]:
        n = self.capacity
        device = self.stream.ctx.device
        state = fresh_triangle_counts(n, device)
        seen_host = 0
        for c in self.stream:
            _check_slot_range(
                n, self.stream.ctx.vertex_capacity,
                (c.src, c.valid), (c.dst, c.valid),
            )
            if _needs_rebase(seen_host, c, self.arrival_budget):
                state = _rebase_dense(state)
                seen_host = 0
                self.stats["rebases"] += 1
            seen_host += int(to_numpy(c.valid).sum())
            state = _exact_step(state, c.to_fields(device, _STEP_FIELDS))
            yield state

    def final(self) -> TriangleCounts:
        if not getattr(self, "_drained", False):
            state = None
            for state in self:
                pass
            if state is None:  # empty stream: allocate the zero state lazily
                state = fresh_triangle_counts(self.capacity,
                                              self.stream.ctx.device)
            self._final = state
            self._drained = True
        return self._final

    def final_counts(self) -> dict[int, int]:
        return _final_counts(self.final(), self.stream.ctx)


def _final_counts(state, ctx) -> dict[int, int]:
    out = {-1: int(state.total)}
    counts = to_numpy(state.counts)
    nz = np.nonzero(counts)[0]
    for slot, raw in zip(nz.tolist(), ctx.decode(nz).tolist()):
        out[raw] = int(counts[slot])
    return out


def exact_triangle_count(stream, capacity: int | None = None,
                         max_degree: int | None = None,
                         arrival_budget: int = INT_MAX):
    """Exact streaming triangle counts.

    ``max_degree=None`` → dense arrival-index matrix (O(N^2) memory, the
    small-N fast path); ``max_degree=D`` → capped-degree sparse table
    (O(N*D) memory, the N >= 1M path; degree overflow raises).

    Arrival indices are i32; when the stream approaches ``arrival_budget``
    edges (default ~2^31) the summary is REBASED — a lossless reset of
    stored indices (see :func:`_needs_rebase`) — so unbounded streams
    never stop or lose counts. ``stats["rebases"]`` counts them.

    Overflow contract (sparse path): the check is deferred by one chunk,
    so the iterator may yield ONE state whose counts are corrupt before
    raising ``ValueError``; gate on the yielded ``state.overflow`` (0 =
    clean). ``final()``/``final_counts()`` never observe a corrupt state.
    """
    if max_degree is not None:
        return SparseExactTriangleStream(
            stream, max_degree, capacity, arrival_budget=arrival_budget
        )
    return ExactTriangleStream(stream, capacity,
                               arrival_budget=arrival_budget)


# --------------------------------------------------------------------- #
# sparse (capped-degree) exact streaming — the N >= 1M path


class SparseTriangleCounts(NamedTuple):
    """Capped-degree adjacency: memory O(N * D) instead of O(N^2). Each
    vertex keeps up to ``D`` (neighbor, arrival-index) pairs; degree
    overflow is counted and raised — never a silent wrong count."""

    nbr: torch.Tensor  # i32[N, D] neighbor slots (-1 empty)
    aidx: torch.Tensor  # i32[N, D] arrival index of that edge
    deg: torch.Tensor  # i32[N] stored neighbors per vertex
    counts: torch.Tensor  # i64[N]
    total: torch.Tensor  # i64[]
    n_seen: torch.Tensor  # i32[]
    overflow: torch.Tensor  # i32[] neighbor inserts dropped by the cap


def fresh_sparse_triangle_counts(capacity: int, max_degree: int,
                                 device="cpu") -> SparseTriangleCounts:
    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return SparseTriangleCounts(
        nbr=full((capacity, max_degree), -1, torch.int32),
        aidx=full((capacity, max_degree), INT_MAX, torch.int32),
        deg=full((capacity,), 0, torch.int32),
        counts=full((capacity,), 0, torch.int64),
        total=full((), 0, torch.int64),
        n_seen=full((), 0, torch.int32),
        overflow=full((), 0, torch.int32),
    )


def _row_append(nbr, aidx, deg, overflow, key, val, idx, ok, max_degree):
    """Append ``(val, idx)`` into ``key``'s row at its next free slot;
    conflicting appends within the batch get consecutive slots via
    in-group ranks (stable, lane order). Updates ``nbr``, ``aidx`` and
    ``deg`` in place; returns them with the new overflow count."""
    n = nbr.shape[0]
    sort_key = torch.where(ok, key, INT_MAX)
    k_s, order = torch.sort(sort_key, stable=True)
    first = torch.searchsorted(k_s, k_s, side="left")
    rank = torch.arange(k_s.shape[0], device=k_s.device) - first
    slot = deg[k_s.clamp(0, n - 1).long()].long() + rank
    ok_s = ok[order]
    fits = ok_s & (slot < max_degree)
    overflow = overflow + (ok_s & (slot >= max_degree)).sum(
        dtype=torch.int32)
    flat = k_s.long() * max_degree + slot
    put_where_(nbr.view(-1), flat, val[order], fits)
    put_where_(aidx.view(-1), flat, idx[order], fits)
    # Count only inserts that landed: deg equals the row fill; dropped
    # inserts are recorded solely in ``overflow``.
    deg.index_add_(0, torch.where(fits, k_s, 0).long(), fits.to(deg.dtype))
    return nbr, aidx, deg, overflow


def _sparse_exact_step(state: SparseTriangleCounts, chunk, max_degree: int,
                       slab: int) -> SparseTriangleCounts:
    """Chunk step over the capped-degree table: dedup, append both
    directions, then slab-intersect rows with the same arrival-index
    closing-edge attribution as the dense step. Returns a new state."""
    D = max_degree
    cap = chunk.capacity
    pad = (-cap) % slab
    src = _pad(chunk.src, pad)
    dst = _pad(chunk.dst, pad)
    valid = _pad(chunk.valid, pad, False)
    ok0 = valid & (src != dst)
    arrivals = _arrivals(state.n_seen, valid)
    # Dedup: already-present pairs (row scan) and repeat canonical pairs
    # within the chunk are no-ops.
    present = (state.nbr[src.long()] == dst[:, None]).any(dim=1)
    a = torch.minimum(src, dst)
    b = torch.maximum(src, dst)
    first_in_chunk = segments.unique_pairs_mask(a, b, ok0,
                                                state.deg.shape[0])
    fresh = ok0 & ~present & first_in_chunk
    idx = torch.where(fresh, arrivals, INT_MAX)

    nbr, aidx, deg = state.nbr.clone(), state.aidx.clone(), state.deg.clone()
    nbr, aidx, deg, overflow = _row_append(
        nbr, aidx, deg, state.overflow, src, dst, idx, fresh, D)
    nbr, aidx, deg, overflow = _row_append(
        nbr, aidx, deg, overflow, dst, src, idx, fresh, D)

    counts = state.counts.clone()
    total = state.total.clone()
    for lo in range(0, cap + pad, slab):
        su = src[lo:lo + slab].long()
        sv = dst[lo:lo + slab].long()
        sidx, sfresh = idx[lo:lo + slab], fresh[lo:lo + slab]
        nu, au = nbr[su], aidx[su]  # [slab, D]
        nv, av = nbr[sv], aidx[sv]
        lim = sidx[:, None]
        ok_u = (nu >= 0) & (au < lim)
        ok_v = (nv >= 0) & (av < lim)
        # [slab, D, D] equality: w in both rows with earlier arrivals.
        match = ((nu[:, :, None] == nv[:, None, :])
                 & ok_u[:, :, None] & ok_v[:, None, :]
                 & sfresh[:, None, None])
        c_e = match.sum(dim=(1, 2), dtype=torch.int64)
        # +1 to each matched common vertex w (empty slots hold -1: route
        # them, and every non-matching entry, to a no-op).
        w_hits = match.sum(dim=2, dtype=torch.int64)  # [slab, D]
        hit = ok_u & (w_hits > 0)
        counts.index_add_(0, torch.where(hit, nu, 0).long().reshape(-1),
                          torch.where(hit, w_hits, 0).reshape(-1))
        add = torch.where(sfresh, c_e, 0)
        counts.index_add_(0, su, add)
        counts.index_add_(0, sv, add)
        total += c_e.sum()
    return SparseTriangleCounts(
        nbr, aidx, deg, counts, total,
        state.n_seen + chunk.num_valid(), overflow,
    )


class SparseExactTriangleStream:
    """Exact triangle counts over a capped-degree sparse adjacency — the
    observable surface of :class:`ExactTriangleStream`, memory
    O(N * max_degree)."""

    def __init__(self, stream, max_degree: int, capacity: int | None = None,
                 slab: int | None = None,
                 arrival_budget: int = INT_MAX):
        self.stream = stream
        self.max_degree = int(max_degree)
        self.capacity = (
            int(capacity) if capacity is not None
            else stream.ctx.vertex_capacity
        )
        # Keep [slab, D, D] intersection tensors around ~2^22 elements.
        self.slab = (
            int(slab) if slab is not None
            else max(8, (1 << 22) // (self.max_degree ** 2))
        )
        self.arrival_budget = int(arrival_budget)
        self.stats = {"rebases": 0}

    def _overflow_error(self, n: int) -> ValueError:
        return ValueError(
            f"{n} neighbor inserts exceeded max_degree {self.max_degree} "
            f"(degree-skewed stream); raise max_degree or use the dense path"
        )

    def __iter__(self) -> Iterator[SparseTriangleCounts]:
        device = self.stream.ctx.device
        state = fresh_sparse_triangle_counts(self.capacity, self.max_degree,
                                             device)
        prev_overflow = None
        seen_host = 0
        for c in self.stream:
            _check_slot_range(
                self.capacity, self.stream.ctx.vertex_capacity,
                (c.src, c.valid), (c.dst, c.valid),
            )
            if _needs_rebase(seen_host, c, self.arrival_budget):
                state = _rebase_sparse(state)
                seen_host = 0
                self.stats["rebases"] += 1
            seen_host += int(to_numpy(c.valid).sum())
            state = _sparse_exact_step(
                state, c.to_fields(device, _STEP_FIELDS), self.max_degree,
                self.slab)
            # Check the PREVIOUS chunk's overflow after dispatching the
            # current one: the host sync lands on finished work. (At most
            # one corrupt state is yielded before the raise.)
            if prev_overflow is not None and int(prev_overflow):
                raise self._overflow_error(int(prev_overflow))
            prev_overflow = state.overflow
            yield state
        if prev_overflow is not None and int(prev_overflow):
            raise self._overflow_error(int(prev_overflow))

    def final(self) -> SparseTriangleCounts:
        if not getattr(self, "_drained", False):
            state = None
            for state in self:
                pass
            if state is None:
                state = fresh_sparse_triangle_counts(
                    self.capacity, self.max_degree, self.stream.ctx.device)
            self._final = state
            self._drained = True
        return self._final

    def final_counts(self) -> dict[int, int]:
        return _final_counts(self.final(), self.stream.ctx)


# --------------------------------------------------------------------- #
# sampled estimation


class SamplerState(NamedTuple):
    src: torch.Tensor  # i32[S] sampled edge endpoints
    trg: torch.Tensor
    third: torch.Tensor  # i32[S] sampled third vertex
    src_found: torch.Tensor  # bool[S]
    trg_found: torch.Tensor  # bool[S]
    v_at: torch.Tensor  # i32[S] live vertex count when this sample was drawn
    edge_count: torch.Tensor  # i32[] edges seen
    keys: torch.Tensor  # i64[S, 2] per-instance Threefry keys (u32 values)


def _fresh_sampler(num_samples: int, seed: int, device="cpu") -> SamplerState:
    s = num_samples

    def full(v, dtype, shape=(s,)):
        return torch.full(shape, v, dtype=dtype, device=device)

    return SamplerState(
        src=full(-1, torch.int32), trg=full(-1, torch.int32),
        third=full(-1, torch.int32),
        src_found=full(False, torch.bool), trg_found=full(False, torch.bool),
        v_at=full(0, torch.int32), edge_count=full(0, torch.int32, ()),
        # Per-instance keys: instance j's randomness depends only on its
        # own key stream, as in the reference's broadcast/incidence layouts.
        keys=threefry.split(threefry.prng_key(seed, device), s),
    )


def _sampler_step(state: SamplerState, chunk,
                  num_vertices: int) -> SamplerState:
    """Advance all S reservoir instances over every lane of the chunk in
    stream order (TriangleSampler.flatMap,
    BroadcastTriangleCount.java:79-126): the kernel on a card, its plain
    version on the CPU (:func:`~gelly_torch.ops.kernels.sampler_step`).
    Self-loops and padding lanes are no-op events that still advance
    every key."""
    return SamplerState(*kernels.sampler_step(
        tuple(state), chunk.src, chunk.dst, chunk.valid, int(num_vertices)))


def sampler_estimate(state: SamplerState, num_vertices=None) -> float:
    """(1/S) * Σ_j beta_j (V_j - 2) * edge_count — TriangleSummer's scaling
    (BroadcastTriangleCount.java:158-166), each instance scaled by the
    vertex count its third-vertex draw was made against (``V_j == V``
    when the caller fixes ``num_vertices``). In ``float32``."""
    beta = (state.src_found & state.trg_found).to(torch.float32)
    v = (state.v_at if num_vertices is None
         else torch.full_like(state.v_at, num_vertices))
    scaled = (beta * (v - 2).clamp(min=0).to(torch.float32)).sum()
    s = state.src.shape[0]
    return float(scaled / s * state.edge_count.to(torch.float32))


def _shard_sampler(state: SamplerState, mesh) -> list:
    """The instance axis split into S contiguous blocks, one a shard
    (``gelly_tpu``'s ``device_put_sharded_leading``); ``edge_count`` is
    replicated."""
    S = len(mesh.devices)
    per = state.src.shape[0] // S
    out = []
    for i, dev in enumerate(mesh.devices):
        out.append(SamplerState(*(
            (f[i * per:(i + 1) * per] if f.dim() else f).to(dev, copy=True)
            for f in state)))
    return out


def sharded_sampler_estimate(states: list, num_vertices=None) -> float:
    """:func:`sampler_estimate` over a sharded instance axis: each shard's
    ``float32`` partial sum, added in shard order (``gelly_tpu``'s
    ``psum``; its grouping may differ in the last bits)."""
    dev = states[0].src.device
    scaled = torch.zeros((), dtype=torch.float32, device=dev)
    for st in states:
        beta = (st.src_found & st.trg_found).to(torch.float32)
        v = (st.v_at if num_vertices is None
             else torch.full_like(st.v_at, num_vertices))
        scaled = scaled + (beta * (v - 2).clamp(min=0).to(
            torch.float32)).sum().to(dev)
    s = sum(st.src.shape[0] for st in states)
    return float(scaled / s * states[0].edge_count.to(dev, torch.float32))


def sharded_sampler_run(stream, num_samples: int, mesh,
                        num_vertices: int | None = None,
                        seed: int = 0xDEADBEEF) -> Iterator[tuple]:
    """``(per-shard states, estimate)`` after each chunk of the sharded
    sampler: every shard advances its instances over the whole chunk
    (edges replicated, ``BroadcastTriangleCount.java:41-45``) with the
    sampler kernel."""
    S = len(mesh.devices)
    if num_samples % S:
        raise ValueError(
            f"num_samples {num_samples} not divisible by {S} shards"
        )
    states = _shard_sampler(
        _fresh_sampler(num_samples, seed, mesh.devices[0]), mesh)
    for c in stream:
        v = (num_vertices if num_vertices is not None
             else stream.ctx.table.num_vertices)
        states = [_sampler_step(st, c.to_fields(dev, _STEP_FIELDS), v)
                  for st, dev in zip(states, mesh.devices)]
        yield states, sharded_sampler_estimate(states, num_vertices)


def sampled_triangle_count(stream, num_samples: int,
                           num_vertices: int | None = None,
                           seed: int = 0xDEADBEEF,
                           mesh=None) -> Iterator[float]:
    """Streaming estimate, one value per chunk.

    ``seed`` defaults to the incidence example's seeded RNG
    (IncidenceSamplingTriangleCount.java:78). ``num_vertices`` defaults to
    the stream's *live* vertex count, read after each chunk is produced
    (the slot capacity can be much larger, which would blow up variance
    via phantom third-vertex draws). The state lives on
    ``stream.ctx.device``, or with ``mesh`` its instance axis is split
    over the shards (:func:`sharded_sampler_run`): the per-instance key
    streams make every instance's state the unsharded run's, bit for bit.
    """
    if mesh is not None:
        if num_samples % len(mesh.devices):
            raise ValueError(
                f"num_samples {num_samples} not divisible by "
                f"{len(mesh.devices)} shards"
            )
        return (est for _, est in sharded_sampler_run(
            stream, num_samples, mesh, num_vertices, seed))
    device = stream.ctx.device

    def gen():
        state = _fresh_sampler(num_samples, seed, device)
        for c in stream:
            v = (num_vertices if num_vertices is not None
                 else stream.ctx.table.num_vertices)
            state = _sampler_step(state, c.to_fields(device, _STEP_FIELDS), v)
            yield sampler_estimate(state, num_vertices)

    return gen()
