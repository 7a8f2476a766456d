"""Edge partitioning across the mesh — the ``keyBy`` / ``PartitionMapper``
analog.

Counterpart of ``gelly_tpu/parallel/partition.py``, with its three modes:

1. **edge data parallelism** (:func:`split_chunk`): a chunk is sliced
   evenly across the shards, each folding its slice into a full-width
   local summary;
2. **the vertex-hash exchange** (:func:`repartition_by_key`): the keyed
   shuffle. Every shard buckets its entries by owner shard, and one
   ``all_to_all`` delivers each entry to the shard owning its key;
   buckets have a static capacity, and overflow is counted, never silent;
3. **broadcast then mask** (:func:`owned_mask`): every shard sees the whole
   chunk and keeps its own keys.

Ownership is STRIPED: slot ``s`` lives on shard ``s % S`` at local offset
``s // S`` (vertex tables assign slots in order, so a range partition
would send every early vertex to shard 0).

On a mesh that spans processes, the exchange is one
``torch.distributed.all_to_all_single`` a leaf over host-staged blocks
(the splits are equal: the bucket capacity is fixed), and the dropped
count goes through ``collectives.psum_tree`` (added in shard order). Each
process passes and gets back its own shards (``None`` elsewhere).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chunk import EdgeChunk
from ..engine.checkpoint import tree_flatten, tree_map, tree_unflatten
from .collectives import host_buffer, psum_tree


def _split_leaf(x: torch.Tensor, num_shards: int) -> list[torch.Tensor]:
    c = x.shape[0]
    per = -(-c // num_shards)
    pad = per * num_shards - c
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return [x[i * per:(i + 1) * per] for i in range(num_shards)]


def split_chunk(chunk: EdgeChunk, num_shards: int) -> list[EdgeChunk]:
    """Slice a chunk ``[C]`` into ``num_shards`` per-shard chunks of
    ``ceil(C / S)`` lanes (``gelly_tpu``'s ``[S, ceil(C/S)]`` reshape),
    padding the tail with zero (invalid) lanes first. The slices stay where
    the chunk is; the caller moves each to its shard."""
    fields = [_split_leaf(x, num_shards) for x in chunk]
    return [EdgeChunk(*(f[i] for f in fields)) for i in range(num_shards)]


def slots_per_shard(vertex_capacity: int, num_shards: int) -> int:
    if vertex_capacity % num_shards:
        raise ValueError(
            f"vertex_capacity {vertex_capacity} not divisible by {num_shards}"
        )
    return vertex_capacity // num_shards


def owner_of(slots, num_shards: int):
    """Shard index owning each vertex slot (striped: ``slot % S``)."""
    return slots % num_shards


def owned_mask(slots: torch.Tensor, num_shards: int,
               shard: int) -> torch.Tensor:
    """Mask of the entries whose key ``shard`` owns (``gelly_tpu`` reads
    the shard from ``axis_index``; the port passes it)."""
    return owner_of(slots, num_shards) == shard


def to_local_slot(slots, num_shards: int):
    """Global slot -> offset within the owning shard's state slice."""
    return slots // num_shards


def unstripe(flat, num_shards: int):
    """Reorder a ``[S*per]`` shard-concatenated striped state array back
    to global slot order: ``result[s] = flat[(s % S) * per + s // S]``.
    Works on numpy arrays and tensors."""
    per = flat.shape[0] // num_shards
    y = flat.reshape((num_shards, per) + tuple(flat.shape[1:]))
    y = y.swapaxes(0, 1) if isinstance(y, np.ndarray) else y.transpose(0, 1)
    return y.reshape(flat.shape)


def default_bucket_capacity(local_len: int, num_shards: int,
                            slack: float = 2.0) -> int:
    """Static per-destination bucket size: ``slack`` x the fair share of a
    shard's local entries, floored at 64 and capped at ``local_len``."""
    fair = int(-(-local_len * slack // num_shards))
    return min(local_len, max(64, fair))


def _bucket_one(key: torch.Tensor, payload, valid: torch.Tensor,
                num_shards: int, bucket: int):
    """One shard's send side: entries sorted stably by owner shard
    (invalid last), ranked within their group, and scattered into
    ``S * bucket`` lanes; the rank-overflowing entries go to the spare lane
    ``flat`` and are counted."""
    L = key.shape[0]
    dev = key.device
    owner = torch.where(valid, owner_of(key, num_shards),
                        torch.full_like(key, num_shards))
    owner_s, order = torch.sort(owner, stable=True)
    starts = torch.searchsorted(
        owner_s, torch.arange(num_shards, dtype=owner_s.dtype, device=dev))
    rank = torch.arange(L, device=dev) - starts[
        owner_s.clamp(0, num_shards - 1).long()]
    live_owner = owner_s < num_shards
    live = live_owner & (rank < bucket)
    dropped = (live_owner & (rank >= bucket)).sum(dtype=torch.int64)
    flat = num_shards * bucket
    dest = torch.where(live, owner_s.long() * bucket + rank, flat)

    def scatter(x_sorted: torch.Tensor) -> torch.Tensor:
        out = x_sorted.new_zeros((flat + 1,) + tuple(x_sorted.shape[1:]))
        out[dest] = x_sorted
        return out[:flat]

    key_b = scatter(key[order])
    valid_b = torch.zeros(flat + 1, dtype=torch.bool, device=dev)
    valid_b[dest] = True
    payload_b = tree_map(lambda x: scatter(x[order]), payload)
    return key_b, payload_b, valid_b[:flat], dropped


def all_to_all(mesh, blocks: list, num_shards: int) -> list:
    """``lax.all_to_all(split_axis=0, concat_axis=0)`` over a list of S
    per-shard ``[S * b, ...]`` tensors: shard ``j`` receives block ``j`` of
    every shard, in shard order, on its device."""
    if mesh.process_count > 1:
        return _all_to_all_processes(mesh, blocks, num_shards)
    b = blocks[0].shape[0] // num_shards
    out = []
    for j, dev in enumerate(mesh.devices):
        out.append(torch.cat([
            blocks[s][j * b:(j + 1) * b].to(dev, non_blocking=True)
            for s in range(num_shards)]))
    return out


def _all_to_all_processes(mesh, blocks: list, num_shards: int) -> list:
    """:func:`all_to_all` on a mesh that spans processes: every local
    block's rows as bytes in one host buffer, ordered (destination
    process, source shard, destination shard), one ``all_to_all_single``
    with equal splits, then each local shard's ``S * b`` rows in source
    shard order."""
    import torch.distributed as dist

    local = mesh.local_shards
    d, n_proc = len(local), mesh.process_count
    x0 = blocks[local[0]]
    b = x0.shape[0] // num_shards
    rows = [blocks[s].contiguous().reshape(num_shards * b, -1)
            .view(torch.uint8) for s in local]
    width = rows[0].shape[1]
    cuda = any(r.is_cuda for r in rows)
    send = host_buffer(n_proc * d * d * b * width, cuda)
    sv = send.view(n_proc, d, d, b, width)
    for k, r in enumerate(rows):
        sv[:, k].copy_(r.reshape(n_proc, d, b, width))
    recv = host_buffer(send.numel(), cuda)
    dist.all_to_all_single(recv, send)
    own = send.numel() // n_proc
    mesh.sent_bytes += send.numel() - own
    mesh.received_bytes += recv.numel() - own
    rv = recv.view(n_proc, d, d, b, width)
    out = [None] * num_shards
    for k, j in enumerate(local):
        part = rv[:, :, k].reshape(num_shards * b, width)
        dev = mesh.devices[j]
        part = part.to(dev) if dev.type != "cpu" else part.contiguous()
        out[j] = part.view(x0.dtype).reshape(
            (num_shards * b,) + tuple(x0.shape[1:]))
    return out


def _tree_all_to_all(mesh, trees: list, num_shards: int) -> list:
    flat = [tree_flatten(t) if t is not None else None for t in trees]
    leaves, spec = next(f for f in flat if f is not None)
    moved = [all_to_all(mesh, [f[0][i] if f is not None else None
                               for f in flat], num_shards)
             for i in range(len(leaves))]
    return [tree_unflatten(spec, [m[j] for m in moved])
            if flat[j] is not None else None for j in range(num_shards)]


def psum_scalar(mesh, values: list) -> list:
    """``lax.psum`` of one scalar tensor a shard: every shard gets the sum
    (added in shard order) on its device."""
    return psum_tree(values, mesh=mesh)


def repartition_by_key(mesh, keys: list, payloads: list, valids: list,
                       num_shards: int, bucket_capacity: int):
    """The keyBy shuffle: deliver every entry to the shard owning its key.

    ``keys`` (i32 vertex slots), ``payloads`` (a tree of ``[L, ...]``
    leaves riding along) and ``valids`` (bool) are lists of S per-shard
    values. Returns ``(keys', payloads', valids', dropped)``, each a list
    of S per-shard values with leading dim ``S * bucket_capacity``: every
    valid received entry is owned by its shard (on a mesh that spans
    processes, each process passes and gets back its own shards, ``None``
    elsewhere). ``dropped`` is the GLOBAL count (a 0-d ``int64`` a shard)
    of entries that overflowed their destination bucket; callers must
    surface it. Entries keep ``gelly_tpu``'s order: a stable sort by owner
    within each sender, senders in shard order."""
    sent = [_bucket_one(k, p, v, num_shards, bucket_capacity)
            if k is not None else None
            for k, p, v in zip(keys, payloads, valids)]

    def part(n):
        return [s[n] if s is not None else None for s in sent]

    dropped = psum_scalar(mesh, part(3))
    return (all_to_all(mesh, part(0), num_shards),
            _tree_all_to_all(mesh, part(1), num_shards),
            all_to_all(mesh, part(2), num_shards),
            dropped)
