"""Device-resident open-addressing hash set over ``int64`` keys.

Counterpart of ``gelly_tpu/ops/hashset.py``: the reference's per-key
``HashSet`` state of ``DistinctEdgeMapper`` (``M/SimpleEdgeStream.java:
309-323``) as a fixed-capacity linear-probing table on the device. A
chunk's insert keeps chunk order (exact first-wins semantics); on CUDA it
is one launch of the hand kernel ``csrc/hashset.cu``
(:func:`~gelly_torch.ops.kernels.hashset_insert`), on the CPU its plain
version. The table's layout is bit for bit the reference's.

Key contract: any ``int64`` except :data:`EMPTY` (int64 min), the free-slot
sentinel. In-repo callers pack non-negative (src, dst) slot pairs.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from . import kernels

EMPTY = kernels.HASH_EMPTY


class HashSetState(NamedTuple):
    keys: torch.Tensor  # i64[capacity], EMPTY where unoccupied
    count: torch.Tensor  # i32[] number of occupied slots


def make_hashset(capacity: int,
                 device: torch.device | str = DEFAULT_DEVICE) -> HashSetState:
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    dev = resolve_device(device)
    return HashSetState(
        keys=torch.full((capacity,), EMPTY, dtype=torch.int64, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _hash(key: torch.Tensor, mask: int) -> torch.Tensor:
    """Fibonacci hashing on the low 64 bits (the int64 product wraps)."""
    h = (key.to(torch.int64) * kernels.HASH_MUL) >> 32
    return (h & mask).to(torch.int32)


def insert_chunk(state: HashSetState, keys: torch.Tensor,
                 valid: torch.Tensor):
    """Insert ``keys[valid]`` in order; returns ``(state, is_new)``.

    ``is_new[i]`` is True iff ``keys[i]`` was not present before position
    ``i`` (counting prior chunks and earlier entries of this chunk)."""
    table, count, is_new = kernels.hashset_insert(
        state.keys, state.count, keys.to(torch.int64).contiguous(),
        valid.contiguous())
    return HashSetState(table, count), is_new


def contains_chunk(state: HashSetState, keys: torch.Tensor) -> torch.Tensor:
    """Membership test (no insertion): ``bool[len(keys)]``."""
    return kernels.hashset_contains(state.keys,
                                    keys.to(torch.int64).contiguous())


class DeviceHashSet:
    """Auto-growing device hash set: before a chunk could push the load
    past ``max_load``, the table doubles (as often as needed) and the old
    table's occupied slots are re-inserted in slot order through the same
    insert, one doubling at a time, as the reference grows it; an empty
    table is just replaced. ``rehashes`` and ``rehash_s`` (host seconds,
    synchronised) count the re-inserts."""

    def __init__(self, capacity: int = 1 << 16, max_load: float = 0.65,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.state = make_hashset(capacity, device)
        self.max_load = max_load
        self.rehashes = 0
        self.rehash_s = 0.0

    def insert(self, keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        cap = self.state.keys.shape[0]
        pending = int(self.state.count) + int(keys.shape[0])
        grown = cap
        while pending > self.max_load * grown:
            grown *= 2
        if grown == cap:
            self.state, is_new = insert_chunk(self.state, keys, valid)
            return is_new
        if pending - int(keys.shape[0]) == 0:
            # An empty table: every doubling would re-insert nothing.
            self.state = make_hashset(grown, self.state.keys.device)
            cap = grown
        while cap < grown:
            t0 = time.perf_counter()
            cap *= 2
            old = self.state.keys
            self.state, _ = insert_chunk(make_hashset(cap, old.device), old,
                                         old != EMPTY)
            if old.device.type == "cuda":
                torch.cuda.current_stream(old.device).synchronize()
            self.rehashes += 1
            self.rehash_s += time.perf_counter() - t0
        self.state, is_new = insert_chunk(self.state, keys, valid)
        return is_new
