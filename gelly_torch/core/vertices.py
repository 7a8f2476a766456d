"""Host-side vertex-id densification (a copy of ``gelly_tpu/core/vertices.py``;
the port imports nothing of ``gelly_tpu``, so it keeps its own).

The reference keys state by arbitrary ``K`` ids in per-subtask hash maps
(e.g. ``DegreeMapFunction``'s ``HashMap<K, Long>``,
``M/SimpleEdgeStream.java:461-478``, and ``DisjointSet``'s ``HashMap<R,R>``,
``M/summaries/DisjointSet.java:28-29``). In the port, as in
``gelly_tpu``, summaries are fixed-shape tensors indexed by a dense ``i32``
slot, so raw ids are translated once at
ingest on the host and never appear on device.

Two tables:

- :class:`VertexTable` — growable raw→slot mapping (sorted-array +
  ``searchsorted``, fully vectorized) for arbitrary sparse/64-bit id spaces.
- :class:`IdentityVertexTable` — zero-cost pass-through when ids are already
  dense integers in ``[0, capacity)`` (the fast path for benchmark graphs).
"""

from __future__ import annotations

import threading

import numpy as np


class VertexTable:
    """Growable raw-id → dense-slot dictionary (host side).

    ``capacity`` (when set, e.g. by the stream context binding this table)
    bounds the slot space; encoding more distinct ids than that raises instead
    of silently corrupting device summaries sized to the capacity.

    Internals are fully vectorized (no per-id Python loop): known ids live in
    two sorted arrays probed with ``searchsorted`` — a large ``main`` region
    and a small ``pending`` region that absorbs new ids cheaply (O(pending)
    insert) and is merged into main only when it outgrows a threshold, so a
    long stream of gradually-arriving ids costs amortized O(new) per batch
    instead of an O(table) rebuild every chunk.
    """

    _MERGE_THRESHOLD = 1 << 16

    def __init__(self, capacity: int | None = None):
        self._sorted_ids = np.empty(0, np.int64)  # main region, sorted
        self._sorted_slots = np.empty(0, np.int32)  # slot of _sorted_ids[i]
        self._pend_ids = np.empty(0, np.int64)  # pending region, sorted
        self._pend_slots = np.empty(0, np.int32)
        self._rev = np.empty(0, np.int64)  # slot -> raw id
        self.capacity = capacity
        # encode runs on the prefetch thread while consumers call
        # lookup/decode from the main thread; the multi-array updates are
        # not atomic, so all table accesses serialize on this lock.
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return int(self._rev.shape[0])

    @property
    def num_vertices(self) -> int:
        return len(self)

    @staticmethod
    def _probe(ids: np.ndarray, slots: np.ndarray, q: np.ndarray) -> np.ndarray:
        """Slots for ``q`` against one sorted region; -1 where absent."""
        if ids.shape[0] == 0:
            return np.full(q.shape[0], -1, np.int32)
        pos = np.minimum(np.searchsorted(ids, q), ids.shape[0] - 1)
        return np.where(ids[pos] == q, slots[pos], -1).astype(np.int32)

    def encode(self, raw_ids: np.ndarray) -> np.ndarray:
        """Map raw ids to dense slots, assigning new slots for unseen ids."""
        raw = np.asarray(raw_ids).ravel().astype(np.int64)
        if raw.size == 0:
            return np.empty(0, np.int32)
        with self._lock:
            return self._encode_locked(raw)

    def _encode_locked(self, raw: np.ndarray) -> np.ndarray:
        uniq, first_idx, inv = np.unique(
            raw, return_index=True, return_inverse=True
        )
        uniq_slots = self._probe(self._sorted_ids, self._sorted_slots, uniq)
        miss = uniq_slots < 0
        if miss.any():
            uniq_slots[miss] = self._probe(
                self._pend_ids, self._pend_slots, uniq[miss]
            )
        new = uniq_slots < 0
        new_ids = uniq[new]
        if new_ids.size:
            base = self._rev.shape[0]
            if self.capacity is not None and base + new_ids.size > self.capacity:
                raise ValueError(
                    f"vertex table overflow: more than {self.capacity} "
                    f"distinct vertex ids in the stream (raise vertex_capacity)"
                )
            # Slots follow first appearance in the batch (streaming parity:
            # the reference assigns state entries in arrival order).
            order = np.argsort(first_idx[new], kind="stable")
            new_slots = np.empty(new_ids.size, np.int32)
            new_slots[order] = np.arange(
                base, base + new_ids.size, dtype=np.int32
            )
            uniq_slots[new] = new_slots
            self._rev = np.concatenate([self._rev, new_ids[order]])
            ins = np.searchsorted(self._pend_ids, new_ids)
            self._pend_ids = np.insert(self._pend_ids, ins, new_ids)
            self._pend_slots = np.insert(self._pend_slots, ins, new_slots)
            if self._pend_ids.shape[0] > self._MERGE_THRESHOLD:
                self._merge_pending()
        return uniq_slots[inv]

    def _merge_pending(self):
        ids = np.concatenate([self._sorted_ids, self._pend_ids])
        slots = np.concatenate([self._sorted_slots, self._pend_slots])
        order = np.argsort(ids, kind="stable")
        self._sorted_ids = ids[order]
        self._sorted_slots = slots[order]
        self._pend_ids = np.empty(0, np.int64)
        self._pend_slots = np.empty(0, np.int32)

    def lookup(self, raw_ids: np.ndarray) -> np.ndarray:
        """Map raw ids to slots; unseen ids map to -1."""
        raw = np.asarray(raw_ids).ravel().astype(np.int64)
        if raw.size == 0:
            return np.full(raw.shape[0], -1, np.int32)
        with self._lock:
            out = self._probe(self._sorted_ids, self._sorted_slots, raw)
            miss = out < 0
            if miss.any():
                out[miss] = self._probe(
                    self._pend_ids, self._pend_slots, raw[miss]
                )
            return out

    def decode(self, slots: np.ndarray) -> np.ndarray:
        """Map dense slots back to raw ids."""
        with self._lock:
            return self._rev[np.asarray(slots)]


class IdentityVertexTable:
    """Pass-through table for ids already dense in ``[0, capacity)``."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._max_seen = -1

    def __len__(self) -> int:
        return self._max_seen + 1

    @property
    def num_vertices(self) -> int:
        return self._max_seen + 1

    def encode(self, raw_ids: np.ndarray) -> np.ndarray:
        raw_ids = np.asarray(raw_ids).ravel()
        if raw_ids.size:
            hi = int(raw_ids.max())
            if hi >= self.capacity:
                raise ValueError(
                    f"vertex id {hi} out of range for capacity {self.capacity}"
                )
            self._max_seen = max(self._max_seen, hi)
        return raw_ids.astype(np.int32, copy=False)

    def lookup(self, raw_ids: np.ndarray) -> np.ndarray:
        return np.asarray(raw_ids).ravel().astype(np.int32, copy=False)

    def decode(self, slots: np.ndarray) -> np.ndarray:
        return np.asarray(slots).astype(np.int64)
