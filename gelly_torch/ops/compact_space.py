"""Persistent compact root space for the compact CC codec.

Counterpart of ``gelly_tpu/ops/compact_space.py`` (pure numpy and
threading; the port keeps its own copy and calls the port's native
bindings). The host ingest codec, which already hashes every touched
vertex to build each unit's forest, gives each vertex a persistent
window-scoped compact id (cid) in first-seen order, so the device folds
pairs that are already dense in ``[0, M)`` with no per-dispatch
O(capacity) work.

Thread safety: ``assign``/``lookup`` take an internal lock. Concurrent
stagers take their assignment turns in stream order through
:meth:`CompactIdSession.await_turn` / :meth:`~CompactIdSession.complete_turn`
(the engine numbers codec units per run), so a vertex first seen in unit
i ships its (cid, vertex) record in unit i's payload; the heavy combine
work stays parallel.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class CompactIdSession:
    """Window-scoped vertex-slot -> compact-id assignment (first-seen order).

    ``capacity`` is the compact space size M, the bound on distinct
    touched vertices. Exceeding it raises :class:`CompactSpaceOverflow`.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._turn_cv = threading.Condition()
        # Native open-addressing table when the toolchain is available;
        # numpy sorted-array fallback otherwise.
        self._native = None
        from ..utils import native as _nat

        if _nat.compact_session_available():
            self._native = _nat.NativeCompactSession(self.capacity)
        self.reset()

    def reset(self) -> None:
        with self._lock:
            if self._native is not None:
                self._native.reset()
            # Sorted global ids + their cids (aligned).
            self._known = np.empty(0, np.int32)
            self._cid_of = np.empty(0, np.int32)
            self._next = 0
        with self._turn_cv:
            self._turn = 0
            self._released = set()
            self.wait_s = 0.0
            self._turn_cv.notify_all()

    def await_turn(self, seq: int) -> None:
        """Block until every unit numbered < seq has completed its
        assignment turn. The blocked time accumulates into ``wait_s``
        (lock wait, not compress work: the engine moves it from the
        ``ingest_compress`` stage to ``codec_wait``)."""
        with self._turn_cv:
            if self._turn >= seq:
                return
            t0 = time.perf_counter()
            self._turn_cv.wait_for(lambda: self._turn >= seq)
            self.wait_s += time.perf_counter() - t0

    def complete_turn(self, seq: int) -> None:
        """Mark unit ``seq``'s assignment done (call in a finally: a failed
        unit must not park the workers behind it). Out-of-order releases
        are remembered, so a unit that fails before its turn is skipped
        once the units ahead of it finish."""
        with self._turn_cv:
            if seq < self._turn:
                return  # already passed (e.g. on_stage_error after finally)
            self._released.add(seq)
            while self._turn in self._released:
                self._released.discard(self._turn)
                self._turn += 1
            self._turn_cv.notify_all()

    @property
    def assigned(self) -> int:
        if self._native is not None:
            return self._native.assigned
        return self._next

    def assign(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
        """Map unique global slot ids -> cids, assigning fresh cids to
        first-seen ids. Returns ``(cids, new_ids, new_base)`` where
        ``new_ids`` (in assignment order) received cids
        ``new_base .. new_base+len(new_ids)``."""
        ids = np.ascontiguousarray(ids, np.int32)
        with self._lock:
            if self._native is not None:
                cids, new_ids, base = self._native.assign(ids)
                if base < 0:
                    raise CompactSpaceOverflow(
                        f"compact space overflow: more than "
                        f"{self.capacity} distinct vertices; raise "
                        "compact_capacity (it bounds distinct touched "
                        "vertices per window, not edges)"
                    )
                return cids, new_ids, base
            if ids.size and int(ids.min()) < 0:
                raise ValueError(
                    f"compact-id assign: negative vertex ids (min="
                    f"{int(ids.min())})"
                )
            pos = np.searchsorted(self._known, ids)
            found = pos < self._known.shape[0]
            found[found] = self._known[pos[found]] == ids[found]
            new_ids = np.sort(ids[~found])
            n_new = new_ids.shape[0]
            base = self._next
            if base + n_new > self.capacity:
                raise CompactSpaceOverflow(
                    f"compact space overflow: {base + n_new} distinct "
                    f"vertices exceed compact_capacity={self.capacity}; "
                    "raise compact_capacity (it bounds distinct touched "
                    "vertices per window, not edges)"
                )
            if n_new:
                new_cids = np.arange(base, base + n_new, dtype=np.int32)
                merged = np.empty(self._known.shape[0] + n_new, np.int32)
                merged_cid = np.empty_like(merged)
                ins = np.searchsorted(self._known, new_ids)
                # Stable sorted merge: old entries shift right by how many
                # new ids insert before them.
                old_pos = (
                    np.arange(self._known.shape[0])
                    + np.searchsorted(new_ids, self._known, side="right")
                )
                new_pos = ins + np.arange(n_new)
                merged[old_pos] = self._known
                merged_cid[old_pos] = self._cid_of
                merged[new_pos] = new_ids
                merged_cid[new_pos] = new_cids
                self._known = merged
                self._cid_of = merged_cid
                self._next = base + n_new
            pos = np.searchsorted(self._known, ids)
            return self._cid_of[pos], new_ids, base

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """cids of already-assigned ids (raises KeyError on unknown ids)."""
        ids = np.ascontiguousarray(ids, np.int32)
        with self._lock:
            if self._native is not None:
                cids, bad = self._native.lookup(ids)
                if bad:
                    raise KeyError(f"{bad} ids have no compact assignment")
                return cids
            if self._known.shape[0] == 0:
                if ids.size:
                    raise KeyError(
                        f"{ids.size} ids have no compact assignment "
                        "(empty session)"
                    )
                return np.empty(0, np.int32)
            pos = np.searchsorted(self._known, ids)
            bad = pos >= self._known.shape[0]
            ok_pos = np.where(bad, 0, pos)
            bad |= self._known[ok_pos] != ids
            if bad.any():
                raise KeyError(
                    f"{int(bad.sum())} ids have no compact assignment"
                )
            return self._cid_of[ok_pos]

    def rebuild_from_vertex_of(self, vertex_of: np.ndarray) -> None:
        """Restore the session from a checkpointed ``vertex_of``
        (``vertex_of[cid]`` = global slot, -1 unassigned)."""
        vertex_of = np.asarray(vertex_of)
        if vertex_of.shape[0] > self.capacity:
            raise ValueError(
                f"compact-id rebuild: checkpoint holds "
                f"{vertex_of.shape[0]} cids but compact_capacity is "
                f"{self.capacity}"
            )
        if self._native is not None:
            with self._lock:
                self._native.rebuild(vertex_of)
            return
        cids = np.nonzero(vertex_of >= 0)[0].astype(np.int32)
        ids = vertex_of[cids].astype(np.int32)
        order = np.argsort(ids)
        with self._lock:
            self._known = ids[order]
            self._cid_of = cids[order]
            # Holes stay dead; allocation resumes past the highest cid.
            self._next = int(cids.max()) + 1 if cids.size else 0


class CompactSpaceOverflow(RuntimeError):
    """Distinct touched vertices exceeded the session's compact capacity."""
