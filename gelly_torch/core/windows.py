"""Shared tumbling-window event iterator, and the pane ring.

Counterpart of ``gelly_tpu/core/windows.py``: one implementation of the
reference's tumbling time-window semantics (``timeWindow(timeMillis)`` /
``slice``), consumed by the aggregation engine's ``window_ms`` path and the
SnapshotStream buffer.

Yields events in stream order:

- ``("edges", window, masked_chunk, n_valid)`` — a chunk masked down to the
  edges of ``window`` (n_valid = host count of live edges in the mask);
- ``("close", window, None, 0)`` — emitted when a later window's first edge
  arrives (windows with no data never fire, Flink semantics) and once at
  end-of-stream for the final partial window.

Late edges (timestamp before the currently open window) are dropped and
counted in ``stats["late_edges"]``. ``allowed_lateness`` (ms) enables a
bounded reorder buffer: window ``w`` closes only once the watermark
``max_ts_seen - allowed_lateness`` passes its end, so edges shuffled within
the bound land in their window; a window's edges are then emitted in
arrival order just before its close. The window logic runs on the host;
each chunk's mask is a ``torch.bool`` tensor on the chunk's device.

:class:`PaneRing` is the two-stack suffix aggregation of the engine's
sliding pane windows (``windowed=W``).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from .chunk import EdgeChunk
from .device import to_numpy


def _masked(c: EdgeChunk, mask: np.ndarray) -> EdgeChunk:
    return c.mask(torch.from_numpy(mask).to(c.valid.device))


def tumbling_window_events(
    chunks: Iterable[EdgeChunk], window_ms: int, stats: dict | None = None,
    initial_window: int | None = None, allowed_lateness: int = 0,
    state_handle: dict | None = None,
    initial_state: dict | None = None,
) -> Iterator[tuple]:
    """Window events of ``chunks`` (see the module docstring).

    ``initial_window`` seeds the open window (checkpoint resume: edges of
    earlier, already-emitted windows count as late instead of re-opening).
    With lateness, ``state_handle`` (a caller's dict) gains an ``"export"``
    callable returning the live reorder-buffer state — ``{"wins",
    "chunks" (one compact host EdgeChunk per open window), "closed_upto",
    "max_ts"}`` — and ``initial_state`` (a prior export) seeds the buffer
    on resume so buffered edges survive a restart.
    """
    if allowed_lateness:
        yield from _tumbling_with_lateness(
            chunks, window_ms, stats if stats is not None else {},
            initial_window, allowed_lateness, state_handle, initial_state,
        )
        return
    if stats is None:
        stats = {}
    stats.setdefault("late_edges", 0)
    current = initial_window
    dirty = False
    for c in chunks:
        ts = to_numpy(c.ts)
        ok = to_numpy(c.valid)
        if not ok.any():
            continue
        tw = ts // window_ms
        if current is not None:
            n_late = int((ok & (tw < current)).sum())
            if n_late:
                stats["late_edges"] += n_late
                ok = ok & (tw >= current)
        for w in np.unique(tw[ok]).tolist():
            if current is None:
                current = w
            if w > current:
                if dirty:
                    yield ("close", current, None, 0)
                    dirty = False
                current = w
            mask = ok & (tw == w)
            yield ("edges", w, _masked(c, mask), int(mask.sum()))
            dirty = True
    if dirty:
        yield ("close", current, None, 0)


def _tumbling_with_lateness(
    chunks: Iterable[EdgeChunk], window_ms: int, stats: dict,
    initial_window: int | None, lateness: int,
    state_handle: dict | None = None,
    initial_state: dict | None = None,
) -> Iterator[tuple]:
    """Watermark-gated reorder buffer (see the module docstring).

    ``pending`` holds (chunk, index-array) pairs per open window (chunks
    are never written after a source yields them, so buffering references
    is safe). Windows flush in ascending order once the watermark passes
    their end; each window's edge events come (arrival order) right before
    its close. At most ``ceil((allowed_lateness + chunk_ts_span) /
    window_ms) + 1`` windows are open at once; the live footprint is
    ``stats["buffered_edges"]`` / ``stats["open_windows"]``.
    """
    stats.setdefault("late_edges", 0)
    stats["buffered_edges"] = 0
    stats["open_windows"] = 0
    pending: dict[int, list] = {}
    # Windows below this are closed: their edges are late (drop + count).
    closed_upto = initial_window
    max_ts = None
    if initial_state is not None:
        # Resume: one compact chunk per open window, every row live.
        closed_upto = initial_state.get("closed_upto", closed_upto)
        max_ts = initial_state.get("max_ts", max_ts)
        for w, ch in zip(initial_state["wins"], initial_state["chunks"]):
            ch = EdgeChunk(*(torch.as_tensor(np.asarray(f)) for f in ch))
            pending[int(w)] = [(ch, np.arange(ch.capacity, dtype=np.int32))]
            stats["buffered_edges"] += ch.capacity
        stats["open_windows"] = len(pending)

    def export_state():
        wins = sorted(pending)
        out_chunks = [
            EdgeChunk(*(
                np.concatenate([to_numpy(getattr(ch, name))[idx]
                                for ch, idx in pending[w]])
                for name in EdgeChunk._fields
            ))
            for w in wins
        ]
        return {"wins": wins, "chunks": out_chunks,
                "closed_upto": closed_upto, "max_ts": max_ts}

    if state_handle is not None:
        state_handle["export"] = export_state

    def flush(upto):
        for w in sorted(w for w in pending if upto is None or w < upto):
            for ch, idx in pending.pop(w):
                m = np.zeros(ch.capacity, bool)
                m[idx] = True
                stats["buffered_edges"] -= idx.shape[0]
                yield ("edges", w, _masked(ch, m), idx.shape[0])
            stats["open_windows"] = len(pending)
            yield ("close", w, None, 0)

    for c in chunks:
        ts = to_numpy(c.ts)
        ok = to_numpy(c.valid)
        if not ok.any():
            continue
        tw = ts // window_ms
        # Lateness is judged against the watermark as it stood BEFORE this
        # chunk: an edge is late only if its window already closed.
        if closed_upto is not None:
            n_late = int((ok & (tw < closed_upto)).sum())
            if n_late:
                stats["late_edges"] += n_late
                ok = ok & (tw >= closed_upto)
            if not ok.any():
                continue
        for w in np.unique(tw[ok]).tolist():
            idx = np.nonzero(ok & (tw == w))[0].astype(np.int32)
            pending.setdefault(w, []).append((c, idx))
            stats["buffered_edges"] += idx.shape[0]
        stats["open_windows"] = len(pending)
        # Advance the watermark: any future edge has ts >= max_ts -
        # lateness, hence lands in window >= upto; everything below closes.
        hi = int(ts[ok].max())
        max_ts = hi if max_ts is None else max(max_ts, hi)
        upto = (max_ts - lateness) // window_ms
        if closed_upto is None or upto > closed_upto:
            closed_upto = upto
        if pending:
            yield from flush(closed_upto)
    yield from flush(None)


class PaneRing:
    """Two-stack suffix aggregation over the last ``window_panes`` pane
    summaries (the FOO/DABA shape): a sliding window of W panes answered
    in O(1) amortized ``combine`` calls per pane close.

    - ``_back`` — raw panes in arrival order, with ``_back_agg`` the
      running combine of all of them (one combine per push);
    - ``_front`` — ``(raw_pane, suffix_agg)`` pairs, each ``suffix_agg``
      the combine of that pane and every younger front pane, so evicting
      the oldest pane is a stack pop;
    - when the front empties, the back flips into it (one combine per
      moved pane, each moved at most once); ``combines`` counts every
      call.

    ``combine`` must be associative with ``init``-shaped identities. It
    must not write either argument: every argument is a raw pane or a
    stored aggregate the ring reads again (the engine hands the ring a
    combine on copies, since a plan may combine in place). Raw
    panes are kept on both stacks: they are the checkpoint payload
    (:meth:`export_panes`) and the rebuild source after a TTL renumbering
    (:meth:`reload`).
    """

    def __init__(self, window_panes: int, combine, on_combine=None):
        if window_panes < 1:
            raise ValueError(
                f"window_panes must be >= 1, got {window_panes}")
        self.window_panes = int(window_panes)
        self._combine = combine
        self._on_combine = on_combine  # optional hook: called per combine
        self._front: list = []   # (raw pane, suffix agg), oldest last
        self._back: list = []    # raw panes, oldest first
        self._back_agg = None
        self.panes_closed = 0    # total panes ever pushed
        self.combines = 0        # total combine calls ever issued

    def _comb(self, a, b):
        self.combines += 1
        if self._on_combine is not None:
            self._on_combine(1)
        return self._combine(a, b)

    def _flip(self):
        # Youngest -> oldest, so each entry's agg covers itself and every
        # younger pane.
        agg = None
        for pane in reversed(self._back):
            agg = pane if agg is None else self._comb(pane, agg)
            self._front.append((pane, agg))
        self._back = []
        self._back_agg = None

    @property
    def live(self) -> int:
        """Panes currently inside the window (<= window_panes)."""
        return len(self._front) + len(self._back)

    def push(self, pane) -> None:
        """Close a pane into the ring; evicts the oldest pane once the
        ring holds ``window_panes``."""
        if self.live >= self.window_panes:
            if not self._front:
                self._flip()
            self._front.pop()
        self._back.append(pane)
        self._back_agg = (
            pane if self._back_agg is None
            else self._comb(self._back_agg, pane)
        )
        self.panes_closed += 1

    def query(self):
        """Combine of every live pane (None when empty): at most one
        combine on top of the stack aggregates. The result may BE a stored
        pane or aggregate; a caller that keeps it copies it."""
        front_agg = self._front[-1][1] if self._front else None
        if front_agg is None:
            return self._back_agg
        if self._back_agg is None:
            return front_agg
        return self._comb(front_agg, self._back_agg)

    def export_panes(self) -> list:
        """Raw live panes, oldest -> newest (the checkpoint payload; the
        stack aggregates are derived and rebuilt by :meth:`reload`)."""
        return [p for p, _ in reversed(self._front)] + list(self._back)

    def reload(self, panes: list, panes_closed: int) -> None:
        """Rebuild from raw panes (oldest -> newest): checkpoint resume or
        a TTL renumbering. All panes go on the back; every summary combine
        here is an associative integer merge, so the regrouping does not
        change an emission."""
        if len(panes) > self.window_panes:
            raise ValueError(
                f"{len(panes)} panes exceed the {self.window_panes}-pane "
                "window")
        self._front = []
        self._back = list(panes)
        self._back_agg = None
        for pane in self._back:
            self._back_agg = (
                pane if self._back_agg is None
                else self._comb(self._back_agg, pane)
            )
        self.panes_closed = int(panes_closed)
