"""End-to-end latency watermarks: per-stream ingress-time ledgers.

Every chunk (or wire frame / tenant payload) gets an INGRESS stamp at
the earliest boundary that sees it — wire frame receive, reader parse,
or tenant submit — keyed by its exactly-once position. The stamp then
rides the position through the pipeline:

- ``retire_fold(stream, upto)`` — every position below ``upto`` was
  dispatched to a fold: the ingress→fold latency lands on the
  ``<prefix>.e2e_ingress_to_fold_ms`` histogram and the stamp stays in
  the ledger (the chunk is folded but not yet durable);
- ``retire_durable(stream, upto)`` — a checkpoint covering ``upto`` is
  on disk (or, for runs without a durability point, the window closed):
  ingress→durable lands on ``<prefix>.e2e_ingress_to_durable_ms`` and
  the stamps drop out of the ledger.

The LOW WATERMARK of a stream is the oldest stamp still in its ledger:
``backlog_age(stream)`` — how long the oldest unretired chunk has been
waiting — is exactly the per-tenant staleness signal QoS admission
gates on (an instantaneous queue-depth gauge cannot distinguish "deep
but draining" from "shallow but stuck"; the watermark can).

Positions, not wall clocks, are the authority across crashes: stamps
live on the process-local monotonic clock and die with the process, so
a resumed incarnation re-seeds its ledger from the RESUMED POSITION
(``seed``) and re-stamps chunks as they are re-read — backlog age can
therefore never be negative or time-travel across a SIGKILL (ages are
additionally clamped at 0 against clock quirks).

One :class:`Watermarks` instance hangs off every
:class:`~gelly_torch.obs.bus.EventBus` (``bus.watermarks``), so
``obs.scope()`` isolates ledgers exactly like counters. All methods
are thread-safe; the zero-cost-when-disabled contract lives at the
call sites (engine/ingest bind the ledger only when a tracer is
installed or ``obs.bus.recording()`` is on).
"""

from __future__ import annotations

import threading
import time
from collections import deque


def _take_range(stamps: dict, start: int, stop: int,
                pop: bool) -> list:
    """Stamp times for positions in ``[start, stop)`` (popped from the
    ledger when ``pop``). Walks the dense range via O(1) lookups when
    that is the cheaper side; falls back to one dict scan when the
    range dwarfs the ledger (sparse positions), keeping every call
    O(min(range, pending))."""
    if stop <= start:
        return []
    if stop - start <= 2 * len(stamps) + 16:
        out = []
        for p in range(start, stop):
            t = stamps.pop(p, None) if pop else stamps.get(p)
            if t is not None:
                out.append(t)
        return out
    keys = [p for p in stamps if start <= p < stop]
    if pop:
        return [stamps.pop(p) for p in keys]
    return [stamps[p] for p in keys]


class _Stream:
    __slots__ = ("stamps", "base", "folded", "minq", "dirty")

    def __init__(self, base: int = 0):
        self.stamps: dict[int, float] = {}  # position -> monotonic ingress
        self.base = base  # positions below are retired/pre-resume
        self.folded = base  # positions below had ingress->fold observed
        # Monotonic min-deque over (position, ingress) pairs: positions
        # strictly increase front->back, ingress times strictly increase
        # front->back (back entries with ingress >= a new stamp's are
        # dominated — they retire no later and are never the minimum —
        # so the push pops them). The front is therefore the oldest
        # pending ingress, making backlog_age O(1) amortized instead of
        # an O(pending) ledger scan under the shared lock. Out-of-order
        # stamps (position <= the back's) would break the position
        # invariant, so they flip ``dirty`` and the deque is rebuilt
        # lazily from the ledger on the next read — the hot in-order
        # path never pays for the rare reordered arrival.
        self.minq: deque = deque()
        self.dirty = False


def _minq_push(st: _Stream, position: int, t: float) -> None:
    """Maintain the min-deque for an in-order stamp (lock held)."""
    if st.dirty:
        return
    if st.minq and position <= st.minq[-1][0]:
        st.dirty = True
        st.minq.clear()
        return
    while st.minq and st.minq[-1][1] >= t:
        st.minq.pop()
    st.minq.append((position, t))


def _minq_oldest(st: _Stream) -> float | None:
    """Oldest pending ingress time, or None when the ledger is empty
    (lock held). Rebuilds the deque after out-of-order stamps; pops
    retired fronts; cross-checks the front against the ledger so a
    stale entry can never be reported as the watermark."""
    if not st.stamps:
        st.minq.clear()
        st.dirty = False
        return None
    if st.dirty:
        st.minq.clear()
        for pos in sorted(st.stamps):
            _t = st.stamps[pos]
            while st.minq and st.minq[-1][1] >= _t:
                st.minq.pop()
            st.minq.append((pos, _t))
        st.dirty = False
    while st.minq:
        pos, t = st.minq[0]
        if pos < st.base or st.stamps.get(pos) != t:
            st.minq.popleft()
            continue
        return t
    # Every deque entry was dominated by a since-retired stamp: fall
    # back to one scan and rebuild via the dirty path next read.
    st.dirty = True
    return min(st.stamps.values())


class Watermarks:
    """Per-stream position→ingress-time ledgers (see module doc)."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._streams: dict = {}

    # ------------------------------------------------------------ stamping

    def seed(self, stream, position: int) -> None:
        """(Re)seed a stream's ledger at ``position`` — the exactly-once
        resume point. Stamps below it are dropped (those chunks are
        durably folded in the resumed-from checkpoint); stamps at or
        above it are kept (e.g. wire frames staged before the consumer
        seeded). THE re-seed rule: after a crash the watermark restarts
        from the resumed position's re-read time, never the wall
        clock."""
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                self._streams[stream] = _Stream(int(position))
                return
            st.base = max(st.base, int(position))
            st.folded = max(st.folded, st.base)
            for pos in [p for p in st.stamps if p < st.base]:
                del st.stamps[pos]
            while st.minq and st.minq[0][0] < st.base:
                st.minq.popleft()

    def stamp(self, stream, position: int, t: float | None = None) -> None:
        """Record the ingress time of ``position`` (first stamp wins —
        a wire receive stamp is never overwritten by the reader-parse
        stamp of the same chunk downstream)."""
        position = int(position)
        now = self._clock() if t is None else t
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                st = self._streams[stream] = _Stream()
            if position < st.base or position in st.stamps:
                return
            st.stamps[position] = now
            _minq_push(st, position, now)

    # ------------------------------------------------------------ retiring

    def retire_fold(self, stream, upto: int, bus=None,
                    prefix: str | None = None) -> None:
        """Positions below ``upto`` were dispatched to a fold: observe
        ingress→fold latency, once per position (stamps stay in the
        ledger until durable)."""
        upto = int(upto)
        now = self._clock()
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                return
            # Positions are dense at every call site (chunk indices /
            # wire seqs / tenant submit counters), so walk only the
            # NEWLY folded [folded, upto) range — a full-ledger scan
            # here is O(pending) per fold and quadratic between
            # durable points. The dict-scan fallback covers a sparse
            # ledger where the range walk would be the slower side.
            lats = [now - t for t in _take_range(
                st.stamps, st.folded, upto, pop=False)]
            st.folded = max(st.folded, upto)
        if bus is not None and prefix is not None:
            for dt in lats:
                bus.observe(f"{prefix}.e2e_ingress_to_fold_ms",
                            max(0.0, dt) * 1e3)

    def retire_durable(self, stream, upto: int, bus=None,
                       prefix: str | None = None) -> None:
        """Positions below ``upto`` are durable (checkpoint on disk /
        window closed on a run without a durability point): observe
        ingress→durable latency and drop the stamps — the low
        watermark advances."""
        upto = int(upto)
        now = self._clock()
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                return
            # [base, upto) covers every retirable position: stamp()
            # drops sub-base arrivals, so nothing lives below base.
            done = _take_range(st.stamps, st.base, upto, pop=True)
            st.base = max(st.base, upto)
            while st.minq and st.minq[0][0] < st.base:
                st.minq.popleft()
        if bus is not None and prefix is not None:
            for t in done:
                bus.observe(f"{prefix}.e2e_ingress_to_durable_ms",
                            max(0.0, now - t) * 1e3)

    def drop(self, stream) -> None:
        """Forget a stream entirely (tenant evicted / run torn down)."""
        with self._lock:
            self._streams.pop(stream, None)

    def rekey(self, old, new) -> None:
        """Move ``old``'s ledger under the ``new`` key (merging
        first-stamp-wins into any existing ledger there, bases/folded
        maxed). The TenantRouter uses this at attach time: frames a
        server ingress-stamped under its default key before the router
        re-keyed it would otherwise never retire — they must follow the
        key so the drain loop's retirement covers them. No-op when
        ``old`` has no ledger."""
        with self._lock:
            src = self._streams.pop(old, None)
            if src is None:
                return
            dst = self._streams.get(new)
            if dst is None:
                self._streams[new] = src
                return
            dst.base = max(dst.base, src.base)
            dst.folded = max(dst.folded, src.folded)
            for pos, t in src.stamps.items():
                if pos >= dst.base and pos not in dst.stamps:
                    dst.stamps[pos] = t
            # Merged stamps land in arbitrary position order relative
            # to dst's deque — rebuild lazily at the next read.
            dst.dirty = True
            dst.minq.clear()

    # ------------------------------------------------------------- reading

    def backlog_age(self, stream) -> float:
        """Seconds since the oldest unretired ingress stamp (the low
        watermark's age); 0.0 for an empty/unknown stream. Never
        negative. O(1) amortized via the per-stream min-deque (stamps
        arrive in position order on every hot path, so reads pop at
        most what retirement already paid for)."""
        now = self._clock()
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                return 0.0
            oldest = _minq_oldest(st)
        if oldest is None:
            return 0.0
        return max(0.0, now - oldest)

    def oldest_position(self, stream) -> int | None:
        """Position of the oldest unretired stamp (None when empty) —
        the low watermark itself."""
        with self._lock:
            st = self._streams.get(stream)
            if st is None or not st.stamps:
                return None
            return min(st.stamps)

    def max_backlog_age(self) -> float:
        """The worst backlog age across every stream — the heartbeat /
        admission-control headline."""
        now = self._clock()
        with self._lock:
            oldest = [t for t in (_minq_oldest(st)
                                  for st in self._streams.values())
                      if t is not None]
        if not oldest:
            return 0.0
        return max(0.0, now - min(oldest))

    def snapshot(self) -> dict:
        """JSON-ready per-stream view: ``{stream: {backlog_age_s,
        oldest_position, pending, base}}`` (stream keys stringified)."""
        now = self._clock()
        with self._lock:
            out = {}
            for key, st in self._streams.items():
                pending = len(st.stamps)
                oldest = min(st.stamps) if st.stamps else None
                t0 = _minq_oldest(st)
                age = max(0.0, now - t0) if t0 is not None else 0.0
                out[str(key)] = {
                    "backlog_age_s": round(age, 6),
                    "oldest_position": oldest,
                    "pending": pending,
                    "base": st.base,
                }
            return out
