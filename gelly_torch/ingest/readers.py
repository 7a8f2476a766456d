"""Sharded byte-range source readers — no global produce loop.

The pipelined executor overlaps compress/H2D/fold, but every
chunk still comes off ONE produce iterator (``produced_units`` in
``engine/aggregation.py``) feeding the K compress workers — a serial
stage ahead of the parallel ones. :class:`ShardedEdgeSource` removes
it: the edge file is split into S **record-aligned byte ranges**, one
reader lane per codec worker, and each lane parses *and compresses*
its own range on its own thread. The only cross-lane coupling is the
deterministic round-robin hand-off of COMPLETED units to the consumer,
so a trace capture shows S independent ``compress/gelly-reader_<s>``
tracks instead of one produce span train.

Formats:

- **text** — whitespace-separated edge lists (the ``core/io.py``
  dialect: ``%``/``#`` comments skipped, malformed lines skipped). A
  record is one valid parsed edge; ranges align to line boundaries
  (a line belongs to the range containing its first byte — the
  classic split-text-input rule).
- **bin** — raw little-endian ``int64`` (src, dst) pairs, 16 bytes per
  record (:func:`write_binary_edges`). Ranges align to 16-byte record
  multiples and every seek is closed-form O(1).

**Resume** composes with the engine's last-retired-chunk checkpoint
rule: the merged chunk order is a pure function of the per-shard chunk
counts (round-robin over non-exhausted shards, :func:`rr_order`), so a
single global position maps deterministically onto per-shard positions
(:func:`consumed_after`) — and a resumed run CONTINUES the canonical
schedule mid-cycle rather than restarting it, so checkpoints written
by a resumed run stay resumable themselves. Readers record per-chunk
byte offsets on their first pass; ``iter_from(position)`` then seeks
each shard directly to its recorded offset (O(1)) instead of
re-parsing its range from the start. A fresh process resuming a text
file without recorded offsets runs one parallel range scan to rebuild
them (O(range/S) per lane, once); binary seeks are closed-form and
never scan.

**Identity ids only**: sharded readers parse ranges concurrently, so a
stateful :class:`~gelly_torch.core.vertices.VertexTable` (slot = global
first-seen order) cannot be warmed consistently — the source requires
ids already dense in ``[0, vertex_capacity)`` and validates the bound
per chunk, the same contract as ``IdentityVertexTable``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator

import numpy as np

from ..core.chunk import EdgeChunk, make_chunk
from ..core.vertices import IdentityVertexTable
from ..engine import faults as faults_mod
from ..obs import bus as obs_bus
from ..obs import tracing as obs_tracing

BIN_RECORD_BYTES = 16  # <i8 src + <i8 dst
_READ_BLOCK = 1 << 20

_DONE = object()


class _Error:
    """Out-of-band exception wrapper (same shape as utils.prefetch)."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def detect_format(path: str) -> str:
    """``"bin"`` for ``.bin``/``.edges64`` files, else ``"text"``."""
    return "bin" if path.endswith((".bin", ".edges64")) else "text"


def write_binary_edges(path: str, src, dst) -> int:
    """Write (src, dst) as the packed little-endian int64 pair format
    the ``bin`` readers consume; returns the record count."""
    src = np.asarray(src, dtype="<i8")
    dst = np.asarray(dst, dtype="<i8")
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    rec = np.empty((src.shape[0], 2), dtype="<i8")
    rec[:, 0] = src
    rec[:, 1] = dst
    with open(path, "wb") as f:
        f.write(rec.tobytes())
    return int(src.shape[0])


def byte_ranges(path: str, shards: int, fmt: str | None = None
                ) -> list[tuple[int, int]]:
    """Split ``path`` into ``shards`` contiguous byte ranges.

    ``bin`` ranges are exact record multiples (even record split); text
    ranges are nominal byte splits — the READERS align them to line
    boundaries (a line belongs to the range containing its first byte),
    so the union is exactly the file and no record is read twice.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    size = os.path.getsize(path)
    fmt = fmt or detect_format(path)
    if fmt == "bin":
        if size % BIN_RECORD_BYTES:
            raise ValueError(
                f"{path}: size {size} is not a multiple of the "
                f"{BIN_RECORD_BYTES}-byte binary record"
            )
        recs = size // BIN_RECORD_BYTES
        cuts = [
            (recs * s // shards) * BIN_RECORD_BYTES
            for s in range(shards + 1)
        ]
    else:
        cuts = [size * s // shards for s in range(shards + 1)]
    return [(cuts[s], cuts[s + 1]) for s in range(shards)]


def rr_order(counts: list[int]) -> Iterator[int]:
    """The merged chunk order: round-robin over shards in index order,
    skipping exhausted ones — a pure function of the per-shard counts,
    which is what makes a single global resume position meaningful."""
    remaining = list(counts)
    while True:
        progressed = False
        for s, r in enumerate(remaining):
            if r > 0:
                progressed = True
                remaining[s] -= 1
                yield s
        if not progressed:
            return


def consumed_after(counts: list[int], steps: int) -> list[int]:
    """Per-shard chunks consumed after ``steps`` entries of
    :func:`rr_order` — the global→per-shard resume position map."""
    total = sum(counts)
    if steps > total:
        raise ValueError(
            f"resume position {steps} exceeds the stream's {total} chunks"
        )
    out = [0] * len(counts)
    for s in rr_order(counts):
        if steps == 0:
            break
        out[s] += 1
        steps -= 1
    return out


def _unit_starts(counts: list[int], batch: int, start_chunks: int
                 ) -> tuple[list[int], int]:
    """Per-shard UNIT starts (and the number of units skipped) after
    ``start_chunks`` retired chunks, for per-shard grouping into units
    of ``batch`` chunks. The engine's checkpoint position only ever
    advances by whole units, so a valid resume position always lands on
    a unit boundary of this schedule; anything else fails loudly."""
    unit_counts = [-(-c // batch) for c in counts]
    remaining = list(counts)
    out = [0] * len(counts)
    left = start_chunks
    units = 0
    if left == 0:
        return out, 0
    for s in rr_order(unit_counts):
        k = min(batch, remaining[s])
        remaining[s] -= k
        out[s] += 1
        units += 1
        left -= k
        if left == 0:
            return out, units
        if left < 0:
            break
    raise ValueError(
        f"resume position {start_chunks} does not align with any unit "
        f"boundary of the sharded schedule (batch={batch}, per-shard "
        f"chunks={counts}) — was the checkpoint written by a run with a "
        "different shard count or batch?"
    )


def _parse_text_lines(lines, offsets, comment_prefixes, want_val):
    """Parse raw line bytes into (offsets, src, dst, val) of the VALID
    records (comments/blank/malformed skipped, core/io.py parity)."""
    offs: list[int] = []
    srcs: list[int] = []
    dsts: list[int] = []
    vals: list[float] = []
    for off, line in zip(offsets, lines):
        t = line.strip()
        if not t or t.startswith(comment_prefixes):
            continue
        fields = t.split()
        try:
            s, d = int(fields[0]), int(fields[1])
        except (ValueError, IndexError):
            continue
        offs.append(off)
        srcs.append(s)
        dsts.append(d)
        if want_val:
            try:
                vals.append(float(fields[2]))
            except (ValueError, IndexError):
                vals.append(1.0)
    return offs, srcs, dsts, vals


class ShardRoutingTable:
    """Reader-shard → host routing: which host ingests which byte range.

    Mirrors the checkpoint-state adoption rule of
    ``engine/coordination.py`` (orphan host ``j`` → survivor
    ``j % new_count``): on permanent host loss, :meth:`reroute` moves
    the lost hosts' reader shards to the SAME survivors that adopted
    their state shards, so re-partitioned ingest lands where the
    adopted forests already live. ``Coordinator.recover(reshard=...)``
    calls it from the degraded re-join rung.
    """

    def __init__(self, num_shards: int, num_hosts: int):
        if num_shards < 1 or num_hosts < 1:
            raise ValueError(
                f"need >= 1 shard and host, got {num_shards}/{num_hosts}"
            )
        self._lock = threading.Lock()
        self.num_shards = num_shards
        self.num_hosts = num_hosts
        # shard -> host, initially striped like the mesh partitioner.
        self._owner = {s: s % num_hosts for s in range(num_shards)}

    def owner(self, shard: int) -> int:
        with self._lock:
            return self._owner[shard]

    def shards_for(self, host: int) -> list[int]:
        with self._lock:
            return sorted(s for s, h in self._owner.items() if h == host)

    def snapshot(self) -> dict[int, int]:
        with self._lock:
            return dict(self._owner)

    def reroute(self, old_count: int, new_count: int) -> dict[int, int]:
        """Re-shard after permanent host loss: every shard owned by a
        host index >= ``new_count`` moves to ``old_host % new_count``
        (the state-adoption rule). Returns {shard: new_host} for the
        moved shards and publishes ``ingest.reshards``."""
        if new_count < 1 or new_count > old_count:
            raise ValueError(
                f"reroute expects 1 <= new_count <= old_count, got "
                f"{new_count}/{old_count}"
            )
        moved: dict[int, int] = {}
        with self._lock:
            for s, h in self._owner.items():
                if h >= new_count:
                    self._owner[s] = h % new_count
                    moved[s] = h % new_count
            self.num_hosts = new_count
        obs_bus.get_bus().emit(
            "ingest.reshards", moved=len(moved),
            previous_hosts=old_count, hosts=new_count,
        )
        return moved


class ShardedEdgeSource:
    """S record-aligned byte-range readers over one edge file.

    Usable three ways:

    - as a plain seekable chunk source (``iter(source)`` /
      ``iter_from(position)``) — chunks arrive in the deterministic
      round-robin merge order, parsed by S parallel lanes; this is the
      drop-in for ``ResilientRunner`` (``_make_seekable`` picks up
      ``iter_from``) and for ``EdgeStream`` wrapping;
    - as the engine's **source provider**
      (``run_aggregation(source_provider=source)``): each reader lane
      parses AND stage-compresses its own range via the engine's stage
      function — the global produce loop disappears entirely;
    - as the unit of ingest re-sharding: ``routing`` (a
      :class:`ShardRoutingTable`) names which host owns which shard.

    ``timestamps`` are per-shard record indices (sharded ranges have no
    global arrival order, so this source is merge_every-mode only — the
    engine refuses window_ms mode with a provider).
    """

    def __init__(self, path: str, shards: int = 2,
                 chunk_size: int = 4096, *,
                 vertex_capacity: int | None = None,
                 num_value_cols: int = 0,
                 comment_prefixes: tuple = ("%", "#"),
                 fmt: str | None = None,
                 lane_depth: int = 2,
                 table=None,
                 routing: ShardRoutingTable | None = None):
        if table is not None and not isinstance(table, IdentityVertexTable):
            raise ValueError(
                "ShardedEdgeSource reads ranges concurrently, so slots "
                "cannot follow global first-seen order — only identity "
                "densification is supported (ids dense in "
                "[0, vertex_capacity)); pass an IdentityVertexTable or "
                "none"
            )
        self.path = path
        self.shards = int(shards)
        self.chunk_size = int(chunk_size)
        self.fmt = fmt or detect_format(path)
        if self.fmt not in ("text", "bin"):
            raise ValueError(f"fmt must be 'text' or 'bin', got {self.fmt!r}")
        if self.fmt == "bin" and num_value_cols:
            raise ValueError("binary pair files carry no value column")
        self.num_value_cols = num_value_cols
        self.comment_prefixes = tuple(
            p.encode() if isinstance(p, str) else p for p in comment_prefixes
        )
        self.lane_depth = max(1, int(lane_depth))
        self.capacity = vertex_capacity
        self.table = table if table is not None else (
            IdentityVertexTable(vertex_capacity)
            if vertex_capacity is not None else None
        )
        self.ranges = byte_ranges(path, self.shards, self.fmt)
        self.routing = routing
        # First-pass bookkeeping, written by reader threads under the
        # lock: per-shard chunk counts (known once a lane exhausts its
        # range) and per-chunk byte offsets (recorded as chunks are
        # emitted) — the O(1) seek targets for iter_from.
        self._lock = threading.Lock()
        self._counts: dict[int, int] = {}
        self._offsets: dict[int, list[int]] = {s: [] for s in
                                               range(self.shards)}

    # ------------------------------------------------------------ layout

    @property
    def num_chunks(self) -> int:
        return sum(self.shard_counts())

    def shard_counts(self) -> list[int]:
        """Per-shard chunk counts; triggers the parallel range scan if
        no pass has recorded them yet (bin counts are closed-form)."""
        if self.fmt == "bin":
            return [
                -(-((hi - lo) // BIN_RECORD_BYTES) // self.chunk_size)
                if hi > lo else 0
                for lo, hi in self.ranges
            ]
        with self._lock:
            if len(self._counts) == self.shards:
                return [self._counts[s] for s in range(self.shards)]
        self._scan()
        with self._lock:
            return [self._counts[s] for s in range(self.shards)]

    def recorded_offsets(self, shard: int) -> list[int]:
        """Byte offsets of this shard's chunk starts recorded so far —
        the per-shard seekable resume positions."""
        with self._lock:
            return list(self._offsets[shard])

    def _record_chunk(self, shard: int, index: int, offset: int) -> None:
        with self._lock:
            offs = self._offsets[shard]
            if index == len(offs):
                offs.append(offset)

    def _record_count(self, shard: int, count: int) -> None:
        with self._lock:
            self._counts[shard] = count

    def _scan(self) -> None:
        """One parallel pass over every range, recording chunk offsets
        and counts without handing chunks anywhere — the rebuild path
        for a fresh process resuming a text file with no recorded
        offsets (bin seeks are closed-form and never need this)."""
        errs: list[BaseException] = []

        def drain(s):
            try:
                for _ in self._read_shard(s, 0):
                    pass
            except BaseException as e:  # surfaced on the caller below
                errs.append(e)

        threads = [
            threading.Thread(target=drain, args=(s,), daemon=True,
                             name=f"gelly-reader-scan_{s}")
            for s in range(self.shards)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]

    # ------------------------------------------------------------ readers

    def _read_shard(self, shard: int, start_chunk: int = 0
                    ) -> Iterator[EdgeChunk]:
        """This shard's chunk stream from local chunk ``start_chunk``.

        Seeks via recorded byte offsets when available (O(1)); a text
        shard without a recorded offset for ``start_chunk`` re-parses
        its OWN range only (O(range/S), never the whole file).
        """
        if self.fmt == "bin":
            return self._read_shard_bin(shard, start_chunk)
        return self._read_shard_text(shard, start_chunk)

    def _read_shard_bin(self, shard, start_chunk):
        lo, hi = self.ranges[shard]
        recs = (hi - lo) // BIN_RECORD_BYTES
        cs = self.chunk_size
        n_chunks = -(-recs // cs) if recs else 0
        with open(self.path, "rb") as f:
            for index in range(start_chunk, n_chunks):
                r0 = index * cs
                n = min(cs, recs - r0)
                offset = lo + r0 * BIN_RECORD_BYTES
                self._record_chunk(shard, index, offset)
                faults_mod.inject("ingest")
                f.seek(offset)
                buf = f.read(n * BIN_RECORD_BYTES)
                if len(buf) != n * BIN_RECORD_BYTES:
                    raise IOError(
                        f"{self.path}: short read at offset {offset} "
                        f"({len(buf)} of {n * BIN_RECORD_BYTES} bytes)"
                    )
                pairs = np.frombuffer(buf, dtype="<i8").reshape(-1, 2)
                yield self._chunk(shard, pairs[:, 0], pairs[:, 1], None, r0)
        self._record_count(shard, n_chunks)

    def _read_shard_text(self, shard, start_chunk):
        lo, hi = self.ranges[shard]
        cs = self.chunk_size
        start_offset, skip_records = lo, 0
        if start_chunk:
            with self._lock:
                offs = self._offsets[shard]
                known_count = self._counts.get(shard)
                if start_chunk < len(offs):
                    start_offset = offs[start_chunk]
                elif known_count is not None and start_chunk >= known_count:
                    return  # resuming at/after this shard's end
                else:
                    # No recorded offset: re-parse this range only,
                    # counting records up to the chunk boundary.
                    skip_records = start_chunk * cs
        want_val = bool(self.num_value_cols)
        index = start_chunk
        pend_off: list[int] = []
        pend_s: list[int] = []
        pend_d: list[int] = []
        pend_v: list[float] = []
        with open(self.path, "rb") as f:
            for offsets, lines in _line_spans(
                f, start_offset, hi,
                apply_split_rule=(start_offset == lo),
            ):
                faults_mod.inject("ingest")
                offs, srcs, dsts, vals = _parse_text_lines(
                    lines, offsets, self.comment_prefixes, want_val
                )
                if skip_records:
                    take = min(skip_records, len(srcs))
                    skip_records -= take
                    offs, srcs, dsts = offs[take:], srcs[take:], dsts[take:]
                    vals = vals[take:]
                    if skip_records:
                        continue
                pend_off.extend(offs)
                pend_s.extend(srcs)
                pend_d.extend(dsts)
                pend_v.extend(vals)
                while len(pend_s) >= cs:
                    yield self._emit_text(shard, index, pend_off, pend_s,
                                          pend_d, pend_v, cs, want_val)
                    del pend_off[:cs], pend_s[:cs], pend_d[:cs]
                    if want_val:
                        del pend_v[:cs]
                    index += 1
        if pend_s:
            yield self._emit_text(shard, index, pend_off, pend_s, pend_d,
                                  pend_v, len(pend_s), want_val)
            index += 1
        if not skip_records:
            self._record_count(shard, index)

    def _emit_text(self, shard, index, offs, srcs, dsts, vals, n, want_val):
        self._record_chunk(shard, index, offs[0])
        return self._chunk(
            shard,
            np.asarray(srcs[:n], dtype=np.int64),
            np.asarray(dsts[:n], dtype=np.int64),
            np.asarray(vals[:n], dtype=np.float64) if want_val else None,
            index * self.chunk_size,
        )

    def _chunk(self, shard, raw_src, raw_dst, val, rec0) -> EdgeChunk:
        n = raw_src.shape[0]
        if self.capacity is not None and n:
            hi = int(max(raw_src.max(), raw_dst.max()))
            if hi >= self.capacity:
                raise ValueError(
                    f"vertex id {hi} out of range for capacity "
                    f"{self.capacity} (sharded readers require identity "
                    "ids; re-encode the file or raise vertex_capacity)"
                )
        tracer = obs_tracing.active_tracer()
        if tracer is not None:
            tracer.instant("ingest.chunk_read",
                           track=f"read/gelly-reader_{shard}",
                           shard=shard, edges=n)
        return make_chunk(
            raw_src.astype(np.int32, copy=False),
            raw_dst.astype(np.int32, copy=False),
            raw_src=raw_src,
            raw_dst=raw_dst,
            val=val,
            ts=np.arange(rec0, rec0 + n, dtype=np.int64),
            capacity=self.chunk_size,
            device=None,
        )

    # ------------------------------------------------------- merged iter

    def __iter__(self) -> Iterator[EdgeChunk]:
        return self.iter_from(0)

    def iter_from(self, position: int) -> Iterator[EdgeChunk]:
        """Merged chunk stream from global chunk ``position`` — the
        seekable resume hook ``engine/resilience._make_seekable`` and
        ``EdgeStream.chunks_from`` pick up.

        ``position > 0`` derives per-shard starts from the canonical
        schedule and CONTINUES it mid-cycle (so the continuation is
        exactly the suffix an uninterrupted run would have produced);
        ``position == 0`` cycles live without needing counts up front.
        """
        if position < 0:
            raise ValueError(f"position must be >= 0, got {position}")
        if position == 0:
            return self._merged([0] * self.shards, schedule=None)
        counts = self.shard_counts()
        starts = consumed_after(counts, position)
        sched = rr_order(counts)
        for _ in range(position):
            next(sched)
        return self._merged(starts, schedule=sched)

    def _merged(self, starts: list[int], schedule) -> Iterator[EdgeChunk]:
        from ..utils.prefetch import prefetch

        lanes = [
            prefetch(self._read_shard(s, starts[s]), depth=self.lane_depth,
                     name=f"gelly-reader_{s}")
            for s in range(self.shards)
        ]
        try:
            if schedule is not None:
                # Canonical continuation: the remaining schedule names
                # exactly which shard owns each next global position.
                for s in schedule:
                    yield next(lanes[s])
                return
            active = list(range(self.shards))
            while active:
                for s in list(active):
                    try:
                        yield next(lanes[s])
                    except StopIteration:
                        active.remove(s)
        finally:
            for lane in lanes:
                lane.close()

    # ---------------------------------------------------- source provider

    def stage_units(self, stage_fn: Callable, batch: int = 1,
                    start: int = 0, depth: int = 2,
                    cancel: "threading.Event | None" = None,
                    gauge=None) -> Iterator:
        """The engine's source-provider hook: S reader threads, each
        parsing its byte range into chunks, grouping them into units of
        ``batch`` and running ``stage_fn((seq, group))`` — the engine's
        compress stage — ON THE READER THREAD, then handing completed
        units to the consumer in the deterministic round-robin order.

        ``seq`` is ``local_unit * shards + shard``: unique, monotone
        per lane, and stable across resume (span/slot attribution; the
        engine refuses ordered stackers with a provider, so nothing
        downstream requires global density). ``start`` is the engine's
        last-retired-chunk position; it must land on a unit boundary of
        the schedule (checkpoint positions always do). ``gauge``
        samples the total staged depth at each hand-off, feeding the
        ``pipeline.staged_depth`` gauge the ingest server's
        backpressure watches.
        """
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if start == 0:
            starts, skipped_units = [0] * self.shards, 0
            schedule = None
        else:
            counts = self.shard_counts()
            starts, skipped_units = _unit_starts(counts, batch, start)
            unit_counts = [-(-c // batch) for c in counts]
            schedule = rr_order(unit_counts)
            for _ in range(skipped_units):
                next(schedule)
        if cancel is None:
            cancel = threading.Event()
        qs: list[queue.Queue] = [
            queue.Queue(maxsize=max(1, -(-depth // self.shards)))
            for _ in range(self.shards)
        ]

        def put(q, item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def reader(shard: int, start_unit: int):
            q = qs[shard]
            try:
                seq = start_unit
                group: list = []
                for chunk in self._read_shard(shard, start_unit * batch):
                    group.append(chunk)
                    if len(group) == batch:
                        if not put(q, stage_fn((seq * self.shards + shard,
                                                group))):
                            return
                        seq += 1
                        group = []
                    if cancel.is_set():
                        return
                if group:
                    put(q, stage_fn((seq * self.shards + shard, group)))
            except BaseException as e:  # re-raised at the consumer
                put(q, _Error(e))
            finally:
                # Unconditional, cancel-tolerant DONE (prefetch's rule):
                # the merger needs it to retire the lane.
                while True:
                    try:
                        q.put(_DONE, timeout=0.1)
                        break
                    except queue.Full:
                        if cancel.is_set():
                            break

        threads = [
            threading.Thread(target=reader, args=(s, starts[s]),
                             daemon=True, name=f"gelly-reader_{s}")
            for s in range(self.shards)
        ]
        for t in threads:
            t.start()

        def pull(s):
            """One item off lane ``s`` (None on cancel)."""
            while True:
                if cancel.is_set():
                    return None
                try:
                    return qs[s].get(timeout=0.1)
                except queue.Empty:
                    continue

        def merged():
            try:
                if schedule is not None:
                    for s in schedule:
                        got = pull(s)
                        if got is None:
                            return
                        if got is _DONE:
                            raise RuntimeError(
                                f"reader lane {s} ended early against the "
                                "resume schedule — did the file change "
                                "between runs?"
                            )
                        if isinstance(got, _Error):
                            raise got.exc
                        if gauge is not None:
                            gauge(sum(q.qsize() for q in qs))
                        yield got
                    # Drain the DONE markers so lanes retire cleanly.
                    for s in range(self.shards):
                        got = pull(s)
                        if got is not None and isinstance(got, _Error):
                            raise got.exc
                    return
                active = list(range(self.shards))
                while active:
                    for s in list(active):
                        got = pull(s)
                        if got is None:
                            return
                        if got is _DONE:
                            active.remove(s)
                            continue
                        if isinstance(got, _Error):
                            raise got.exc
                        if gauge is not None:
                            gauge(sum(q.qsize() for q in qs))
                        yield got
            finally:
                cancel.set()
                for q in qs:
                    try:
                        while True:
                            q.get_nowait()
                    except queue.Empty:
                        pass
                for t in threads:
                    t.join(timeout=0.2)

        return merged()


def edge_stream_from_sharded_file(path: str, vertex_capacity: int,
                                  shards: int = 2, chunk_size: int = 4096,
                                  device=None, **kw):
    """An :class:`~gelly_torch.core.stream.EdgeStream` over a
    :class:`ShardedEdgeSource` — ``stream.aggregate(...,
    source_provider=True)`` then runs the whole ingest leg sharded.
    ``device`` is the stream's (default ``core.device.DEFAULT_DEVICE``,
    the card); the readers build host chunks either way."""
    from ..core.device import DEFAULT_DEVICE
    from ..core.stream import edge_stream_from_source

    src = ShardedEdgeSource(
        path, shards=shards, chunk_size=chunk_size,
        vertex_capacity=vertex_capacity, **kw,
    )
    return edge_stream_from_source(
        src, vertex_capacity,
        device=DEFAULT_DEVICE if device is None else device)


def _line_spans(f, start: int, hi: int, apply_split_rule: bool,
                block: int = _READ_BLOCK):
    """Yield ``(offsets, lines)`` batches of complete lines whose start
    offset is in ``[start', hi)``. With ``apply_split_rule`` (``start``
    is the nominal range start, not a recorded record offset), the line
    STRADDLING ``start`` belongs to the previous range and is skipped —
    unless the byte before ``start`` is a newline, in which case the
    line starting exactly at ``start`` is ours."""
    pos = start
    buf = b""
    line_start = start
    if start > 0 and apply_split_rule:
        f.seek(start - 1)
        if f.read(1) != b"\n":
            while True:
                blk = f.read(block)
                if not blk:
                    return
                nl = blk.find(b"\n")
                if nl >= 0:
                    buf = blk[nl + 1:]
                    line_start = pos + nl + 1
                    pos += len(blk)
                    break
                pos += len(blk)
        # else: the previous byte ends a line; begin exactly at start.
    else:
        f.seek(start)
    eof = False
    while True:
        parts = buf.split(b"\n")
        if len(parts) > 1:
            offsets: list[int] = []
            lines: list[bytes] = []
            off = line_start
            for p in parts[:-1]:
                if off >= hi:
                    if offsets:
                        yield offsets, lines
                    return
                offsets.append(off)
                lines.append(p)
                off += len(p) + 1
            line_start = off
            buf = parts[-1]
            if offsets:
                yield offsets, lines
        if eof:
            if buf and line_start < hi:
                yield [line_start], [buf]
            return
        if line_start >= hi:
            return
        blk = f.read(block)
        if not blk:
            eof = True
        else:
            buf += blk
            pos += len(blk)
