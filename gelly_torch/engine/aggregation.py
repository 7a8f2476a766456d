"""The summary-aggregation engine of the port, single-device slice.

Counterpart of ``gelly_tpu/engine/aggregation.py``. An algorithm supplies
the reference's plugin contract (``init``, ``fold``, ``combine``,
``transform``, ``transient``, optionally an ingest codec) and the engine
runs it. This slice runs the plans ``gelly_tpu`` picks on a one-device
mesh, on ``merge_every`` windows:

- **the accumulate plan** (``fold_accumulates`` and not ``transient``):
  one running summary, folded across windows, emitted at each close;
- **the per-window Merger plan** (any other plan): fresh locals each
  window, and at each close ``global = combine(locals, global)``
  (``M/SummaryAggregation.java:107-119``); a ``transient`` plan emits the
  merged summary and resets ``global`` to ``init()``.

Either runs on raw chunks (optionally reduced on the host by a
``host_precombine``) or codec payloads, through the pipelined executor::

    produce -> [K codec workers: host compress + stack] -> [H2D thread]
            -> [consumer: folds, one sync per window at merge_emit]

Units of ``fold_batch`` chunks are numbered in stream order (ordered
stackers take their stateful step in that order); the H2D thread copies
each unit through a ring of reusable pinned buffers on a side stream,
waiting on a slot's last copy event before it reuses the slot, and the
consumer orders its fold after the copy on the device (``wait_event``),
so it never blocks on an upload. Raw-chunk plans run the same stages
inline by default. Where ``gelly_tpu`` donates the fold state to XLA, the
port rebinds it: the fold returns new tensors. An emission is a transform
output or a clone, never a view of live state.

Two more cadences: event-time tumbling windows (``window_ms``, with an
``allowed_lateness`` reorder buffer) and sliding pane rings
(``windowed=W``, with per-vertex TTL decay ``ttl_panes`` on compact-id
plans), whose stream is a :class:`WindowedStream`.

Checkpoints (``checkpoint_path``) and exactly-once resume (``resume``)
follow ``gelly_tpu``'s file format and rules, so a run either package
checkpointed resumes in the other. Fused multi-query plans
(``queries=``, ``engine/multiquery.py``) run as one accumulate plan. On a
mesh of S > 1 shards (``mesh=``, ``parallel/mesh.py``) each shard folds
its slice of every chunk (or its share of every codec batch) into its
own locals, and each
window close merges the shards (butterfly, ``merge_degree`` tree or
``merge_stacked`` gather) or, with a plan's ``merge_delta``, gathers only
the rows the window touched. Pre-compressed streams and source providers
come with later slices; asking for either raises ``NotImplementedError``
naming its ROADMAP.md item.
:func:`edges_fold_adapter` runs a per-edge user fold (the reference's
``EdgesFold``).

**Observability**: install an ``obs.SpanTracer`` (``with
gelly_torch.obs.install(SpanTracer()): ...``) around a run and every unit
records ``produce``/``compress``/``h2d``/``fold`` spans, every window
close a ``window_close`` (or ``pane_close``) instant and a
``merge_emit`` span, every checkpoint a ``checkpoint`` span, and a
heartbeat line reports eps, queue depths and the last-retired position;
export with ``obs.write_chrome_trace``. With a tracer or
``obs.bus.recording()`` on, the fold and merge latencies go to bus
histograms and the chunk positions through the ``bus.watermarks``
ledger. Without either, the unit path does no span or histogram work,
not even a clock read. The ``engine.*``, ``windows.*`` and
``pipeline.*`` counters and gauges are published to ``obs.get_bus()``
either way, beside ``stream.stats`` and ``stream.timer``.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import itertools
import os
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..core.chunk import EdgeChunk, split_chunk_host
from ..core.device import to_numpy
from ..obs import bus as obs_bus
from ..obs import tracing as obs_tracing
from . import faults
from .checkpoint import (
    load_checkpoint,
    save_checkpoint,
    tree_flatten,
    tree_map,
    tree_unflatten,
)

Summary = Any


@dataclasses.dataclass(eq=False)
class SummaryAggregation:
    """The plugin contract (M/SummaryAggregation.java:31-55).

    - ``init(device)`` → fresh summary (NamedTuple of tensors on ``device``).
    - ``fold(summary, chunk)`` → summary: chunk-vectorized edge fold.
    - ``combine(a, b)`` → summary: associative + commutative merge.
    - ``transform(summary)`` → emission (optional).
    - ``transient`` — when True the global summary resets every window.
    - ``jit_transform`` — ``gelly_tpu``'s flag of a device transform; a
      plan that sets it False (a host-side transform) cannot be fused
      (``engine/multiquery.py``).
    - ``merge_stacked`` — optional ``stacked -> summary`` merge of K
      summaries at once (leading axis K).
    - ``flatten`` — optional label-preserving compaction of the summary,
      run at checkpoint cadence; its result replaces the live summary.
    - ``fold_accumulates`` — declares ``fold(combine(a, b), c) ==
      combine(a, fold(b, c))``: the engine may carry ONE running summary
      across windows (the accumulate plan).
    - ``fold_backend`` — the kernel backend the plan's folds were built for.

    The cross-shard merge on a mesh of S > 1 shards:

    - ``merge_degree`` — the ``SummaryTreeReduce`` degree: a hierarchical
      tree with ``degree`` group summaries (None: butterfly, or gather
      when ``merge_stacked`` is set);
    - ``merge_mode`` — ``"replicated"`` (merge whole shard summaries),
      ``"delta"`` or ``"auto"`` (per window, delta while ``S * bucket``
      gathered rows stay within ``merge_delta_auto_rows``);
    - ``merge_dirty_count(local) -> 0-d int`` — one shard's dirty rows
      (the engine takes the max over the shards to size the bucket);
    - ``merge_delta(base, locals_, bucket) -> summary`` — compact each
      shard's dirty rows to ``bucket`` lanes, gather them to ``base``'s
      device and apply them to the carried global ``base``: the
      cross-shard merge and the Merger combine in one step.

    The ingest codec (both of the first two must be set to engage):

    - ``host_compress(chunk) -> payload`` runs on a codec worker and
      reduces a host chunk to a numpy payload;
    - ``fold_compressed(summary, stacked_payload)`` folds a unit's stacked
      payloads (tensors on the device, leading axis K);
    - ``stack_payloads(payloads, groups[, seq=])`` stacks a unit's
      variable-length payloads (None: equal shapes, ``np.stack``);
    - ``stack_ordered`` — the stacker mutates per-run state in STREAM
      order and takes ``seq=`` (units are numbered from 0 per run);
    - ``on_stage_error(seq)`` — releases a failed unit's ordered turn;
    - ``ordered_wait_s()`` — seconds stagers spent blocked in that turn
      (moved from ``ingest_compress`` to a ``codec_wait`` stage);
    - ``on_run_start()`` fires at the start of every run (fresh codec
      state); ``on_resume(summary)`` fires after a resumed run loaded its
      summary (the compact plan rebuilds its id session from it);
    - ``requires_codec`` — the plan folds only through its codec;
    - ``codec_pad_values`` / ``codec_payload_check`` — the payload's pad
      values and an id-range validator for producer-compressed payloads.

    ``device_fields`` names the chunk fields the raw ``fold`` reads (None:
    all). The engine copies only those to the device, as ``gelly_tpu``'s
    jit drops the arguments a fold never reads; the others stay host
    tensors in the chunk the fold gets.
    """

    init: Callable[[torch.device], Summary]
    fold: Callable[[Summary, EdgeChunk], Summary]
    combine: Callable[[Summary, Summary], Summary]
    transform: Callable[[Summary], Any] | None = None
    transient: bool = False
    jit_transform: bool = True
    merge_stacked: Callable[[Summary], Summary] | None = None
    host_compress: Callable[[EdgeChunk], Any] | None = None
    fold_compressed: Callable[[Summary, Any], Summary] | None = None
    stack_payloads: Callable[..., Any] | None = None
    codec_payload_check: Callable[[Any], None] | None = None
    codec_pad_values: dict | None = None
    stack_ordered: bool = False
    on_stage_error: Callable[[int], None] | None = None
    ordered_wait_s: Callable[[], float] | None = None
    on_run_start: Callable[[], None] | None = None
    on_resume: Callable[[Summary], None] | None = None
    requires_codec: bool = False
    device_fields: tuple[str, ...] | None = None
    flatten: Callable[[Summary], Summary] | None = None
    fold_accumulates: bool = False
    fold_backend: str = "plain"
    merge_degree: int | None = None
    merge_mode: str = "replicated"
    merge_delta: Callable[..., Summary] | None = None
    merge_dirty_count: Callable[[Summary], Any] | None = None
    merge_delta_auto_rows: int | None = None
    name: str = "aggregation"


# Auto-codec threshold: below this slot-space size a dense per-chunk
# payload (n_v * 4 bytes) is cheaper than touched-slot pairs.
SPARSE_CODEC_MIN_CAPACITY = 1 << 20

# Smallest dirty-delta gather bucket (the floor of the pow-2 ladder): a
# plan whose auto bound is below S * floor never takes the delta merge.
DELTA_MERGE_MIN_BUCKET = 256


def available_cores() -> int:
    """Cores this process may run on (affinity-aware)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:
        return os.cpu_count() or 1


def resolve_sparse_codec(codec: str, vertex_capacity: int) -> bool:
    """Validate and resolve ``codec=`` ``"auto"``/``"dense"``/``"sparse"``
    to a bool (sparse?)."""
    if codec not in ("auto", "dense", "sparse"):
        raise ValueError(f"codec must be auto/dense/sparse, got {codec}")
    return codec == "sparse" or (
        codec == "auto" and vertex_capacity >= SPARSE_CODEC_MIN_CAPACITY
    )


def group_combine_payloads(payloads: list, groups: int,
                           combine_fn: Callable[[list], dict],
                           empty_payload: dict) -> list:
    """Merge a batch larger than ``groups`` down to exactly ``groups``
    payloads (ceil-sized contiguous groups, padded with ``empty_payload``);
    ``len(payloads) <= groups`` returns the list unchanged."""
    if len(payloads) <= groups:
        return payloads
    size = -(-len(payloads) // groups)
    combined = [
        combine_fn(payloads[i:i + size])
        for i in range(0, len(payloads), size)
    ]
    while len(combined) < groups:
        combined.append(empty_payload)
    return combined


def bucket_stack_payloads(payloads: list, pad_values: dict,
                          min_bucket: int = 1024,
                          quantum: int | None = None,
                          per_key: dict | None = None) -> dict:
    """Stack variable-length dict payloads to a shared bucket.

    Keys in ``pad_values`` are padded with their value to ``max(min_bucket,
    next_pow2(longest))`` (or, with ``quantum``, the next multiple of
    ``quantum``); ``per_key`` gives a key its own ``(min_bucket,
    quantum)`` ladder. Other keys are stacked as-is.
    """
    def _cap(longest, mb, q):
        if q:
            return max(mb, -(-longest // q) * q)
        return max(mb, 1 << max(0, longest - 1).bit_length())

    per_key = per_key or {}
    shared = [k for k in pad_values if k not in per_key]
    longest = max(
        (p[k].shape[0] for p in payloads for k in shared), default=0
    )
    caps = {k: _cap(longest, min_bucket, quantum) for k in shared}
    for k, (mb, q) in per_key.items():
        lk = max((p[k].shape[0] for p in payloads), default=0)
        caps[k] = _cap(lk, mb, q)
    out = {}
    for key in payloads[0]:
        if key in pad_values:
            stacked = np.full(
                (len(payloads), caps[key]), pad_values[key],
                dtype=payloads[0][key].dtype,
            )
            for i, p in enumerate(payloads):
                stacked[i, : p[key].shape[0]] = p[key]
            out[key] = stacked
        else:
            out[key] = np.stack([p[key] for p in payloads])
    return out


def sparse_payload_id_check(vertex_capacity: int, *keys: str):
    """A ``codec_payload_check`` that every listed key of a sparse codec
    payload carries vertex ids in ``[0, vertex_capacity)``."""
    def check(payload) -> None:
        if not isinstance(payload, dict):
            raise ValueError(
                f"compressed payload must be a dict of arrays, got "
                f"{type(payload).__name__} — was it compressed by a "
                "different plan/codec?"
            )
        for key in keys:
            if key not in payload:
                raise ValueError(
                    f"compressed payload is missing key {key!r} — was "
                    "it compressed by a different plan/codec?"
                )
            a = np.asarray(payload[key])
            if a.size == 0:
                continue
            lo, hi = int(a.min()), int(a.max())
            if lo < 0 or hi >= vertex_capacity:
                bad = lo if lo < 0 else hi
                raise ValueError(
                    f"compressed payload key {key!r} carries vertex id "
                    f"{bad} out of range for vertex_capacity "
                    f"{vertex_capacity} — compressed by a plan with a "
                    "different capacity? (an out-of-range id would "
                    "silently drop/clamp in the device scatter)"
                )

    return check


def edges_fold_adapter(fold_edges: Callable, *, with_value: bool = True):
    """Wrap a per-edge user fold ``foldEdges(acc, src, dst[, val])`` into a
    chunk fold (the reference's EdgesFold contract, M/EdgesFold.java:33-48).

    The fold calls ``fold_edges`` once for each valid edge of the chunk, in
    stream order, with 0-d tensors on the chunk's device (one host read of
    the valid mask a chunk). It is there so that any user fold runs; the
    library's folds are vectorised."""

    def fold(summary, chunk: EdgeChunk):
        for i in chunk.valid.cpu().nonzero().flatten().tolist():
            args = (chunk.src[i], chunk.dst[i])
            if with_value:
                args += (chunk.val[i],)
            summary = fold_edges(summary, *args)
        return summary

    return fold


class SummaryStream:
    """Lazy stream of per-window emissions from a running aggregation.

    Iterating yields ``transform(summary)`` once per closed window (plus
    once at end of stream for a final partial window). ``result()`` drains
    the stream and returns the last emission. ``timer`` holds the stage
    busy seconds; ``stats`` the run's unit, chunk and H2D byte counts.
    """

    def __init__(self, gen_fn: Callable[[], Iterator]):
        self._gen_fn = gen_fn

    def __iter__(self):
        return self._gen_fn()

    def result(self):
        last = None
        for last in self:
            pass
        return last


class WindowedStream(SummaryStream):
    """A :class:`SummaryStream` over a pane ring (``windowed=W``), plus the
    queryable epoch handle: :meth:`snapshot` returns the latest ``{"window",
    "labels"}`` emission under a lock, readable from any thread while the
    stream advances. It is at most one pane stale (the value published at
    the newest pane close), and ``None`` before the first close."""

    def __init__(self, gen_fn: Callable[[], Iterator], holder: dict):
        super().__init__(gen_fn)
        self._holder = holder

    def snapshot(self):
        with self._holder["lock"]:
            val = self._holder["val"]
            self.stats["windows.snapshot_reads"] += 1
        obs_bus.get_bus().inc("windows.snapshot_reads")
        return val


# Knobs of gelly_tpu's run_aggregation this slice does not run, with the
# value that means "off" and the ROADMAP.md item that brings each.
_NOT_YET = {
    "source_provider": (None, "queue 1 item 12b (ingest)"),
    "precompressed": (False, "queue 1 item 12b (ingest)"),
}


def _refuse_later_knobs(knobs: dict) -> None:
    for key, value in knobs.items():
        if key not in _NOT_YET:
            raise TypeError(f"run_aggregation() got an unexpected keyword "
                            f"argument {key!r}")
        off, item = _NOT_YET[key]
        if value != off:
            raise NotImplementedError(
                f"run_aggregation({key}=...) is not ported yet: "
                f"ROADMAP.md {item}"
            )


def _fresh(emission):
    """A transform-less emission must not alias live state."""
    if isinstance(emission, torch.Tensor):
        return emission.clone()
    if isinstance(emission, tuple):
        items = (_fresh(e) for e in emission)
        if hasattr(emission, "_fields"):  # a NamedTuple
            return type(emission)(*items)
        return tuple(items)
    return emission


def _clone_tree(tree):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _copying(combine):
    """``combine`` on copies of both arguments: pane rings and checkpoint
    snapshots read both again, and a plan may combine in place."""
    return lambda a, b: combine(_clone_tree(a), _clone_tree(b))


def _flatten(payload, prefix: tuple = ()):
    """``(leaves, rebuild)`` of a payload tree: dicts (sorted keys),
    NamedTuples (their fields) and tuples, nested or not; anything else is
    a leaf. Each leaf comes with its key: its field name at the top level
    (the names ``skip`` lists), the path of names below it (a fused
    multi-query payload nests one dict a query), ``""`` for a bare
    array."""
    if isinstance(payload, dict):
        names = sorted(payload)
        items = [payload[k] for k in names]
        make = lambda vals: dict(zip(names, vals))  # noqa: E731
    elif isinstance(payload, tuple):
        names = list(getattr(payload, "_fields", range(len(payload))))
        items = list(payload)
        make = ((lambda vals: type(payload)(*vals))
                if hasattr(payload, "_fields") else tuple)
    else:
        key = prefix[0] if len(prefix) == 1 else (prefix or "")
        return [(key, payload)], lambda ls: ls[0]
    parts = [_flatten(x, prefix + (n,)) for n, x in zip(names, items)]

    def rebuild(ls):
        vals, i = [], 0
        for leaves, rb in parts:
            vals.append(rb(ls[i:i + len(leaves)]))
            i += len(leaves)
        return make(vals)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def _payload_nbytes(parts: list) -> int:
    """Host bytes of a staged unit's shard payloads — span attribution
    only (called on the tracer-enabled path, never the bare unit path)."""
    return int(sum(x.numel() * x.element_size()
                   if isinstance(x, torch.Tensor) else getattr(x, "nbytes", 0)
                   for part in parts for _, x in _flatten(part)[0]))


def _group_edges(group) -> int:
    """Valid-edge count of a unit's host chunks — span/heartbeat
    attribution only (one count of a chunk's mask, tracer-enabled path
    only; ``count_nonzero`` reads the bools without widening them)."""
    return int(sum(int(c.valid.count_nonzero()) for c in group))


def _stack_tree(payloads: list):
    """Generic stacker of equal-shape payloads (leading axis K)."""
    leaves = [_flatten(p)[0] for p in payloads]
    rebuild = _flatten(payloads[0])[1]
    return rebuild([np.stack([np.asarray(ls[i][1]) for ls in leaves])
                    for i in range(len(leaves[0]))])


def _host_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


class PinnedRing:
    """Host-to-device staging through reusable pinned buffers.

    ``slots`` buffers per payload key (``h2d_depth + 1`` in the engine),
    taken in turn. :meth:`put` copies each host leaf into its slot's
    pinned buffer, then issues the device copy on a side stream and
    records one event for the unit; before a slot's buffers are written
    again, the calling (H2D) thread waits on that slot's previous event.
    The consumer orders its folds after the copy with a device-side
    ``wait_event``, so it never blocks on an upload. Device tensors are
    marked used by ``consumer`` (``record_stream``), so the caching
    allocator does not hand their memory to the side stream while the
    consumer's folds may still read it. Leaves named in ``skip`` stay on
    the host. Off CUDA, :meth:`put` wraps the host arrays as CPU tensors
    (no copy) and returns no event.
    """

    def __init__(self, device: torch.device, slots: int,
                 consumer: "torch.cuda.Stream | None" = None):
        self.device = device
        self.slots = max(1, int(slots))
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.consumer = consumer
        self._bufs: dict = {}  # (key, slot) -> pinned uint8 tensor
        self._events: list = [None] * self.slots
        self._turn = 0
        self.bytes = 0
        self.reuses = 0  # slot writes that found an earlier copy's buffer

    def _buffer(self, key, slot: int, nbytes: int) -> torch.Tensor:
        buf = self._bufs.get((key, slot))
        if buf is None or buf.numel() < nbytes:
            # Headroom: bucketed payloads grow a quantum at a time.
            buf = torch.empty(max(nbytes + nbytes // 4, 1 << 12),
                              dtype=torch.uint8, pin_memory=True)
            self._bufs[(key, slot)] = buf
        return buf

    def put(self, payload, skip: frozenset = frozenset()):
        """``(device payload, event or None)`` of one staged unit."""
        leaves, rebuild = _flatten(payload)
        hosts = [(k, _host_tensor(x)) for k, x in leaves]
        self.bytes += sum(h.numel() * h.element_size()
                          for k, h in hosts if k not in skip)
        if not self.cuda:
            return rebuild([h for _, h in hosts]), None
        slot = self._turn % self.slots
        self._turn += 1
        prev = self._events[slot]
        if prev is not None:
            self.reuses += 1
            prev.synchronize()  # the slot's last copy has left its buffers
        out = []
        with torch.cuda.stream(self.stream):
            for key, h in hosts:
                if key in skip:
                    out.append(h)
                    continue
                nbytes = h.numel() * h.element_size()
                staged = self._buffer(key, slot, nbytes)[:nbytes]
                staged = staged.view(h.dtype).view(h.shape)
                staged.copy_(h)
                dev = torch.empty(h.shape, dtype=h.dtype, device=self.device)
                dev.copy_(staged, non_blocking=True)
                if self.consumer is not None:
                    dev.record_stream(self.consumer)
                out.append(dev)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[slot] = event
        return rebuild(out), event


def _stack_panes(panes: list):
    """Stack pane summaries on a new leading axis (``[W, ...]`` leaves)."""
    flat = [tree_flatten(p) for p in panes]
    return tree_unflatten(flat[0][1], [
        torch.stack([leaves[i] for leaves, _ in flat])
        for i in range(len(flat[0][0]))])


def _load_lateness(checkpoint_path: str, position: int) -> dict | None:
    """The reorder buffer saved beside a checkpoint at ``position``
    (``<path>.lateness.<position>``, or the unstamped legacy name), or
    None when there is none."""
    side = f"{checkpoint_path}.lateness.{position}"
    if not os.path.exists(side):
        side = checkpoint_path + ".lateness"
    if not os.path.exists(side):
        return None
    flat, side_pos, side_meta = load_checkpoint(side)
    if side_pos != position:
        raise ValueError(
            f"lateness sidecar position {side_pos} does not match "
            f"checkpoint position {position} (crash between the paired "
            "writes?) — the reorder buffer cannot be restored "
            "consistently"
        )
    nf = len(EdgeChunk._fields)
    return {
        "wins": side_meta["wins"],
        "chunks": [EdgeChunk(*flat[i * nf:(i + 1) * nf])
                   for i in range(len(side_meta["wins"]))],
        "closed_upto": side_meta["closed_upto"],
        "max_ts": side_meta["max_ts"],
    }


def _check_window_knobs(agg, window_ms, allowed_lateness, windowed,
                        ttl_panes, prefetch_depth, h2d_depth) -> None:
    """The cadence knobs' refusals, with ``gelly_tpu``'s messages."""
    if allowed_lateness and window_ms is None:
        raise ValueError(
            "allowed_lateness requires window_ms (merge_every mode is "
            "count-based and does not reorder by timestamp)"
        )
    if windowed is not None:
        if windowed < 1:
            raise ValueError(f"windowed must be >= 1 pane, got {windowed}")
        if window_ms is not None:
            raise ValueError(
                "windowed panes ride the merge_every cadence (one pane "
                "per merge window, merge_every chunks each); event-time "
                "window_ms is a different cadence axis — size the pane "
                "with merge_every instead"
            )
        if getattr(agg, "queries", None):
            raise ValueError(
                f"fused plan '{agg.name}' cannot carry a pane ring: the "
                "ring combines ONE plan's pane summaries, and per-query "
                "cadences (QuerySpec.every) would desynchronize the "
                "shared pane boundary — run the windowed query as its "
                "own stream"
            )
        if agg.transient:
            raise ValueError(
                f"aggregation '{agg.name}' is transient (emit-and-reset "
                "Merger): its windows are already independent, so a "
                "pane ring over them has nothing to combine — drop "
                "windowed= or use a non-transient plan"
            )
        if agg.merge_mode == "delta" or agg.merge_delta is not None:
            raise ValueError(
                f"aggregation '{agg.name}' supplies a dirty-delta merge "
                "(merge_mode/merge_delta): the delta path folds dirty "
                "rows into a CARRIED global summary, but a pane ring "
                "retires panes — the two memory models are exclusive; "
                "use the windowed builder variant (merge_delta=None)"
            )
    if ttl_panes is None:
        return
    if windowed is None:
        raise ValueError(
            "ttl_panes requires windowed=W: TTL stamps are "
            "last-seen PANE indices, and eviction runs at pane "
            "boundaries — there is no pane clock without a ring"
        )
    if ttl_panes < windowed:
        raise ValueError(
            f"ttl_panes={ttl_panes} < windowed={windowed}: a slot "
            "must outlive the ring (T >= W) so an evicted id is "
            "guaranteed untouched in every live pane — otherwise "
            "eviction would rewrite panes that still reference it"
        )
    if (getattr(agg, "windowed_evict", None) is None
            or getattr(agg, "windowed_touched", None) is None):
        raise ValueError(
            f"aggregation '{agg.name}' has no TTL eviction hooks "
            "(windowed_evict + windowed_touched): per-vertex decay "
            "needs a compact-id plan that can renumber its session "
            "— build one with connected_components(compact=..., "
            "windowed=W, ttl_panes=T)"
        )
    if prefetch_depth != 0 or h2d_depth != 0:
        raise ValueError(
            "ttl_panes needs a quiesced pipeline: pass "
            "prefetch_depth=0 and h2d_depth=0 so no compact-id "
            "assignment is staged but unfolded when the session "
            "renumbers at a pane boundary (in-flight payloads "
            "would still carry the OLD ids)"
        )


def _check_merge_knobs(agg, S: int) -> bool:
    """The cross-shard merge knobs' refusals (``gelly_tpu``'s plan-time
    messages); returns whether the dirty-delta merge is armed."""
    if agg.merge_mode not in ("replicated", "delta", "auto"):
        raise ValueError(
            f"plan {agg.name!r}: merge_mode must be 'replicated', "
            f"'delta' or 'auto', got {agg.merge_mode!r}"
        )
    if S > 1 and agg.merge_mode == "delta" and agg.merge_delta is None:
        raise ValueError(
            f"plan {agg.name!r} sets merge_mode='delta' but supplies no "
            "merge_delta — the delta merge is summary-specific and must "
            "come from the plan (see SummaryAggregation.merge_delta); "
            "use merge_mode='replicated' for plans without one"
        )
    armed = (S > 1 and agg.merge_delta is not None
             and (agg.merge_mode == "delta"
                  or (agg.merge_mode == "auto"
                      and agg.merge_delta_auto_rows is not None
                      and S * DELTA_MERGE_MIN_BUCKET
                      <= agg.merge_delta_auto_rows)))
    if armed and agg.merge_dirty_count is None:
        raise ValueError(
            f"plan {agg.name!r} supplies merge_delta without "
            "merge_dirty_count — the engine sizes the delta gather "
            "bucket from the measured count; supply both or neither"
        )
    return armed


def _shard_rows(tree, num_shards: int) -> list:
    """Split every leaf's leading axis ``[K', ...]`` into S contiguous
    row blocks (``gelly_tpu``'s ``[S, K'/S, ...]`` batch split)."""
    leaves, rebuild = _flatten(tree)
    out = []
    for i in range(num_shards):
        rows = []
        for _, x in leaves:
            k = x.shape[0] // num_shards
            rows.append(x[i * k:(i + 1) * k])
        out.append(rebuild(rows))
    return out


def _split_stacked(stacked: EdgeChunk, num_shards: int) -> list:
    """A host-stacked raw unit ``[K, C]`` split per shard to ``[K,
    ceil(C/S)]`` rows (each row padded with invalid lanes, as
    ``split_chunk`` pads one chunk)."""
    out = [[] for _ in range(num_shards)]
    for f in stacked:
        f = np.asarray(f)
        k, c = f.shape[:2]
        per = -(-c // num_shards)
        if per * num_shards != c:
            pad = np.zeros((k, per * num_shards - c) + f.shape[2:], f.dtype)
            f = np.concatenate([f, pad], axis=1)
        f = f.reshape((k, num_shards, per) + f.shape[2:])
        for i in range(num_shards):
            out[i].append(np.ascontiguousarray(f[:, i]))
    return [EdgeChunk(*fs) for fs in out]


def run_aggregation(agg: SummaryAggregation, stream, mesh=None,
                    merge_every: int | None = None,
                    prefetch_depth: int | None = None,
                    fold_batch: int = 1,
                    ingest_workers: int | None = None,
                    codec_workers: int | None = None,
                    h2d_depth: int | None = None,
                    device_fields: tuple[str, ...] | None = None,
                    host_precombine: Callable | None = None,
                    timer=None, checkpoint_path: str | None = None,
                    checkpoint_every: int = 1, resume: bool = False,
                    window_ms: int | None = None, allowed_lateness: int = 0,
                    windowed: int | None = None,
                    ttl_panes: int | None = None,
                    queries=None,
                    **knobs) -> SummaryStream:
    """Execute ``agg`` over ``stream`` on ``stream.ctx.device``, or on the
    shards of ``mesh`` (``parallel.mesh.make_mesh``).

    ``merge_every`` (chunks, default 1) sets the emit cadence. A plan with
    ``fold_accumulates`` that is not ``transient`` runs the accumulate
    plan (one running summary, emitted at each window close); any other
    runs the per-window Merger plan: each window folds into fresh locals
    (``init``), and its close computes ``combine(locals, global)``, which
    becomes the new global (``transient``: is emitted, and the global
    resets to ``init``). The emission is ``transform`` of the summary, or
    a clone of it, never the live state. ``host_precombine(chunk) ->
    chunk`` reduces each raw chunk on the staging thread before it is
    stacked or copied (codec plans ignore it).
    ``fold_batch`` groups up to that many chunks into one unit (clamped
    to a divisor of ``merge_every``): codec plans stack the unit's
    payloads (a short last unit is padded with identity payloads), raw
    plans stack its chunks (padded with empty chunks) and fold the rows
    in order. ``device_fields`` (default: the plan's) names the chunk
    fields a raw unit copies to the device. ``codec_workers`` (alias
    ``ingest_workers``) sizes the staging pool (default for codec plans
    one a core, at most 8; for raw plans 0, staging inline),
    ``prefetch_depth`` (default ``max(2, workers)``) the staged units in
    flight, ``h2d_depth`` the transferred units ahead of the fold
    (default 2 for codec plans, 0 for raw ones: 0 copies inline on the
    consumer). ``timer`` (a
    :class:`~gelly_torch.utils.metrics.StageTimer`, also
    ``stream.timer``) collects busy seconds of ``ingest_compress``,
    ``codec_wait``, ``h2d``, ``fold_dispatch`` and ``merge_emit``.

    ``window_ms`` (instead of ``merge_every``) folds tumbling event-time
    windows (``core/windows.py``): one chunk a unit, each chunk masked to
    one window (and compressed after the masking when the plan has a
    codec); windows without data never fire, late edges are dropped and
    counted in ``stats["late_edges"]``. ``allowed_lateness`` (ms) turns on
    the watermark reorder buffer (``stats["buffered_edges"]`` /
    ``["open_windows"]``); its checkpoint sidecar
    ``<checkpoint_path>.lateness.<position>`` holds the buffered edges.

    ``windowed=W`` (default: the plan's ``windowed_panes``) emits over the
    last W panes only, one pane a merge window: each pane folds from fresh
    locals, is pushed into a :class:`~gelly_torch.core.windows.PaneRing`
    and the window is its suffix combine. ``ttl_panes=T`` (T >= W,
    compact-id plans, ``prefetch_depth=0`` and ``h2d_depth=0``) evicts
    compact ids untouched for T panes through the plan's
    ``windowed_evict``. The stream is a :class:`WindowedStream`; its
    ``stats`` count ``windows.panes_closed``,
    ``windows.combine_dispatches``, ``windows.evicted_slots`` and
    ``windows.snapshot_reads`` (``gelly_tpu``'s bus counters), and
    checkpoints (pane boundaries only) hold the ring's panes stacked on a
    ``[W, ...]`` template, the persistent id map and the TTL stamps.

    ``checkpoint_path`` writes the summary (the running one, or the
    Merger plan's global) and the stream position every
    ``checkpoint_every`` closed windows and after a final partial window
    (``engine/checkpoint.py``'s format; the plan's ``flatten`` runs first
    and its result replaces the live summary). The position is the number
    of chunks whose fold the snapshot holds (the last-retired-chunk rule);
    windows close on unit boundaries, so it is exact (``window_ms``:
    checkpoints at chunk boundaries, holding a partial window). A
    window's checkpoint is written when the consumer asks for the next
    emission, so a consumer that stops right after emission k leaves
    checkpoint k-1. ``resume=True`` loads the summary onto
    ``stream.ctx.device`` (the Merger plan's global, with fresh locals),
    fires ``on_resume``, restores the window count and drops the folded
    chunks before any staging. The timer adds ``checkpoint``,
    ``resume_load``, ``on_resume`` and ``resume_skip`` busy seconds;
    ``stats`` adds ``checkpoints``, ``checkpoint_bytes`` and
    ``resumed_at``.

    ``mesh`` with S > 1 shards runs ``gelly_tpu``'s sharded plan: fresh
    locals on every shard each window (never the accumulate plan), each
    raw chunk split into S slices of ``ceil(C/S)`` lanes (a slice's
    capacity picks the fold's path), each codec batch stacked with
    ``groups=S`` and split into S row blocks (``fold_batch`` promoted to a
    multiple of S; a ``merge_every`` S does not divide turns the codec
    off, and a ``requires_codec`` plan refuses), and at each close the
    cross-shard merge then the Merger combine into the global summary on
    the first shard's device, or one ``merge_delta`` (``merge_mode``,
    counted in ``stats["merge_modes"]``). Checkpoints hold the global
    summary, as ``gelly_tpu``'s do.

    ``queries=[...]`` (with ``agg=None``) fuses the queries into one
    plan (:func:`~gelly_torch.engine.multiquery.fuse`): each chunk is
    staged and copied once and every query folds it in the one fused
    fold. ``merge_every`` mode only, with no ``host_precombine`` and no
    pane ring; on S > 1 shards every query must accumulate. The stream is
    a :class:`~gelly_torch.engine.multiquery.MultiQueryStream` (emission
    dicts keyed by query name, live per-query snapshots). A fused plan
    passed as ``agg`` runs the same way.

    Every other knob of ``gelly_tpu``'s ``run_aggregation`` is accepted
    by name and raises ``NotImplementedError`` (naming its ROADMAP.md
    item) unless it is left at its "off" value.
    """
    from ..core.windows import PaneRing, tumbling_window_events
    from ..utils.metrics import StageTimer
    from ..utils.prefetch import prefetch, prefetch_map

    _refuse_later_knobs(knobs)
    if queries is not None:
        if agg is not None:
            raise ValueError(
                "pass a single aggregation OR queries=[...], not both "
                "(queries are fused into one plan by engine.multiquery)"
            )
        from .multiquery import fuse

        agg = fuse(queries)
    if agg is None:
        raise ValueError("an aggregation is required (or pass queries=[...])")
    # The normalized QuerySpec tuple of a fused plan; None for plain plans.
    fused = getattr(agg, "queries", None) or None
    if resume and not checkpoint_path:
        raise ValueError("resume=True requires checkpoint_path")
    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if merge_every is not None and window_ms is not None:
        raise ValueError("pass at most one of merge_every / window_ms")
    if merge_every is None:
        merge_every = 1
    if merge_every < 1:
        raise ValueError(f"merge_every must be >= 1, got {merge_every}")
    if codec_workers is not None:
        if ingest_workers is not None:
            raise ValueError(
                "pass codec_workers or ingest_workers, not both (they are "
                "the same knob; codec_workers is the executor-facing name)"
            )
        ingest_workers = codec_workers
    # The accumulate plan carries one running summary; any other plan is
    # the per-window Merger (fresh locals, combine into global at close).
    use_codec = (agg.host_compress is not None
                 and agg.fold_compressed is not None)
    # Raw units stage nothing and copy a few bytes an edge, while their
    # folds sync with the device every round: by default they run inline,
    # where helper threads would only delay the consumer's wake-ups
    # (measured with chip_ab.py, PERF.md). Explicit values are honored
    # for every plan.
    if h2d_depth is None:
        h2d_depth = 2 if use_codec else 0  # codec: double buffer
    if h2d_depth < 0:
        raise ValueError(f"h2d_depth must be >= 0, got {h2d_depth}")
    if ingest_workers is None:
        # One codec worker per available core, capped at 8 (each staged
        # unit holds host payloads and pinned buffers).
        ingest_workers = min(available_cores(), 8) if use_codec else 0
    if prefetch_depth is None:
        prefetch_depth = max(2, ingest_workers)
    if windowed is None:
        windowed = getattr(agg, "windowed_panes", None)
    if ttl_panes is None:
        ttl_panes = getattr(agg, "windowed_ttl_panes", None)
    windowed = None if windowed is None else int(windowed)
    ttl_panes = None if ttl_panes is None else int(ttl_panes)
    _check_window_knobs(agg, window_ms, allowed_lateness, windowed,
                        ttl_panes, prefetch_depth, h2d_depth)
    if agg.requires_codec and not use_codec:
        raise ValueError(
            f"aggregation '{agg.name}' folds only through its ingest codec, "
            "but it supplies no host_compress/fold_compressed pair"
        )
    from ..parallel import collectives
    from ..parallel.mesh import Mesh
    from ..parallel.partition import split_chunk

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a gelly_torch.parallel.mesh.Mesh, got "
            f"{type(mesh).__name__}")
    devices = (list(mesh.devices) if mesh is not None
               else [stream.ctx.device])
    S = len(devices)
    mesh_ = mesh if mesh is not None else Mesh(devices)
    if fused:
        if window_ms is not None:
            raise ValueError(
                f"fused plan '{agg.name}' is merge_every-only: per-query "
                "cadences (QuerySpec.every) count chunks, and event-time "
                "windows cannot mask the shared fused fold per query"
            )
        if host_precombine is not None:
            raise ValueError(
                "host_precombine rewrites the shared chunk for ONE "
                "query's benefit; a fused plan folds EVERY query from "
                "the same chunk — drop it (fold the pre-combine into "
                "that query's own fold instead)"
            )
        if S > 1 and any(not q.accum or q.every != 1 for q in fused):
            raise ValueError(
                f"fused plan '{agg.name}' carries a non-accumulating "
                "query (or a per-query merge window > 1): its in-fold "
                "merges are per-partition, so the fused plan is "
                f"single-shard — run on a 1-device mesh (S={S} here); "
                "scale out by sharding the TENANT axis via "
                "MultiTenantEngine(mesh=...) instead"
            )
    delta_armed = _check_merge_knobs(agg, S)
    # A pane ring folds every pane from FRESH locals (the ring supplies
    # the accumulation), and S > 1 shards merge their locals each window:
    # neither runs the accumulate plan.
    accum = (agg.fold_accumulates and not agg.transient and windowed is None
             and S == 1)
    # A divisor of merge_every, so window boundaries are unit boundaries
    # (and on a sharded codec plan a multiple of S: the payload batch
    # splits across the shards); event-time windows fold one masked
    # chunk at a time.
    batch = 1
    if window_ms is None:
        batch = max(1, min(fold_batch, merge_every))
        while merge_every % batch:
            batch -= 1
        if use_codec and S > 1:
            if batch % S:
                batch = S if merge_every % S == 0 else 1
            if batch % S:
                use_codec = False  # no aligned batching possible
    if agg.requires_codec and not use_codec:
        raise ValueError(
            f"aggregation '{agg.name}' folds only through its ingest codec, "
            "but the codec cannot engage here: "
            f"merge_every={merge_every} cannot align a payload "
            f"batch with the {S}-shard mesh (make merge_every a "
            "multiple of the shard count)"
        )
    device = devices[0]
    if device_fields is None:
        device_fields = agg.device_fields
    skip = frozenset()
    if device_fields is not None and not use_codec:
        bad = set(device_fields) - set(EdgeChunk._fields)
        if bad:
            raise ValueError(f"device_fields: no chunk field {sorted(bad)}")
        skip = frozenset(EdgeChunk._fields) - set(device_fields)
    if timer is None:
        timer = StageTimer()
    stats = {"units": 0, "chunks": 0, "h2d_bytes": 0, "checkpoints": 0,
             "checkpoint_bytes": 0, "resumed_at": None, "late_edges": 0,
             "windows_closed": 0,
             "merge_modes": {"delta": 0, "replicated": 0}}
    win_holder = None
    if windowed is not None:
        win_holder = {"lock": threading.Lock(), "val": None}
        # gelly_tpu's bus counters of the ring, kept in stats: like the
        # bus's, they count across the stream's runs.
        stats.update({"windows.panes_closed": 0,
                      "windows.combine_dispatches": 0,
                      "windows.evicted_slots": 0,
                      "windows.snapshot_reads": 0})
    win_touched = getattr(agg, "windowed_touched", None)
    win_persist_init = getattr(agg, "windowed_persist_init", None)
    win_persist_update = getattr(agg, "windowed_persist_update", None)
    win_query_fixup = getattr(agg, "windowed_query_fixup", None)
    win_on_resume = getattr(agg, "on_resume_windowed", None)
    windowed_evict = getattr(agg, "windowed_evict", None)
    copying_combine = _copying(agg.combine)

    def emit(summary):
        out = agg.transform(summary) if agg.transform is not None \
            else _fresh(summary)
        if device.type == "cuda":
            # The window's one completion barrier.
            torch.cuda.current_stream(device).synchronize()
        return out

    def fold_many(summary, stacked: EdgeChunk):
        for i in range(stacked.src.shape[0]):
            summary = agg.fold(summary, EdgeChunk(*(f[i] for f in stacked)))
        return summary

    if use_codec:
        fold_unit = agg.fold_compressed
    elif batch > 1:
        fold_unit = fold_many
    else:
        fold_unit = agg.fold

    def fresh_locals() -> list:
        return [agg.init(d) for d in devices]

    def merge_locals(locals_: list, copy: bool = False):
        """The window's summary: the one shard's locals, or the shards'
        merge (``gelly_tpu``'s shard-0 result), on ``device``."""
        if S == 1:
            return locals_[0]
        if copy:  # a checkpoint reads the live locals again
            locals_ = [_clone_tree(l) for l in locals_]
        if agg.merge_degree is not None:
            return collectives.hierarchical_merge(
                agg.combine, locals_, S, min(agg.merge_degree, S),
                mesh_)[0]
        if agg.merge_stacked is not None:
            return collectives.gather_merge(
                agg.merge_stacked, locals_, mesh_, keep=(0,))[0]
        return collectives.butterfly_merge(
            agg.combine, locals_, S, mesh_, keep=(0,))[0]

    def shard_payloads(stacked) -> list:
        return [stacked] if S == 1 else _shard_rows(stacked, S)

    def shard_chunk(chunk) -> list:
        return [chunk] if S == 1 else split_chunk(chunk, S)

    def gen():
        # The codec's run state is reset first and rebuilt from the loaded
        # summary after: the other order would wipe the rebuilt id session.
        if agg.on_run_start is not None:
            agg.on_run_start()
        # Observability bindings, resolved ONCE per run: `tracer` is None
        # unless an obs.SpanTracer is installed, and `telemetry` is False
        # (`wm` None) unless a tracer is installed or obs.bus.recording()
        # is on. Every span, histogram and watermark site below is guarded
        # by these, so the disabled unit path does no span or histogram
        # work, not even a clock read. The bus is always on, touched at
        # unit and window cadence.
        tracer = obs_tracing.active_tracer()
        bus = obs_bus.get_bus()
        telemetry = obs_bus.telemetry_on()
        wm = bus.watermarks if telemetry else None
        staged_hw = 0  # staged-depth high-water since the last beat
        # Fused plans name the queries riding each fold dispatch.
        fold_attrs = ({"queries": ",".join(q.name for q in fused)}
                      if fused else {})
        hb = meter = None
        if tracer is not None:
            from ..utils.metrics import ThroughputMeter

            meter = ThroughputMeter()
            if tracer.heartbeat_every_s is not None:
                from ..obs.heartbeat import Heartbeat

                hb = Heartbeat(tracer.heartbeat_every_s)
        wait0 = agg.ordered_wait_s() if agg.ordered_wait_s is not None \
            else 0.0
        stats.update(units=0, chunks=0, h2d_bytes=0, checkpoints=0,
                     checkpoint_bytes=0, resumed_at=None, late_edges=0,
                     windows_closed=0,
                     merge_modes={"delta": 0, "replicated": 0})
        # ``locals_`` is what the folds update, one summary a shard: the
        # running summary of the accumulate plan, or the locals of the
        # open window (the Merger plan's, or the open pane's).
        locals_ = fresh_locals()
        glob = None if accum or windowed is not None else agg.init(device)
        dirty = False  # the locals hold edges no window emitted yet
        skip_until = 0
        windows = last_ckpt_windows = 0
        current_window = None  # the open event-time window
        ring = persist = last_seen = None
        if windowed is not None:
            def on_combine(k):
                stats["windows.combine_dispatches"] += k
                bus.inc("windows.combine_dispatches", k)

            ring = PaneRing(windowed, copying_combine, on_combine=on_combine)
            if win_persist_init is not None:
                persist = win_persist_init(device)
            if ttl_panes is not None:
                last_seen = np.zeros(int(persist.shape[0]), np.int64)

        def win_like():
            # The static [W, ...] template of a ring checkpoint.
            like = {"panes": tree_map(
                lambda l: l.new_zeros((windowed,) + tuple(l.shape)),
                agg.init(device))}
            if persist is not None:
                like["persist"] = torch.zeros_like(persist)
            if last_seen is not None:
                like["last_seen"] = torch.zeros(last_seen.shape,
                                                dtype=torch.int64)
            return like

        lat_handle: dict = {}
        lat_state = None
        if resume:
            with timer("resume_load"):
                loaded, skip_until, meta_in = load_checkpoint(
                    checkpoint_path,
                    like=win_like() if windowed is not None
                    else agg.init(device))
            if windowed is not None:
                live_n = int(meta_in.get("ring_live", 0))
                ring.reload([tree_map(lambda l, i=i: l[i], loaded["panes"])
                             for i in range(live_n)],
                            meta_in.get("windows", 0))
                if persist is not None:
                    persist = loaded["persist"]
                if last_seen is not None:
                    last_seen = to_numpy(loaded["last_seen"]).copy()
                if win_on_resume is not None:
                    # The persistent map: a superset of every live pane's
                    # assignments (a pane records FIRST-seen rows only).
                    with timer("on_resume"):
                        win_on_resume(to_numpy(persist))
            else:
                if accum:
                    locals_ = [loaded]
                else:
                    glob = loaded
                if agg.on_resume is not None:
                    with timer("on_resume"):
                        agg.on_resume(loaded)
            current_window = meta_in.get("current_window")
            windows = last_ckpt_windows = meta_in.get("windows", 0)
            stats["windows_closed"] = windows
            stats["resumed_at"] = skip_until
            if allowed_lateness:
                lat_state = _load_lateness(checkpoint_path, skip_until)
        chunks_consumed = skip_until
        stats["chunks"] = chunks_consumed
        if wm is not None:
            # (Re)seed the e2e ledger at the exactly-once resume point,
            # so backlog age never reads stamps from before a resume.
            wm.seed("stream", skip_until)

        def publish_watermarks():
            # The backlog-age low watermark after a window close. Without
            # a checkpoint path the close IS the retirement point.
            if wm is None:
                return
            if not checkpoint_path:
                wm.retire_durable("stream", chunks_consumed, bus=bus,
                                  prefix="engine")
            bus.gauge("engine.backlog_age_s",
                      round(wm.backlog_age("stream"), 6))

        def maybe_checkpoint(force=False):
            nonlocal last_ckpt_windows, locals_, glob
            if not checkpoint_path or (
                    not force
                    and windows - last_ckpt_windows < checkpoint_every):
                return
            last_ckpt_windows = windows
            t_ck = tracer.now() if tracer is not None else 0.0
            with timer("checkpoint"):
                if agg.flatten is not None and windowed is None:
                    if accum:
                        locals_ = [agg.flatten(locals_[0])]
                    else:
                        glob = agg.flatten(glob)
                meta = {"name": agg.name, "windows": windows,
                        "current_window": current_window}
                if windowed is not None:
                    # Live panes stacked on the static [W, ...] template,
                    # padded with init panes; pane boundaries only.
                    panes = ring.export_panes()
                    panes += [agg.init(device)
                              for _ in range(windowed - len(panes))]
                    snap = {"panes": _stack_panes(panes)}
                    if persist is not None:
                        snap["persist"] = persist
                    if last_seen is not None:
                        snap["last_seen"] = last_seen
                    meta.update(ring_live=ring.live, windowed=windowed)
                elif accum:
                    snap = locals_[0]
                elif dirty:
                    # Event-time windows checkpoint mid-window: the open
                    # window's locals merged into a copy of the global.
                    snap = copying_combine(
                        merge_locals(locals_, copy=True), glob)
                else:
                    # Right after a close the locals hold no edge.
                    snap = glob
                if allowed_lateness and "export" in lat_handle:
                    # The sidecar first: the pair is matched by position.
                    st = lat_handle["export"]()
                    save_checkpoint(
                        f"{checkpoint_path}.lateness.{chunks_consumed}",
                        st["chunks"], position=chunks_consumed,
                        meta={"wins": [int(w) for w in st["wins"]],
                              "closed_upto": st["closed_upto"],
                              "max_ts": st["max_ts"]})
                t_wall = time.perf_counter()
                save_checkpoint(checkpoint_path, snap,
                                position=chunks_consumed, meta=meta)
                ck_bytes = obs_bus.publish_checkpoint(
                    bus, "engine", checkpoint_path, t0=t_wall)
                if allowed_lateness:
                    # Older sidecars are no resume's pair any more.
                    keep = f"{checkpoint_path}.lateness.{chunks_consumed}"
                    for old in _glob.glob(
                            _glob.escape(checkpoint_path) + ".lateness*"):
                        if old != keep:
                            try:
                                os.unlink(old)
                            except OSError:
                                pass
            stats["checkpoints"] += 1
            stats["checkpoint_bytes"] += ck_bytes
            if wm is not None:
                # The durability point: every position the checkpoint
                # covers retires from the e2e ledger.
                wm.retire_durable("stream", chunks_consumed, bus=bus,
                                  prefix="engine")
                bus.gauge("engine.backlog_age_s",
                          round(wm.backlog_age("stream"), 6))
            if tracer is not None:
                cctx = tracer.ctx(("fold", chunks_consumed))
                clink = ({"trace": cctx[0], "parent": cctx[1]}
                         if cctx is not None else {})
                tracer.span("checkpoint", "checkpoint", t_ck,
                            position=chunks_consumed, windows=windows,
                            bytes=ck_bytes, **clink)

        def close_window():
            nonlocal locals_, glob, dirty, windows
            dirty = False
            windows += 1
            stats["windows_closed"] = windows
            if accum:
                bus.inc("engine.windows_closed")
                if tracer is not None:
                    tracer.instant("window_close", window=windows,
                                   mode="accumulate")
                return emit(locals_[0])
            merged = None
            mode = "replicated"
            if delta_armed:
                # The measured decision: the largest shard's dirty count
                # sizes the gather bucket (one scalar read a close).
                count = int(torch.stack([
                    agg.merge_dirty_count(l).to(device) for l in locals_
                ]).max())
                bus.gauge("engine.window_dirty_rows", count)
                bucket = max(DELTA_MERGE_MIN_BUCKET,
                             1 << max(0, count - 1).bit_length())
                limit = agg.merge_delta_auto_rows
                if agg.merge_mode == "delta" or (
                        limit is not None and S * bucket <= limit):
                    merged = agg.merge_delta(glob, locals_, bucket)
                    stats["merge_modes"]["delta"] += 1
                    bus.inc("engine.dirty_rows_gathered", S * bucket)
                    mode = "delta"
            if merged is None:
                # The cross-shard merge, then the parallelism-1 Merger
                # (M/SummaryAggregation.java:107-119).
                merged = agg.combine(merge_locals(locals_), glob)
                stats["merge_modes"]["replicated"] += 1
            if agg.transient:
                # Emit combine(window, global), then reset the global to
                # the combine identity; after a resume the restored
                # global is folded into the first emission.
                glob = agg.init(device)
            else:
                glob = merged
            locals_ = fresh_locals()  # fresh locals for the next window
            bus.inc("engine.windows_closed")
            if tracer is not None:
                tracer.instant("window_close", window=windows, mode=mode)
            return emit(merged)

        def close_pane():
            # Push this merge window's pane (fresh locals from here on, so
            # no later fold writes it), decay TTL slots, and answer the
            # W-pane window by suffix combines.
            nonlocal locals_, dirty, windows, persist, last_seen
            t_h = time.perf_counter() if telemetry else 0.0
            pane = merge_locals(locals_)
            locals_ = fresh_locals()
            dirty = False
            if win_persist_update is not None:
                persist = win_persist_update(persist, pane)
            ring.push(pane)
            windows += 1
            stats["windows_closed"] = windows
            stats["windows.panes_closed"] += 1
            bus.inc("engine.windows_closed")
            bus.inc("windows.panes_closed")
            if last_seen is not None:
                last_seen[to_numpy(win_touched(pane))] = windows
                assigned = int(agg.session.assigned)
                stale = np.zeros(last_seen.shape[0], dtype=bool)
                if assigned:
                    stale[:assigned] = (
                        windows - last_seen[:assigned]) >= ttl_panes
                if stale.any():
                    # T >= W: a stale id is untouched in every live pane,
                    # so the hook renumbers the survivors to a dense
                    # prefix and remaps each pane.
                    n_evict = int(stale.sum())
                    panes2, persist, surv = windowed_evict(
                        ring.export_panes(), persist, stale)
                    ls2 = np.zeros_like(last_seen)
                    ls2[:len(surv)] = last_seen[surv]
                    last_seen = ls2
                    ring.reload(panes2, ring.panes_closed)
                    stats["windows.evicted_slots"] += n_evict
                    bus.inc("windows.evicted_slots", n_evict)
                stats["windows.live_slots"] = int(agg.session.assigned)
                bus.gauge("windows.live_slots", int(agg.session.assigned))
            q = ring.query()
            if win_query_fixup is not None:
                q = win_query_fixup(q, persist)
            out = emit(q)
            stats["windows.ring_live"] = ring.live
            bus.gauge("windows.ring_live", ring.live)
            if telemetry:
                bus.observe("windows.pane_close_ms",
                            (time.perf_counter() - t_h) * 1e3)
            if tracer is not None:
                tracer.instant("pane_close", window=windows,
                               ring_live=ring.live, combines=ring.combines)
            with win_holder["lock"]:
                win_holder["val"] = {"window": windows, "labels": out}
            return out

        close_fn = close_pane if windowed is not None else close_window
        # One staging ring a shard, each copying to its shard's device.
        consumers = [torch.cuda.current_stream(d) if d.type == "cuda"
                     else None for d in devices]
        rings = [PinnedRing(d, h2d_depth + 1, c)
                 for d, c in zip(devices, consumers)]

        def put_shards(parts, fields_skip):
            out = [ring.put(p, fields_skip) for ring, p in zip(rings, parts)]
            stats["h2d_bytes"] = sum(r.bytes for r in rings)
            return [d for d, _ in out], [e for _, e in out]

        def wait_copies(events):
            for consumer, event in zip(consumers, events):
                if event is not None:
                    consumer.wait_event(event)  # on the device

        def to_device(parts, fields_skip):
            with timer("h2d"):
                devs, events = put_shards(parts, fields_skip)
            wait_copies(events)
            return devs

        if window_ms is not None:
            # Event-time windows: the shared tumbling iterator masks each
            # chunk to one window; one chunk a unit, folded inline.
            # Counted from the stream's first chunk: the resumed prefix is
            # read and dropped here.
            chunks_consumed = 0

            def counted_chunks():
                nonlocal chunks_consumed
                for chunk in prefetch(iter(stream), prefetch_depth,
                                      name="gelly-window"):
                    # Checkpoints fire here, at chunk boundaries: every
                    # edge of the chunks counted so far is in the locals,
                    # the global or the reorder buffer.
                    if chunks_consumed > skip_until:
                        maybe_checkpoint()
                    chunks_consumed += 1
                    stats["chunks"] = chunks_consumed
                    if chunks_consumed <= skip_until:
                        continue
                    if wm is not None:
                        wm.stamp("stream", chunks_consumed - 1)
                    yield chunk

            win_seq = 0
            wm_unit = 0  # span unit id (window mode is consumer-serial)
            try:
                for kind, w, chunk, _ in tumbling_window_events(
                        counted_chunks(), window_ms, stats,
                        initial_window=current_window,
                        allowed_lateness=allowed_lateness,
                        state_handle=lat_handle, initial_state=lat_state):
                    if kind == "close":
                        t_merge = tracer.now() if tracer is not None else 0.0
                        t_h = time.perf_counter() if telemetry else 0.0
                        with timer("merge_emit"):
                            out = close_window()
                        if telemetry:
                            bus.observe("engine.merge_emit_ms",
                                        (time.perf_counter() - t_h) * 1e3)
                            wm.retire_fold("stream", chunks_consumed,
                                           bus=bus, prefix="engine")
                        if tracer is not None:
                            tracer.span("merge_emit", "merge_emit", t_merge,
                                        window=windows)
                        publish_watermarks()
                        yield out
                        continue
                    current_window = w
                    if use_codec:
                        # On a mesh the masked chunk splits into S host
                        # slices, one payload row a shard.
                        t0 = tracer.now() if tracer is not None else 0.0
                        with timer("ingest_compress"):
                            parts = (split_chunk_host(chunk, S) if S > 1
                                     else [chunk])
                            payloads = [agg.host_compress(c) for c in parts]
                            if agg.stack_payloads is None:
                                stacked = _stack_tree(payloads)
                            elif agg.stack_ordered:
                                stacked = agg.stack_payloads(payloads, S,
                                                             seq=win_seq)
                                win_seq += 1
                            else:
                                stacked = agg.stack_payloads(payloads, S)
                        if tracer is not None:
                            tracer.span("compress", "compress/window", t0,
                                        unit=wm_unit, window=int(w),
                                        payload_bytes=_payload_nbytes(
                                            [stacked]))
                            t0 = tracer.now()
                        units = to_device(shard_payloads(stacked),
                                          frozenset())
                        if tracer is not None:
                            tracer.span("h2d", "h2d/slot0", t0, unit=wm_unit,
                                        slot=0)
                            t0 = tracer.now()
                        t_h = time.perf_counter() if telemetry else 0.0
                        with timer("fold_dispatch"):
                            locals_ = [agg.fold_compressed(l, u)
                                       for l, u in zip(locals_, units)]
                    else:
                        units = to_device(shard_chunk(chunk), skip)
                        t0 = tracer.now() if tracer is not None else 0.0
                        t_h = time.perf_counter() if telemetry else 0.0
                        with timer("fold_dispatch"):
                            locals_ = [agg.fold(l, u)
                                       for l, u in zip(locals_, units)]
                    if telemetry:
                        bus.observe("engine.fold_dispatch_ms",
                                    (time.perf_counter() - t_h) * 1e3)
                    if tracer is not None:
                        tracer.span("fold", "fold", t0, unit=wm_unit,
                                    window=int(w))
                    wm_unit += 1
                    del units
                    stats["units"] += 1
                    dirty = True
                # The iterator closed the final window; make it durable.
                if checkpoint_path and windows:
                    maybe_checkpoint(force=True)
            finally:
                # Stage accounting lands on the bus on ANY exit.
                timer.publish(bus)
            return

        identity_payload = None
        if use_codec:
            from ..core.chunk import make_chunk

            identity_payload = agg.host_compress(make_chunk(
                np.zeros(0, np.int64), np.zeros(0, np.int64), capacity=1,
                device=None))

        def produced_units():
            seq = 0
            group: list = []
            it = iter(stream)
            t_unit = tracer.now() if tracer is not None else 0.0
            if skip_until:
                # Chunks folded before the checkpoint: dropped unstaged.
                with timer("resume_skip"):
                    for _ in itertools.islice(it, skip_until):
                        pass
            for chunk in it:
                group.append(chunk)
                if len(group) == batch:
                    if tracer is not None:
                        tracer.span("produce", "produce", t_unit,
                                    unit=seq, chunks=batch)
                    yield seq, group
                    seq += 1
                    group = []
                    if tracer is not None:
                        t_unit = tracer.now()
            if group:
                if tracer is not None:
                    tracer.span("produce", "produce", t_unit,
                                unit=seq, chunks=len(group))
                yield seq, group

        def stage_unit(unit):
            # The unit's trace context is its seq: the compress span here,
            # the H2D span (buffer slot) and the fold span all carry it.
            seq, group = unit
            if wm is not None:
                # Ingress stamps at staging time, on the exactly-once
                # chunk positions the fold and checkpoint will retire.
                base = skip_until + seq * batch
                for j in range(len(group)):
                    wm.stamp("stream", base + j)
            try:
                faults.inject("codec")
                t0 = tracer.now() if tracer is not None else 0.0
                with timer("ingest_compress"):
                    parts = _stage(seq, group)
                k = len(group)
                edges = None
                if tracer is not None:
                    edges = _group_edges(group)
                    tracer.span(
                        "compress",
                        f"compress/{threading.current_thread().name}",
                        t0, unit=seq, chunks=k, edges=edges,
                        payload_bytes=_payload_nbytes(parts),
                        queue_depth=bus.gauges.get(
                            "pipeline.staged_depth", 0),
                    )
                return parts, k, seq, edges
            except BaseException:
                # Release the unit's ordered turn so the units parked
                # behind it unwind; the error reaches the consumer.
                if agg.stack_ordered and agg.on_stage_error is not None:
                    agg.on_stage_error(seq)
                raise

        def _stage(seq, group):
            k = len(group)
            if use_codec:
                payloads = [agg.host_compress(c) for c in group]
                payloads += [identity_payload] * (batch - k)
                if agg.stack_payloads is None:
                    stacked = _stack_tree(payloads)
                elif agg.stack_ordered:
                    stacked = agg.stack_payloads(payloads, S, seq=seq)
                else:
                    stacked = agg.stack_payloads(payloads, S)
                return shard_payloads(stacked)
            if host_precombine is not None:
                group = [host_precombine(c) for c in group]
            if batch == 1:
                return shard_chunk(group[0])
            rows = [c.to_numpy() for c in group]
            zero = EdgeChunk(*(np.zeros_like(f) for f in rows[0]))
            rows += [zero] * (batch - k)
            stacked = EdgeChunk(*(np.stack(fs) for fs in zip(*rows)))
            return [stacked] if S == 1 else _split_stacked(stacked, S)

        def h2d_unit(staged):
            parts, k, seq, edges = staged
            faults.inject("h2d")
            t0 = tracer.now() if tracer is not None else 0.0
            with timer("h2d"):
                devs, events = put_shards(parts, skip)
            if tracer is not None:
                # Slot attribution: which staging buffer this unit took.
                slot = seq % h2d_depth if h2d_depth > 0 else 0
                tracer.span(
                    "h2d", f"h2d/slot{slot}", t0, unit=seq, chunks=k,
                    slot=slot,
                    queue_depth=bus.gauges.get("pipeline.h2d_depth", 0),
                )
            return devs, events, k, seq, edges

        def release(unit):  # a unit cancelled before it ran
            agg.on_stage_error(unit[0])

        pipe_cancel = threading.Event()
        # Queue-depth gauges ride the prefetch enqueue hook only when
        # tracing: the disabled path stays untouched.
        staged_gauge = h2d_gauge = None
        if tracer is not None:
            staged_gauge = lambda d: bus.gauge(  # noqa: E731
                "pipeline.staged_depth", d)
            h2d_gauge = lambda d: bus.gauge(  # noqa: E731
                "pipeline.h2d_depth", d)
        staged = prefetch_map(
            stage_unit, produced_units(), depth=prefetch_depth,
            workers=ingest_workers, cancel=pipe_cancel,
            on_cancel=(release if agg.stack_ordered
                       and agg.on_stage_error is not None else None),
            gauge=staged_gauge)
        transferred = map(h2d_unit, staged)
        if h2d_depth > 0:
            transferred = prefetch(transferred, depth=h2d_depth,
                                   name="gelly-h2d", gauge=h2d_gauge)

        def merge_span(t_merge, t_h, **final):
            # The window close's latency, span (causally linked to the
            # fold frontier) and watermarks.
            if telemetry:
                bus.observe("engine.merge_emit_ms",
                            (time.perf_counter() - t_h) * 1e3)
            if tracer is not None:
                mctx = tracer.ctx(("fold", chunks_consumed))
                mlink = ({"trace": mctx[0], "parent": mctx[1]}
                         if mctx is not None else {})
                tracer.span("merge_emit", "merge_emit", t_merge,
                            window=windows, **final, **mlink)
            publish_watermarks()

        in_window = 0
        try:
            for units, events, k, seq, edges in transferred:
                t_fold = tracer.now() if tracer is not None else 0.0
                t_h = time.perf_counter() if telemetry else 0.0
                with timer("fold_dispatch"):
                    wait_copies(events)
                    locals_ = [fold_unit(l, u)
                               for l, u in zip(locals_, units)]
                del units
                dirty = True
                # Last-retired-chunk rule: a chunk counts toward the
                # checkpoint position once its fold is dispatched.
                chunks_consumed += k
                stats["units"] += 1
                stats["chunks"] = chunks_consumed
                bus.inc("engine.units_folded")
                bus.inc("engine.chunks_folded", k)
                if telemetry:
                    bus.observe("engine.fold_dispatch_ms",
                                (time.perf_counter() - t_h) * 1e3)
                    staged_hw = max(staged_hw, bus.gauges.get(
                        "pipeline.staged_depth", 0))
                    wm.retire_fold("stream", chunks_consumed,
                                   bus=bus, prefix="engine")
                if tracer is not None:
                    # Causal link: the unit's first position may carry a
                    # staging context onto the fold span, and the fold
                    # frontier is re-bound under its own key for the
                    # covering checkpoint or merge.
                    fctx = tracer.ctx(chunks_consumed - k)
                    fold_sid = tracer.next_span_id()
                    link = ({"trace": fctx[0], "parent": fctx[1]}
                            if fctx is not None else {})
                    tracer.span("fold", "fold", t_fold, unit=seq,
                                chunks=k, edges=edges, span=fold_sid,
                                **link, **fold_attrs)
                    tracer.bind_ctx(
                        ("fold", chunks_consumed),
                        fctx[0] if fctx is not None else tracer.trace_id,
                        fold_sid)
                    if edges:
                        meter.record(edges)
                        bus.inc("engine.edges_folded", edges)
                        meter.publish(bus, prefix="engine.throughput")
                    if hb is not None and hb.due():
                        # due() guards the field building: a unit's
                        # heartbeat cost is one clock compare.
                        hb.tick(
                            position=chunks_consumed,
                            eps=meter.snapshot()["edges_per_sec"],
                            windows=windows,
                            staged_depth=bus.gauges.get(
                                "pipeline.staged_depth", 0),
                            h2d_depth=bus.gauges.get(
                                "pipeline.h2d_depth", 0),
                            staged_hw=staged_hw,
                            fold_p99_ms=round(bus.quantile(
                                "engine.fold_dispatch_ms", 0.99), 3),
                            backlog_age_max_s=round(
                                bus.watermarks.max_backlog_age(), 3),
                            slo_breaching=int(bus.gauges.get(
                                "slo.breaching", 0)),
                        )
                        staged_hw = 0
                in_window += k
                if in_window >= merge_every:
                    in_window = 0
                    t_merge = tracer.now() if tracer is not None else 0.0
                    t_h = time.perf_counter() if telemetry else 0.0
                    with timer("merge_emit"):
                        out = close_fn()
                    merge_span(t_merge, t_h)
                    yield out
                maybe_checkpoint()
            if in_window:
                t_merge = tracer.now() if tracer is not None else 0.0
                t_h = time.perf_counter() if telemetry else 0.0
                with timer("merge_emit"):
                    out = close_fn()
                merge_span(t_merge, t_h, final=True)
                yield out
                maybe_checkpoint(force=True)
        finally:
            # Tear down outermost-first on any exit. The event goes first:
            # the H2D thread may be parked inside ``staged`` on a stalled
            # source, where a generator close cannot reach it.
            pipe_cancel.set()
            close = getattr(transferred, "close", None)
            if close is not None:
                close()
            deadline = time.monotonic() + 2.0
            while True:
                try:
                    staged.close()
                    break
                except ValueError:  # still executing on the H2D thread
                    if time.monotonic() >= deadline:
                        break
                    time.sleep(0.01)
            if agg.ordered_wait_s is not None:
                timer.reattribute("ingest_compress", "codec_wait",
                                  agg.ordered_wait_s() - wait0)
            # Stage accounting lands on the bus at teardown, so tests
            # read busy seconds without holding the timer object.
            timer.publish(bus)

    out_stream = (WindowedStream(gen, win_holder) if windowed is not None
                  else SummaryStream(gen))
    out_stream.timer = timer
    out_stream.stats = stats
    if fused:
        from .multiquery import MultiQueryStream

        out_stream = MultiQueryStream(out_stream, agg)
    return out_stream
