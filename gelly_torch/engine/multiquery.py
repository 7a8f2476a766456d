"""Fused multi-query execution: one shared ingest leg, Q questions.

Counterpart of ``gelly_tpu/engine/multiquery.py``. :func:`fuse` composes Q
heterogeneous :class:`~gelly_torch.engine.aggregation.SummaryAggregation`
plans into one :class:`MultiQueryPlan`, itself a ``SummaryAggregation``
whose summary is a dict of per-query summaries plus the fold-step counter
leaf ``"_step"`` (a 0-d ``int64`` tensor). The fused fold applies every
query's fold to the same chunk, so each chunk is produced, staged and
copied to the device once, whatever Q (``run_aggregation(queries=[...])``
or ``stream.aggregate(None, queries=[...])``).

- **Per-query merge windows.** A non-accumulating query (the spanner,
  whose cross-window merge is the reference's ``CombineSpanners``) carries
  ``{"local", "global"}`` sub-state; its ``combine(local, global)`` fires
  when its own ``QuerySpec.every`` window closes, after which ``local``
  restarts from ``init()``. ``gelly_tpu`` computes that combine on every
  chunk and selects it with ``jnp.where``; the port's spanner combines
  update their larger argument in place, so a combine computed but not
  selected would corrupt the state. The port branches on the host
  instead: the step is mirrored on the host (read back from the ``_step``
  leaf once after a resume), and the combine runs only at a boundary. The
  merge-on-read of an emission combines copies, so neither a fold off a
  boundary nor a ``transform`` changes a bit of the state.
- **Checkpoints.** The fused state is one tree, so the engine's
  exactly-once checkpoint holds every query's leaves and the step in one
  file at one position, in ``gelly_tpu``'s leaf order (dict keys sorted):
  either package resumes the other's file.
- **Live snapshots** (:class:`MultiQueryStream`): per-query host copies of
  the last closed window's emission, one merge window stale at most.

Fusion refuses, with ``gelly_tpu``'s messages: ordered stackers
(``stack_ordered``), ``transient`` plans, pane rings, host-side transforms
(``jit_transform=False``), mismatched ``slot_capacity``, ``every`` > 1 on
an accumulating plan, empty, reserved, duplicate or nested names, and
``requires_codec`` plans the shared codec does not cover.

**The shared codec.** When every query supplies a stateless ingest codec
(``host_compress`` + ``fold_compressed``) and accumulates, the fused plan
compresses each chunk once into ``{query_name: payload}`` and folds every
query's payload in the one fused fold (build the sub-queries with the
``*_query`` builders' ``compressed=True``). ``share_codec`` forces the
choice: ``True`` refuses a set the codec cannot cover, ``False`` pins the
raw fold, ``"auto"`` engages when eligible.

The ``multiquery.*`` counters go to the ``obs`` bus under
``gelly_tpu``'s names, and the stream's ``stats`` keeps a view of them;
with a tracer installed, every window adds one span a query on its
``multiquery/<name>`` track, and the engine's fold spans name the
queries riding each dispatch.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple

import torch

from ..core.chunk import EdgeChunk
from ..core.device import DEFAULT_DEVICE, resolve_device, to_numpy
from ..obs import bus as obs_bus
from ..obs import tracing as obs_tracing
from .aggregation import (
    SummaryAggregation,
    SummaryStream,
    _clone_tree,
    _copying,
    _stack_tree,
)
from .checkpoint import to_host, tree_flatten, tree_map

# Reserved leaf: the fused fold's chunk counter (drives the per-query merge
# windows; rides the checkpoint like any other leaf).
STEP_KEY = "_step"


class QuerySpec(NamedTuple):
    """One query riding the fused plan.

    - ``name`` — key of this query's summary and emission in the fused
      dicts (unique a plan; ``"_step"`` is reserved);
    - ``agg`` — the query's ``SummaryAggregation``;
    - ``every`` — merge-window cadence in chunks of a non-accumulating
      plan (its ``combine(local, global)`` fires on every ``every``-th
      fused fold); 1 for accumulating plans;
    - ``slot_capacity`` — the declared vertex slot space; ``fuse`` refuses
      to mix different ones (the queries read the same chunk).
    """

    name: str
    agg: SummaryAggregation
    every: int = 1
    slot_capacity: int | None = None

    @property
    def accum(self) -> bool:
        return self.agg.fold_accumulates and not self.agg.transient


@dataclasses.dataclass(eq=False)
class MultiQueryPlan(SummaryAggregation):
    """The fused plan built by :func:`fuse`: ``queries`` holds the
    normalized :class:`QuerySpec` tuple; ``stats`` is the dict the shared
    codec counts ``multiquery.compressed_chunks`` into (the running
    :class:`MultiQueryStream` points it at its own ``stats``)."""

    queries: tuple = ()
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def query_names(self) -> tuple:
        return tuple(q.name for q in self.queries)


def _as_spec(q) -> QuerySpec:
    if isinstance(q, QuerySpec):
        return q
    if isinstance(q, SummaryAggregation):
        return QuerySpec(name=q.name, agg=q)
    if isinstance(q, tuple) and len(q) == 2:
        return QuerySpec(name=q[0], agg=q[1])
    raise ValueError(
        f"cannot fuse {type(q).__name__}: pass a QuerySpec, a "
        "SummaryAggregation, or a (name, aggregation) pair"
    )


def _check_specs(specs: list) -> None:
    """``gelly_tpu``'s per-query refusals, in its order."""
    seen: set = set()
    caps: dict = {}
    for q in specs:
        if not isinstance(q.agg, SummaryAggregation):
            raise ValueError(
                f"query {q.name!r}: agg must be a SummaryAggregation, "
                f"got {type(q.agg).__name__}"
            )
        if isinstance(q.agg, MultiQueryPlan):
            raise ValueError(
                f"query {q.name!r} is already a fused MultiQueryPlan — "
                "pass its sub-queries instead of nesting fusions"
            )
        if not q.name or q.name == STEP_KEY:
            raise ValueError(
                f"query name {q.name!r} is empty or reserved "
                f"({STEP_KEY!r} is the fused step-counter leaf)"
            )
        if q.name in seen:
            raise ValueError(f"duplicate query name {q.name!r}")
        seen.add(q.name)
        if q.agg.stack_ordered:
            raise ValueError(
                f"query {q.name!r} ({q.agg.name}) uses an ordered "
                "stacker (stack_ordered: its codec session assigns "
                "compact ids in GLOBAL STREAM order); the fused "
                "shared-compress stage compresses every query from the "
                "same chunk with no cross-query ordering to offer — "
                "build the query on a stateless codec (codec='sparse') "
                "or the raw fold (ingest_combine=False)"
            )
        if q.agg.transient:
            raise ValueError(
                f"query {q.name!r} ({q.agg.name}) is transient "
                "(emit-and-reset windows); the fused accumulate plan "
                "has no per-window Merger to reset through — un-fusable"
            )
        windowed_panes = getattr(q.agg, "windowed_panes", None)
        if windowed_panes is not None:
            raise ValueError(
                f"query {q.name!r} ({q.agg.name}) carries a pane ring "
                f"(windowed_panes={windowed_panes}): the ring's "
                "two-stack suffix aggregation and TTL session rebuilds "
                "are single-stream host structures the shared fused "
                "fold cannot mask per query — run the windowed query "
                "as its own stream (windowed= on run_aggregation)"
            )
        if q.agg.transform is not None and not q.agg.jit_transform:
            raise ValueError(
                f"query {q.name!r} ({q.agg.name}) uses a host-side "
                "transform (jit_transform=False); fused emissions are "
                "one jitted dict program — un-fusable"
            )
        if not isinstance(q.every, int) or q.every < 1:
            raise ValueError(
                f"query {q.name!r}: every must be an int >= 1, got "
                f"{q.every!r}"
            )
        if q.accum and q.every != 1:
            raise ValueError(
                f"query {q.name!r} ({q.agg.name}) accumulates "
                "(fold_accumulates); it has no merge window to defer — "
                "every must be 1"
            )
        if q.slot_capacity is not None:
            caps[q.name] = int(q.slot_capacity)
    if len(set(caps.values())) > 1:
        raise ValueError(
            "mismatched chunk schemas: fused queries read the SAME "
            "shared chunk but declare different slot capacities "
            f"({caps}) — a query built for a smaller slot space would "
            "silently mis-index it (JAX clamps out-of-range ids)"
        )


def _use_codec(specs: tuple, share_codec) -> bool:
    """Whether the shared compress stage engages (``gelly_tpu``'s rule and
    refusals)."""
    capable = [q for q in specs if q.agg.host_compress is not None
               and q.agg.fold_compressed is not None]
    codec_ok = len(capable) == len(specs) and all(q.accum for q in specs)
    use = codec_ok and share_codec in ("auto", True)
    if share_codec is True and not codec_ok:
        raise ValueError(
            "share_codec=True but the shared compress stage cannot "
            "cover this set: every query must supply host_compress + "
            "fold_compressed AND accumulate (codec-capable: "
            f"{[q.name for q in capable]} of "
            f"{[q.name for q in specs]}; non-accumulating: "
            f"{[q.name for q in specs if not q.accum]}) — build the "
            "sub-queries with compressed=True, or drop share_codec"
        )
    codec_only = [q.name for q in specs if q.agg.requires_codec]
    if codec_only and not use:
        raise ValueError(
            f"queries {codec_only} fold ONLY through their ingest "
            "codec (requires_codec) but the fused shared-compress "
            "stage is not engaged here"
            + (" (share_codec=False pins the raw path)"
               if share_codec is False else
               ": every fused query must be codec-capable and "
               "accumulating for it to engage")
            + " — their raw fold does not exist, so the set is "
            "un-fusable as-is"
        )
    return use


def _device_fields(specs: tuple):
    """The union of the queries' raw-fold chunk fields (in chunk order), or
    None when any query reads every field."""
    wanted: set = set()
    for q in specs:
        if q.agg.device_fields is None:
            return None
        wanted.update(q.agg.device_fields)
    return tuple(f for f in EdgeChunk._fields if f in wanted)


def fuse(queries, *, name: str | None = None,
         share_codec="auto") -> MultiQueryPlan:
    """Stack Q heterogeneous aggregations into one fused plan.

    ``queries`` — :class:`QuerySpec`\\ s, ``SummaryAggregation``\\ s or
    ``(name, aggregation)`` pairs. The plan's fold advances every query
    from the same chunk; run it through ``run_aggregation(queries=...)``,
    which wraps the emissions in a :class:`MultiQueryStream`.
    ``share_codec`` is the shared-codec knob (module docs).
    """
    # Identity checks, not membership: 1 == True under `in`.
    if not (share_codec is True or share_codec is False
            or share_codec == "auto"):
        raise ValueError(
            f"share_codec must be 'auto', True or False, got "
            f"{share_codec!r}"
        )
    specs = [_as_spec(q) for q in queries]
    if not specs:
        raise ValueError("fuse needs at least one query")
    _check_specs(specs)
    specs = tuple(specs)
    plan_name = name or "multiquery(" + "+".join(q.name for q in specs) + ")"
    use_codec = _use_codec(specs, share_codec)
    merging = [q for q in specs if not q.accum]
    # The host mirror of the one running state's step: (tensor, value).
    # A state whose step tensor is not the mirrored one (a resumed or
    # converted state) is read back once.
    mirror: list = [None, 0]

    def host_step(t: torch.Tensor) -> int:
        if mirror[0] is not t:
            mirror[0], mirror[1] = t, int(t)
        return mirror[1]

    def init(device=DEFAULT_DEVICE) -> dict:
        dev = resolve_device(device)
        st: dict = {STEP_KEY: torch.zeros((), dtype=torch.int64, device=dev)}
        for q in specs:
            if q.accum:
                st[q.name] = q.agg.init(dev)
            else:
                st[q.name] = {"local": q.agg.init(dev),
                              "global": q.agg.init(dev)}
        return st

    def fold(state, chunk):
        t = state[STEP_KEY]
        out: dict = {STEP_KEY: t + 1}
        if merging:
            step = host_step(t) + 1
            mirror[0], mirror[1] = out[STEP_KEY], step
        for q in specs:
            if q.accum:
                out[q.name] = q.agg.fold(state[q.name], chunk)
                continue
            sub = state[q.name]
            local = q.agg.fold(sub["local"], chunk)
            if step % q.every == 0:
                # The query's merge window closes: merge, then restart the
                # window from a fresh summary. Off a boundary nothing runs,
                # where gelly_tpu computes the merge and masks it away.
                out[q.name] = {
                    "local": q.agg.init(t.device),
                    "global": q.agg.combine(local, sub["global"]),
                }
            else:
                out[q.name] = {"local": local, "global": sub["global"]}
        return out

    def combine(a, b):
        # Cross-shard merge of fused states, query by query: sound for
        # accumulating queries, the only ones the engine admits at S > 1.
        out: dict = {STEP_KEY: torch.maximum(a[STEP_KEY], b[STEP_KEY])}
        for q in specs:
            if q.accum:
                out[q.name] = q.agg.combine(a[q.name], b[q.name])
            else:
                out[q.name] = {
                    "local": q.agg.combine(a[q.name]["local"],
                                           b[q.name]["local"]),
                    "global": q.agg.combine(a[q.name]["global"],
                                            b[q.name]["global"]),
                }
        return out

    copying = {q.name: _copying(q.agg.combine) for q in merging}

    def transform(state):
        out: dict = {}
        for q in specs:
            if q.accum:
                view = state[q.name]
                if q.agg.transform is None:
                    # The running summary itself: the emission must not
                    # change when later folds run (gelly_tpu's
                    # transform_may_alias).
                    out[q.name] = _clone_tree(view)
                    continue
            else:
                # Merge-on-read, on copies: the emission includes the
                # window's tail, and the state stays as it was (at a
                # boundary local is fresh and combine(init, g) == g).
                view = copying[q.name](state[q.name]["local"],
                                       state[q.name]["global"])
            out[q.name] = (q.agg.transform(view)
                           if q.agg.transform is not None else view)
        return out

    fused_host_compress = fused_stack_payloads = None
    fused_fold_compressed = fused_payload_check = None
    if use_codec:
        count_lock = threading.Lock()  # codec workers count concurrently

        def fused_host_compress(chunk):
            # One multi-query payload a chunk. The engine's empty identity
            # chunk is not a stream chunk: it is not counted.
            if bool(to_numpy(chunk.valid).any()):
                obs_bus.get_bus().inc("multiquery.compressed_chunks")
                with count_lock:
                    st = plan.stats
                    st["multiquery.compressed_chunks"] = st.get(
                        "multiquery.compressed_chunks", 0) + 1
            return {q.name: q.agg.host_compress(chunk) for q in specs}

        def fused_stack_payloads(payloads: list, groups: int = 1) -> dict:
            out: dict = {}
            for q in specs:
                subs = [p[q.name] for p in payloads]
                out[q.name] = (q.agg.stack_payloads(subs, groups)
                               if q.agg.stack_payloads is not None
                               else _stack_tree(subs))
            return out

        def fused_payload_check(payload):
            missing = [q.name for q in specs
                       if not isinstance(payload, dict)
                       or q.name not in payload]
            if missing:
                raise ValueError(
                    f"fused compressed payload is missing per-query "
                    f"sub-payloads {missing} — was it compressed by a "
                    "different fused plan?"
                )
            for q in specs:
                fn = q.agg.codec_payload_check
                if fn is not None:
                    fn(payload[q.name])

        def fused_fold_compressed(state, payload):
            # A unit of stacked payloads ([K, ...] leaves). The step
            # advances by the unit's widest per-query batch, as
            # gelly_tpu's does (no merge window keys off it here).
            k = max(tree_flatten(payload[q.name])[0][0].shape[0]
                    for q in specs)
            out = {STEP_KEY: state[STEP_KEY] + k}
            for q in specs:
                out[q.name] = q.agg.fold_compressed(state[q.name],
                                                    payload[q.name])
            return out

    fused_flatten = None
    if any(q.agg.flatten is not None for q in specs):
        def fused_flatten(state):
            out: dict = {STEP_KEY: state[STEP_KEY]}
            for q in specs:
                f = q.agg.flatten
                if f is None:
                    out[q.name] = state[q.name]
                elif q.accum:
                    out[q.name] = f(state[q.name])
                else:
                    out[q.name] = {"local": f(state[q.name]["local"]),
                                   "global": f(state[q.name]["global"])}
            return out

    codec_only = any(q.agg.requires_codec for q in specs)
    plan = MultiQueryPlan(
        init=init,
        fold=fold,
        combine=combine,
        transform=transform,
        flatten=fused_flatten,
        host_compress=fused_host_compress,
        fold_compressed=fused_fold_compressed,
        stack_payloads=fused_stack_payloads,
        codec_payload_check=fused_payload_check,
        requires_codec=use_codec and codec_only,
        device_fields=_device_fields(specs),
        # One accumulating summary to the engine: per-query windows run
        # inside the fold.
        fold_accumulates=True,
        transient=False,
        fold_backend="fused",
        merge_mode="replicated",
        name=plan_name,
        queries=specs,
    )
    return plan


class MultiQueryStream(SummaryStream):
    """Emission stream of a fused run, with live per-query snapshots.

    Iterating yields the fused emission dict (``{query_name: emission}``)
    once per closed window. :meth:`snapshot` answers from the last yielded
    window, from any thread; the lock is held only for the reference swap.
    The ``multiquery.*`` counters (``runs``, ``emissions``,
    ``snapshot_reads``, ``compressed_chunks``), the ``fused_queries``
    gauge and the ``emit_ms`` histogram (each window's snapshot
    publication, lock wait and swap, in ms; recorded with a tracer or
    recording on) go to the bus. ``stats`` is the engine's, plus a view
    of the same counters and every ``emit_ms`` sample as a list.
    """

    def __init__(self, inner: SummaryStream, plan: MultiQueryPlan):
        self._inner = inner
        self.plan = plan
        self._lock = threading.Lock()
        self._latest = None
        self._window = 0
        super().__init__(self._gen)
        self.stats = inner.stats
        self.timer = inner.timer
        for key in ("runs", "emissions", "snapshot_reads",
                    "compressed_chunks"):
            self.stats.setdefault(f"multiquery.{key}", 0)
        self.stats.setdefault("multiquery.emit_ms", [])
        plan.stats = self.stats

    def _gen(self):
        # Bound once per run, as the engine binds its own.
        bus = obs_bus.get_bus()
        tracer = obs_tracing.active_tracer()
        telemetry = obs_bus.telemetry_on()
        names = self.plan.query_names
        stats = self.stats
        stats["multiquery.fused_queries"] = len(names)
        stats["multiquery.runs"] += 1
        bus.gauge("multiquery.fused_queries", len(names))
        bus.inc("multiquery.runs")
        it = iter(self._inner)
        while True:
            t0 = tracer.now() if tracer is not None else 0.0
            try:
                out = next(it)
            except StopIteration:
                return
            t = time.perf_counter()
            with self._lock:
                self._latest = out
                self._window += 1
                w = self._window
            emit_ms = (time.perf_counter() - t) * 1e3
            stats["multiquery.emit_ms"].append(emit_ms)
            if telemetry:
                bus.observe("multiquery.emit_ms", emit_ms)
            stats["multiquery.emissions"] += len(names)
            bus.inc("multiquery.emissions", len(names))
            if tracer is not None:
                # One span a query a window on its own multiquery/<name>
                # track, covering the window's wall: the trace shows the
                # one compress/H2D/fold pipeline feeding Q query tracks.
                for n in names:
                    tracer.span("multiquery", f"multiquery/{n}", t0,
                                query=n, window=w)
            yield out

    def snapshot(self, query: str | None = None):
        """Host numpy copy of the named query's last-window emission (the
        whole ``{name: emission}`` dict with ``query=None``); ``None``
        before the first window closes."""
        with self._lock:
            latest = self._latest
            if latest is not None:
                self.stats["multiquery.snapshot_reads"] += 1
        if latest is None:
            return None
        obs_bus.get_bus().inc("multiquery.snapshot_reads")
        if query is None:
            return {n: tree_map(to_host, latest[n])
                    for n in self.plan.query_names}
        if query not in latest:
            raise ValueError(
                f"unknown query {query!r} (fused: "
                f"{list(self.plan.query_names)})"
            )
        return tree_map(to_host, latest[query])

    def snapshot_window(self) -> int:
        """The window :meth:`snapshot` answers from (0: none closed yet),
        the staleness handle."""
        with self._lock:
            return self._window


def run_multiquery(queries, stream, **runner_kw) -> MultiQueryStream:
    """``run_aggregation(None, stream, queries=queries, **runner_kw)``: one
    shared ingest leg, every query answered a chunk."""
    from .aggregation import run_aggregation

    return run_aggregation(None, stream, queries=queries, **runner_kw)
