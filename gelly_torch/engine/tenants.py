"""Multi-tenant serving engine: one scheduling round advances N streams.

Counterpart of ``gelly_tpu/engine/tenants.py``. A service multiplexing many
independent graph streams (one per tenant or session) onto one card
shares the device, the host-to-device copy and the plan across tenants,
the way the reference lets Flink multiplex many jobs onto shared slots.

- **Tenant batching** (:class:`TenantBatch`): per-tenant summaries are
  stacked along a leading tenant axis (``[lanes, ...]`` leaves, as
  ``gelly_tpu``'s) and folded by the tier's
  :class:`~gelly_torch.engine.aggregation.TenantPlan`
  (:func:`~gelly_torch.engine.aggregation._compiled_tenant_plan`). Where
  the plan has a lane-offset form (CC's generic raw and codec folds, the
  degree plan) one call folds every lane of a shard; otherwise (CC's
  dedup fold, fused multi-query plans) each active lane folds its own row
  views. ``gelly_tpu`` runs one ``jax.vmap``-ed dispatch either way; the
  chosen form is on ``TenantPlan.forms``. Lane widths grow by doubling.
- **Capacity tiers**: tenants are admitted into named tiers, each one
  ``SummaryAggregation`` plan (its ``vertex_capacity`` is the tier's
  capacity class) and one chunk capacity.
- **Fair-share windowing** (:class:`MultiTenantEngine`): per-tenant chunk
  queues; every scheduling round advances each backlogged tenant by at
  most one chunk, and a tenant with nothing pending is a MASKED lane whose
  rows stay bit-unchanged. ``tenants.starved_windows`` counts live-tenant
  lanes that went masked in a round.
- **Staging**: each round's chunks (or payloads) are stacked on the host
  into pinned memory and moved to the device in ONE copy
  (:class:`_LaneStager`, two buffers used in turn).
- **Compressed tiers** (``add_tier(..., compressed=True)``): lanes fold
  PRE-COMPRESSED codec payloads (compressed once, at the producer, via
  :meth:`MultiTenantEngine.submit_payload` or a payload source) through
  the tier's ``fold_codec``; variable-length payload keys pad to a shared
  power-of-two bucket. Snapshots are bit-identical to the raw tier's.
- **Per-tenant exactly-once checkpoints**: each tenant's lane is saved
  through its own :class:`~gelly_torch.engine.resilience.CheckpointManager`
  rotation (``prefix=tenant_prefix(tid)`` in one shared directory), in the
  checkpoint format both packages read. The recorded position is the
  tenant's last DISPATCHED chunk at a window close.
- **Live queries** (:meth:`MultiTenantEngine.query` /
  :meth:`~MultiTenantEngine.labels`): answered from the last merge-window
  snapshot (the plan's ``transform``, or a copy for transform-less
  plans), made ready on the device (its stream synchronized) before the
  reference swap, which is the only thing a query waits for; staleness is
  one merge window.
- **QoS** (``qos=``, :mod:`~gelly_torch.engine.qos`): weighted fair share,
  admission control, and the limit, park, unpark and shed ladder; parked
  and evicted tenants keep answering from host copies of their rows.

The fold loop runs inline (:meth:`~MultiTenantEngine.drain`) or on a
scheduler thread (:meth:`~MultiTenantEngine.start`). Locks, taken in this
order: the table lock ``_lock``, then ``_dispatch_lock``, then the QoS
controller's leaf lock. The engine publishes ``gelly_tpu``'s ``tenants.*``
and ``qos.*`` names on the obs bus.

Entry points run on the card unless the caller passes ``device="cpu"``
(the tier state lives on that device, or on a mesh's first device).
"""

from __future__ import annotations

import logging
import threading
import time as _time
from collections import deque
from typing import Any, Iterator

import numpy as np
import torch

from ..core.chunk import EdgeChunk
from ..core.device import DEFAULT_DEVICE, resolve_device, to_numpy
from ..obs import bus as obs_bus
from ..obs import tracing as obs_tracing
from .aggregation import (
    SummaryAggregation,
    _compiled_tenant_plan,
    _flatten,
)
from .checkpoint import to_host, tree_flatten, tree_map
from .qos import (
    QOS_LIMITED,
    QOS_OK,
    QOS_PARKED,
    QOS_SHED,
    AdmissionRefused,
    QosController,
)

logger = logging.getLogger("gelly_torch.tenants")


# The serving-plane telemetry guard (histograms + e2e watermarks), the one
# shared definition in obs.bus.
_telemetry_on = obs_bus.telemetry_on


def tenant_prefix(tenant_id) -> str:
    """Injective, filesystem-safe checkpoint prefix for a tenant id.

    Every character outside ``[A-Za-z0-9_]`` percent-escapes (``%`` is
    itself escaped, so the map is injective), which keeps the prefix
    free of ``-`` — the rotation separator ``CheckpointManager`` splits
    file names on. Without this, ids "7" and "7-0" would glob into
    each other's rotations."""
    s = str(tenant_id)
    return "t" + "".join(
        c if (c.isascii() and (c.isalnum() or c == "_"))
        else "%" + "".join(f"{b:02x}" for b in c.encode("utf-8"))
        for c in s
    )


def _normalize_payload(payload):
    """Host-normalize a pre-compressed tenant payload (a codec
    ``host_compress`` output: a dict of arrays or one array) for lane
    stacking."""
    if isinstance(payload, EdgeChunk):
        raise ValueError(
            "got an EdgeChunk on a compressed tier — compressed tiers "
            "fold pre-compressed codec payloads (the plan's "
            "host_compress output); compress at the producer or use a "
            "raw tier (submit())"
        )
    if isinstance(payload, dict):
        out = {}
        for k, v in payload.items():
            arr = to_numpy(v) if isinstance(v, torch.Tensor) \
                else np.asarray(v)
            if arr.dtype == object:
                # np.asarray of e.g. a nested dict "succeeds" as a 0-d
                # object array, which would poison the tier template and
                # fail later on the scheduler thread.
                raise ValueError(
                    f"payload key {k!r} is not an array (got "
                    f"{type(v).__name__}) — compressed tiers take one "
                    "FLAT dict of arrays (a codec host_compress "
                    "output); nested payloads (e.g. a fused multi-"
                    "query codec dict) have no lane-stacking support"
                )
            out[k] = arr
        return out
    arr = to_numpy(payload) if isinstance(payload, torch.Tensor) \
        else np.asarray(payload)
    if arr.dtype == object:
        raise ValueError(
            f"cannot normalize payload of type "
            f"{type(payload).__name__} — expected a dict of arrays or "
            "one ndarray (a codec host_compress output)"
        )
    return arr


def _normalize_chunk(chunk: EdgeChunk, capacity: int) -> EdgeChunk:
    """Host-normalize a tenant chunk (numpy fields) for cross-tenant
    stacking: fixed dtypes for the id columns (folds read the dense
    ``src``/``dst`` slots; ``raw_*`` widths vary by source and are widened
    to i64 so every tenant's chunks stack into one [N, C] batch)."""
    h = EdgeChunk(*(to_numpy(f) for f in chunk))
    if h.src.shape[0] != capacity:
        raise ValueError(
            f"tenant chunk capacity {h.src.shape[0]} != tier chunk "
            f"capacity {capacity} — all tenants of a tier share one "
            "static shape"
        )
    return h._replace(
        src=np.asarray(h.src, np.int32),
        dst=np.asarray(h.dst, np.int32),
        raw_src=np.asarray(h.raw_src, np.int64),
        raw_dst=np.asarray(h.raw_dst, np.int64),
        ts=np.asarray(h.ts, np.int64),
        event=np.asarray(h.event, np.int8),
        valid=np.asarray(h.valid, bool),
        val=np.asarray(h.val),
    )


def _ready(tree) -> None:
    """Wait until every device leaf of ``tree`` is written: synchronize
    the current stream of each CUDA device holding one (the snapshot's
    producer). A no-op on the CPU."""
    seen = set()
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor) and x.device.type == "cuda" \
                and x.device not in seen:
            seen.add(x.device)
            torch.cuda.current_stream(x.device).synchronize()


def _row_host(tree, index, stream=None):
    """Host numpy copy of ``tree``'s leaves at ``index`` (a lane, or a
    lane and a slot), copied on ``stream`` when one is given."""
    if stream is None:
        return tree_map(lambda l: to_numpy(l[index]), tree)
    with torch.cuda.stream(stream):
        return tree_map(lambda l: to_numpy(l[index]), tree)


# Staged arrays start on 16-byte boundaries of the one pinned buffer.
_ALIGN = 16


class _LaneStager:
    """Host-to-device staging of one round's stacked batch.

    :meth:`open` hands out numpy views into ONE pinned host buffer (the
    round's stacked arrays are written straight into them), and
    :meth:`upload` moves the used bytes to the device in ONE copy,
    returning a device tensor view for each array. Two buffers are used
    in turn; before a buffer is written again the thread waits for its
    previous copy. A buffer regrows when a round needs more than it
    holds; :meth:`release` drops both (the tier shrank) so the next round
    allocates at its own size. Off CUDA nothing is copied: the views are
    plain numpy arrays and :meth:`upload` wraps them as CPU tensors.
    """

    def __init__(self, device: torch.device, slots: int = 2):
        self.device = device
        self.cuda = device.type == "cuda"
        self._bufs: list = [None] * slots
        self._events: list = [None] * slots
        self._turn = 0
        self._open = None  # (slot, [(offset, nbytes, shape, dtype)], used)
        self.copies = 0
        self.bytes = 0

    def open(self, specs: list) -> list:
        """Numpy arrays of ``(shape, dtype)`` each, to fill before
        :meth:`upload`."""
        if not self.cuda:
            arrays = [np.empty(shape, dtype) for shape, dtype in specs]
            self._open = arrays
            return arrays
        slot = self._turn % len(self._bufs)
        self._turn += 1
        prev = self._events[slot]
        if prev is not None:
            prev.synchronize()  # the buffer's last copy has left it
        layout, used = [], 0
        for shape, dtype in specs:
            dtype = np.dtype(dtype)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            layout.append((used, nbytes, tuple(shape), dtype))
            used += -(-nbytes // _ALIGN) * _ALIGN
        buf = self._bufs[slot]
        if buf is None or buf.numel() < used:
            buf = torch.empty(max(used + used // 4, _ALIGN),
                              dtype=torch.uint8, pin_memory=True)
            self._bufs[slot] = buf
        host = buf.numpy()
        self._open = (slot, layout, used)
        return [host[o:o + n].view(dt).reshape(shape)
                for o, n, shape, dt in layout]

    def upload(self) -> list:
        """The opened arrays as device tensors (one copy of the buffer)."""
        opened, self._open = self._open, None
        if not self.cuda:
            return [torch.from_numpy(a) for a in opened]
        slot, layout, used = opened
        dev = torch.empty(used, dtype=torch.uint8, device=self.device)
        dev.copy_(self._bufs[slot][:used], non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._events[slot] = event
        self.copies += 1
        self.bytes += used
        return [dev[o:o + n].view(torch.from_numpy(np.empty(0, dt)).dtype)
                .view(shape) for o, n, shape, dt in layout]

    def release(self) -> None:
        for e in self._events:
            if e is not None:
                e.synchronize()
        self._bufs = [None] * len(self._bufs)
        self._events = [None] * len(self._events)


class TenantBatch:
    """Stacked per-tenant summary state for one capacity tier.

    Owns the [lanes, ...]-stacked trees (window locals and, for
    non-accumulate plans, the carried global stack), the
    :class:`~gelly_torch.engine.aggregation.TenantPlan` for the current
    lane width, the round's host staging, and the width-doubling growth
    path: widening initializes a wider stack and copies the existing
    lanes in, so admitted tenants keep their state.
    """

    def __init__(self, agg: SummaryAggregation, chunk_capacity: int,
                 mesh=None, min_lanes: int = 1,
                 compressed: bool = False,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.agg = agg
        self.chunk_capacity = int(chunk_capacity)
        self.mesh = mesh
        self.min_lanes = max(1, int(min_lanes))
        # Compressed tier: lanes fold pre-compressed codec payloads
        # (fold_codec) instead of raw chunks.
        self.compressed = bool(compressed)
        if compressed and (agg.fold_compressed is None
                           or agg.host_compress is None):
            # host_compress is required too: masked lanes fold the
            # codec's identity payload (host_compress of an empty chunk).
            missing = ("fold_compressed" if agg.fold_compressed is None
                       else "host_compress")
            raise ValueError(
                f"aggregation '{agg.name}' has no {missing} — a "
                "compressed tier folds pre-compressed codec payloads "
                "(and pads masked lanes with the codec's identity "
                "payload); build the plan with its ingest codec on "
                "(e.g. ingest_combine=True) or register a raw tier"
            )
        if agg.requires_codec and not compressed:
            raise ValueError(
                f"aggregation '{agg.name}' folds ONLY through its "
                "ingest codec (requires_codec); register the tier with "
                "compressed=True so lanes fold payloads, not raw chunks"
            )
        self.lanes = 0
        self.plan = None
        # The accumulate plan: one running stacked summary, no per-window
        # merger (the single-stream engine's S == 1 specialization).
        self.accum = agg.fold_accumulates and not agg.transient
        self.state = None  # accum: the running stack; else: window locals
        self.global_ = None  # non-accum only: the carried global stack
        from ..parallel.mesh import require_one_process

        require_one_process(mesh, "TenantBatch(mesh=...)")
        self.shards = mesh.num_shards if mesh is not None else 1
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))
        self._stager = _LaneStager(self.device)
        self._zero_chunk: EdgeChunk | None = None
        self._template: EdgeChunk | None = None
        self._payload_template: dict | None = None
        self._identity_payload = None

    def _width_for(self, n: int) -> int:
        want = max(self.min_lanes, n, 1)
        w = 1 << max(0, want - 1).bit_length()
        if self.shards > 1:
            S = self.shards
            w = -(-max(w, S) // S) * S
        return w

    def _plan_for(self, width: int):
        return _compiled_tenant_plan(self.agg, width, mesh=self.mesh,
                                     device=self.device,
                                     chunk_capacity=self.chunk_capacity)

    def ensure_lanes(self, n: int) -> None:
        """Grow the stack to hold ``n`` lanes (pow-2 widths; existing
        lanes copied into the widened stack)."""
        if self.plan is not None and n <= self.lanes:
            return
        width = self._width_for(n)
        plan = self._plan_for(width)
        old_lanes = self.lanes

        def widen(old):
            fresh = plan.init()
            if old is None or old_lanes == 0:
                return fresh
            for f, o in zip(tree_flatten(fresh)[0], tree_flatten(old)[0]):
                f[:old_lanes].copy_(o)
            return fresh

        self.state = widen(self.state)
        if not self.accum:
            self.global_ = widen(self.global_)
        self.plan = plan
        self.lanes = width

    def shrink(self, keep_lanes: list, width: int) -> None:
        """Rebuild the stack at a SMALLER width (idle-lane reclamation):
        row ``keep_lanes[i]`` of the old stack lands in lane ``i``; every
        other lane is dropped — callers snapshot evicted lanes FIRST.
        Shrinking back to a width built before is a plan-cache hit."""
        if width >= self.lanes or width < len(keep_lanes):
            raise ValueError(
                f"shrink width {width} must be < current {self.lanes} "
                f"and >= the {len(keep_lanes)} kept lanes"
            )
        plan = self._plan_for(width)
        idx = torch.as_tensor(np.asarray(keep_lanes, np.int64))

        def compact(old):
            fresh = plan.init()
            if old is None or idx.numel() == 0:
                return fresh
            for f, o in zip(tree_flatten(fresh)[0], tree_flatten(old)[0]):
                f[: idx.numel()].copy_(o[idx.to(o.device)])
            return fresh

        self.state = compact(self.state)
        if not self.accum:
            self.global_ = compact(self.global_)
        self.plan = plan
        self.lanes = width
        self._stager.release()  # the next round stages at the new width

    def set_lane(self, lane: int, host_state) -> None:
        """Overwrite one lane's RUNNING summary from a host tree
        (checkpoint resume, un-park). For non-accumulate plans the
        restored summary is the tenant's carried global; its window
        locals stay fresh."""
        target = self.state if self.accum else self.global_
        for l, h in zip(tree_flatten(target)[0],
                        tree_flatten(host_state)[0]):
            l[lane].copy_(torch.as_tensor(np.asarray(h)))

    def slice_lane(self, lane: int):
        """A copy of one tenant's RUNNING summary (accum: the live stack;
        non-accum: the carried global — call at a window close, when
        locals are freshly merged)."""
        src = self.state if self.accum else self.global_
        return tree_map(lambda l: l[lane].clone(), src)

    def check_template(self, chunk: EdgeChunk) -> None:
        """Validate a normalized chunk against the tier template (the
        first chunk seen sets it). The engine calls this BEFORE a chunk
        is queued, so a mismatch raises to the SUBMITTER, never on the
        scheduler thread."""
        if self._template is None:
            self._template = chunk
            self._zero_chunk = EdgeChunk(
                *(np.zeros_like(f) for f in chunk)
            )
            return
        for name, f, tf in zip(EdgeChunk._fields, chunk, self._template):
            if f.dtype != tf.dtype or f.shape != tf.shape:
                raise ValueError(
                    f"tenant chunk field {name!r} ({f.dtype}{f.shape})"
                    f" differs from the tier template "
                    f"({tf.dtype}{tf.shape}) — tenants of a tier must"
                    " ship identically-shaped chunks"
                )

    def stack_chunks(self, per_lane: list, out: dict | None = None) -> tuple:
        """Host-stack one chunk (or a masked zero chunk) per lane into
        the [lanes, C] batch + the bool[lanes] active mask. ``out`` maps
        field names to arrays the stacked fields are written into (the
        stager's pinned views)."""
        first = next((c for c in per_lane if c is not None), None)
        if first is None:
            raise ValueError("stack_chunks needs at least one live lane")
        for c in per_lane:
            if c is not None:
                self.check_template(c)
        rows = [c if c is not None else self._zero_chunk for c in per_lane]
        rows += [self._zero_chunk] * (self.lanes - len(per_lane))
        out = out or {}
        stacked = EdgeChunk(*(
            np.stack(fs, out=out.get(name))
            for name, fs in zip(EdgeChunk._fields, zip(*rows))))
        active = np.zeros((self.lanes,), bool)
        active[: len(per_lane)] = [c is not None for c in per_lane]
        return stacked, active

    # ------------------------------------------------- compressed tiers

    def _identity(self):
        # The masked-lane filler payload: the plan's own compression of
        # an empty chunk (what the engine pads short codec units with).
        if self._identity_payload is None:
            from ..core.chunk import make_chunk

            empty = make_chunk(
                np.zeros(0, np.int64), np.zeros(0, np.int64),
                capacity=1, device=None,
            )
            self._identity_payload = _normalize_payload(
                self.agg.host_compress(empty)
            )
        return self._identity_payload

    def check_payload_template(self, payload) -> None:
        """Validate a normalized pre-compressed payload against the tier
        template (first payload seen sets it) — raised to the submitter.
        Keys named in the plan's ``codec_pad_values`` may vary in length
        (they pad to a shared bucket at stack time); everything else must
        match shape and dtype exactly."""
        pad = self.agg.codec_pad_values or {}

        bound = 2 * self.chunk_capacity  # two endpoints per edge

        def describe(p):
            if isinstance(p, dict):
                out = {}
                for k, v in p.items():
                    v = np.asarray(v)
                    if k in pad:
                        if v.ndim != 1:
                            raise ValueError(
                                f"payload key {k!r} is declared "
                                "variable-length (codec_pad_values) "
                                f"but has ndim {v.ndim}; lane padding "
                                "covers 1-D wire arrays only"
                            )
                        if v.shape[0] > bound:
                            # One tenant's oversized payload would
                            # otherwise inflate EVERY lane's padded
                            # bucket.
                            raise ValueError(
                                f"payload key {k!r} carries "
                                f"{v.shape[0]} rows > the tier bound "
                                f"of 2 x chunk_capacity = {bound} — "
                                "compress smaller chunks or register "
                                "a larger tier"
                            )
                        out[k] = (v.dtype, None)
                    else:
                        out[k] = (v.dtype, v.shape)
                return out
            v = np.asarray(p)
            return {None: (v.dtype, v.shape)}

        tpl = describe(payload)
        if self._payload_template is None:
            self._payload_template = tpl
            return
        ref = self._payload_template
        if tpl != ref:
            raise ValueError(
                f"tenant payload ({tpl}) differs from the tier "
                f"template ({ref}) — tenants of a compressed tier must "
                "ship payloads from the SAME codec (fixed-shape keys "
                "identical; variable keys are those in the plan's "
                "codec_pad_values)"
            )

    def stack_payloads(self, per_lane: list) -> tuple:
        """Host-stack one pre-compressed payload (or the identity payload
        for masked lanes) per lane into ``[lanes, 1, ...]`` leaves — each
        lane a K=1 batch, so the plan's own ``fold_compressed`` folds it —
        plus the bool[lanes] active mask. Variable-length keys pad to a
        shared power-of-two bucket."""
        first = next((p for p in per_lane if p is not None), None)
        if first is None:
            raise ValueError("stack_payloads needs at least one live lane")
        rows = [p if p is not None else self._identity()
                for p in per_lane]
        rows += [self._identity()] * (self.lanes - len(per_lane))
        active = np.zeros((self.lanes,), bool)
        active[: len(per_lane)] = [p is not None for p in per_lane]
        pad = self.agg.codec_pad_values or {}
        if isinstance(first, dict):
            # The engine's shared variable-length stacker does the bucket
            # math; the bucket floor tracks the tier's own payload bound.
            from .aggregation import bucket_stack_payloads

            stacked = bucket_stack_payloads(
                rows, pad,
                min_bucket=min(1024, max(1, 2 * self.chunk_capacity)),
            )
            return {k: v[:, None] for k, v in stacked.items()}, active
        return np.stack([np.asarray(r) for r in rows])[:, None], active

    # ------------------------------------------------------- staging

    def stage(self, per_lane: list):
        """One round's batch on the device: ``(stacked, active,
        lanes_on)``. The stacked chunks (their ``device_fields``; the
        other fields stay host tensors) or payloads and the active mask
        are written into the stager's pinned buffer and copied in ONE
        transfer; ``lanes_on`` lists the active lanes on the host."""
        st = self._stager
        if self.compressed:
            stacked, active = self.stack_payloads(per_lane)
            leaves, rebuild = _flatten(stacked)
            views = st.open([(a.shape, a.dtype) for _, a in leaves]
                            + [(active.shape, active.dtype)])
            for v, (_, a) in zip(views, leaves):
                v[...] = a
            views[-1][...] = active
            dev = st.upload()
            return rebuild(dev[:-1]), dev[-1], np.flatnonzero(active)
        first = next((c for c in per_lane if c is not None), None)
        if first is None:
            raise ValueError("stack_chunks needs at least one live lane")
        self.check_template(first)
        fields = self.agg.device_fields or EdgeChunk._fields
        names = [f for f in EdgeChunk._fields if f in fields]
        tpl = self._template
        views = st.open(
            [((self.lanes,) + getattr(tpl, f).shape, getattr(tpl, f).dtype)
             for f in names] + [((self.lanes,), np.bool_)])
        stacked, active = self.stack_chunks(
            per_lane, out=dict(zip(names, views)))
        views[-1][...] = active
        dev = dict(zip(names + ["active"], st.upload()))
        chunk = EdgeChunk(*(
            dev[f] if f in dev else torch.from_numpy(getattr(stacked, f))
            for f in EdgeChunk._fields))
        return chunk, dev["active"], np.flatnonzero(active)


class _Tenant:
    """Per-tenant bookkeeping. Fields shared between the scheduler
    thread and submitters/queriers are guarded by the engine lock."""

    __slots__ = ("tid", "tier", "lane", "queue", "source", "consumed",
                 "submitted", "finished", "done", "starved_windows",
                 "manager", "pending_state", "ready", "parked",
                 "parked_window", "park_pending", "parked_state",
                 "shed")

    def __init__(self, tid, tier: str, lane: int):
        self.tid = tid
        self.tier = tier
        self.lane = lane
        self.queue: deque = deque()
        self.source: Iterator | None = None
        self.consumed = 0  # chunks whose fold was dispatched
        # Monotonic dispatch-order position of the NEXT enqueued chunk
        # (resume base + chunks ever queued). The e2e watermark stamps key
        # off this, not ``consumed + len(queue)``: the scheduler pops the
        # queue and bumps ``consumed`` in two separate lock windows.
        self.submitted = 0
        self.finished = False  # no more input will arrive
        self.done = False  # finished AND queue drained
        self.starved_windows = 0
        self.manager = None
        self.pending_state = None  # host tree awaiting lane write
        # Idle-lane reclamation evicted this tenant's lane: `parked` holds
        # its final snapshot row host-side (queries answer from it; `lane`
        # becomes -1), `parked_window` the window it was taken at.
        self.parked = None
        self.parked_window = 0
        # QoS ladder: `park_pending` marks a tenant parked by the
        # controller whose lane is freed at the next window boundary;
        # `parked_state` holds the RAW running summary row host-side, so
        # an un-park restores the lane bit-identically; `shed` marks a
        # stream the controller closed.
        self.park_pending = False
        self.parked_state = None
        self.shed = False
        # False until admit() has installed the lane state and resume
        # position: the scheduler neither pulls nor dispatches a
        # half-admitted tenant.
        self.ready = False


class _Tier:
    __slots__ = ("name", "batch", "chunks_in_window", "snapshot",
                 "snapshot_lanes", "snapshot_window", "windows_closed",
                 "last_ckpt_window", "hw_active", "low_windows")

    def __init__(self, name: str, batch: TenantBatch):
        self.name = name
        self.batch = batch
        self.chunks_in_window = 0
        self.snapshot = None  # last closed window's stacked emission
        self.snapshot_lanes = 0  # stacked width of `snapshot`
        self.snapshot_window = 0
        self.windows_closed = 0
        self.last_ckpt_window = 0
        # Idle-lane reclamation: per-window high-water of LIVE lane
        # occupants, and how many consecutive closed windows it stayed
        # below width/2.
        self.hw_active = 0
        self.low_windows = 0


class MultiTenantEngine:
    """Admission + fair-share scheduling over tenant-stacked folds.

    ``merge_every`` — scheduling rounds per merge window (each round
    advances every backlogged tenant by one chunk). ``checkpoint_dir`` +
    ``checkpoint_every`` (windows) enable per-tenant exactly-once
    checkpoints; ``resume=True`` reloads each tenant's newest valid
    checkpoint at admission and skips its already-folded prefix.
    ``mesh`` (``parallel.mesh.Mesh``, S > 1 shards) shards the TENANT
    axis: each shard's block of lanes folds on its device, with no
    cross-lane collectives. ``device`` holds the tier state when there is
    no mesh (default CUDA; ``"cpu"`` to run on the host).

    Locking: ``_lock`` guards the tenant/tier tables, queues and snapshot
    references (never held across device work, a transfer or a file
    write); ``_dispatch_lock`` serializes batch-state mutation between
    the scheduler and admissions; the QoS controller's lock is a leaf.
    """

    def __init__(self, *, merge_every: int = 1,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 1, resume: bool = False,
                 mesh=None, poll_s: float = 0.005,
                 reclaim_after: int | None = None,
                 qos: QosController | None = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        if merge_every < 1:
            raise ValueError(f"merge_every must be >= 1, got {merge_every}")
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}"
            )
        if reclaim_after is not None and reclaim_after < 1:
            raise ValueError(
                f"reclaim_after must be >= 1 windows, got {reclaim_after}"
            )
        # Idle-lane reclamation (None = off): when a tier's high-water
        # LIVE lane count stays below width/2 for `reclaim_after`
        # consecutive closed windows, the stack halves — done tenants'
        # lanes are evicted (rows parked host-side, final-checkpointed)
        # and live tenants compact into the low lanes.
        self.reclaim_after = reclaim_after
        # The QoS policy plane (None = uniform fair share). With a
        # controller the watermark ledgers run even without telemetry
        # recording (_wmk_on): backlog age IS the policy signal.
        if qos is not None and not isinstance(qos, QosController):
            raise TypeError(
                f"qos must be a QosController, got {type(qos).__name__}"
            )
        self.qos = qos
        self._qos_next_eval = 0.0
        # Admissions deferred by the ceiling (admission="queue"):
        # (tenant_id, tier, chunks) retried as pressure drains.
        self._qos_waiting: deque = deque()
        # Durability hooks: callables (tenant_id, position) fired AFTER
        # each per-tenant durability point commits. Always fired outside
        # the engine locks.
        self.on_durable: list = []
        # QoS transition hooks: callables (tenant_id, action, info).
        self.on_qos: list = []
        self.merge_every = merge_every
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.resume = resume
        from ..parallel.mesh import require_one_process

        require_one_process(mesh, "MultiTenantEngine(mesh=...)")
        self.mesh = mesh
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))
        # Queries copy their rows to the host on a stream of their own:
        # a published snapshot is already written, so a query waits for
        # neither the scheduler's queued folds nor its lock.
        self._query_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        self.poll_s = poll_s
        self._lock = threading.Lock()
        self._dispatch_lock = threading.Lock()
        self._tiers: dict[str, _Tier] = {}
        self._tenants: dict[Any, _Tenant] = {}
        self._stop = threading.Event()
        self._work = threading.Event()
        self._thread: threading.Thread | None = None
        # When set, the engine re-publishes the shared
        # ``pipeline.staged_depth`` gauge every scheduler loop.
        self.publish_staged_gauge = False
        # Optional SLO plane (obs/slo.SloPlane), ticked from the
        # scheduler loop at the gauge cadence.
        self._slo_plane = None
        self.stats = {"dispatches": 0, "chunks": 0, "windows_closed": 0,
                      "starved_lanes": 0, "reclaims": 0,
                      "lanes_reclaimed": 0}

    # ------------------------------------------------------------ control

    def attach_slo_plane(self, plane) -> None:
        """Attach an :class:`~gelly_torch.obs.slo.SloPlane`: the scheduler
        loop ticks it at the backlog-gauge cadence with the engine's live
        tenant set (don't also ``start()`` it)."""
        with self._lock:
            self._slo_plane = plane

    def add_tier(self, name: str, agg: SummaryAggregation,
                 chunk_capacity: int, min_lanes: int = 1,
                 compressed: bool = False) -> None:
        """Register a capacity tier: one plan + one chunk shape, shared by
        every tenant admitted into it. Plan constraints are validated at
        first lane build (``_compiled_tenant_plan``).

        ``compressed=True`` registers a COMPRESSED tier: tenants ship
        pre-compressed codec payloads (the plan's ``host_compress``
        output) via :meth:`submit_payload` / payload pull sources, and
        every round folds them through the tier's ``fold_codec``.
        Requires a plan with a stateless codec; snapshots are
        bit-identical to the raw tier's."""
        with self._lock:
            if name in self._tiers:
                raise ValueError(f"tier {name!r} already registered")
            self._tiers[name] = _Tier(
                name,
                TenantBatch(agg, chunk_capacity, mesh=self.mesh,
                            min_lanes=min_lanes, compressed=compressed,
                            device=self.device),
            )

    def _wmk_on(self) -> bool:
        """True when the per-tenant watermark ledgers must run: QoS
        consumes backlog ages as a POLICY signal, so a controller keeps
        the ledgers on even when telemetry recording is off."""
        return self.qos is not None or _telemetry_on()

    def tenant_ids(self) -> list:
        """Admitted tenant ids."""
        with self._lock:
            return list(self._tenants)

    def qos_state(self, tenant_id) -> str:
        """The tenant's QoS ladder state (``"ok"`` without a
        controller)."""
        return self.qos.state(tenant_id) if self.qos is not None else QOS_OK

    def _active_backlog_age(self) -> float:
        """Worst backlog age across ACTIVE (lane-holding, not-done)
        tenants — the admission/un-park pressure signal."""
        wmk = obs_bus.get_bus().watermarks
        with self._lock:
            tids = [t.tid for t in self._tenants.values()
                    if t.lane >= 0 and not t.done]
        return max((wmk.backlog_age(tid) for tid in tids), default=0.0)

    def admit(self, tenant_id, tier: str, chunks=None) -> int:
        """Admit a tenant into ``tier``; returns its lane index.

        ``chunks`` — optional chunk source (an iterable, an
        ``EdgeStream``, or anything ``engine/resilience`` can make
        seekable), pulled lazily one chunk per scheduling round. Without
        one, feed the tenant with :meth:`submit` + :meth:`finish`. With
        ``resume=True`` the tenant's newest valid checkpoint is loaded and
        a seekable source is fast-forwarded past the recorded position
        (push-mode callers replay from :meth:`position` themselves).

        With a :class:`~gelly_torch.engine.qos.QosController` configured
        with ``admission_ceiling_s``, admission is refused (raises
        :class:`~gelly_torch.engine.qos.AdmissionRefused`) or queued
        (returns ``-1``) while the ACTIVE backlog age exceeds the ceiling.
        """
        qos = self.qos
        if qos is not None and qos.admission_ceiling_s is not None:
            age = self._active_backlog_age()
            if age > qos.admission_ceiling_s:
                bus = obs_bus.get_bus()
                if qos.admission == "queue":
                    with self._lock:
                        if tenant_id in self._tenants or any(
                            w[0] == tenant_id for w in self._qos_waiting
                        ):
                            raise ValueError(
                                f"tenant {tenant_id!r} already admitted"
                                " or queued"
                            )
                        if tier not in self._tiers:
                            raise ValueError(
                                f"unknown tier {tier!r} (registered: "
                                f"{sorted(self._tiers)})"
                            )
                        self._qos_waiting.append((tenant_id, tier, chunks))
                    bus.emit(
                        "qos.admissions_queued",
                        tenant=str(tenant_id),
                        backlog_age_s=round(age, 6),
                    )
                    return -1
                bus.emit(
                    "qos.admissions_refused",
                    tenant=str(tenant_id),
                    backlog_age_s=round(age, 6),
                )
                raise AdmissionRefused(
                    tenant_id, backlog_age_s=age,
                    ceiling_s=qos.admission_ceiling_s,
                )
        with self._lock:
            if tenant_id in self._tenants:
                raise ValueError(f"tenant {tenant_id!r} already admitted")
            tr = self._tiers.get(tier)
            if tr is None:
                raise ValueError(
                    f"unknown tier {tier!r} (registered: "
                    f"{sorted(self._tiers)})"
                )
            # Next free lane: 1 + the highest OCCUPIED lane (evicted
            # tenants hold lane -1, so reclaimed widths are reused).
            lane = 1 + max(
                (t.lane for t in self._tenants.values()
                 if t.tier == tier), default=-1,
            )
            t = _Tenant(tenant_id, tier, lane)
            self._tenants[tenant_id] = t
        # Heavy work (checkpoint load, plan build, lane widening) OUTSIDE
        # the table lock; the dispatch lock keeps the widening from
        # interleaving with a fold.
        position = 0
        if self.checkpoint_dir is not None:
            from .resilience import CheckpointManager

            t.manager = CheckpointManager(
                self.checkpoint_dir, prefix=tenant_prefix(tenant_id),
                async_write=False,
            )
            if self.resume:
                found = t.manager.load_latest(
                    like=tr.batch.agg.init(tr.batch.device)
                )
                if found is not None:
                    state, position, _meta, path = found
                    t.pending_state = tree_map(to_host, state)
                    logger.info(
                        "tenant %r resuming from %s at chunk %d",
                        tenant_id, path, position,
                    )
        source = None
        if chunks is not None:
            from .resilience import _make_seekable

            source = iter(_make_seekable(chunks)(position))
        elif position:
            logger.info(
                "tenant %r resumed at chunk %d in push mode — the "
                "submitter must replay from that position", tenant_id,
                position,
            )
        with self._dispatch_lock:
            tr.batch.ensure_lanes(lane + 1)
            if t.pending_state is not None:
                tr.batch.set_lane(lane, t.pending_state)
                t.pending_state = None
        # Publish atomically: position, source and readiness in one
        # locked write.
        with self._lock:
            t.consumed = position
            t.submitted = position
            t.source = source
            t.ready = True
        if self._wmk_on():
            # Seed the per-tenant e2e ledger at the exactly-once resume
            # point.
            obs_bus.get_bus().watermarks.seed(tenant_id, position)
        self._work.set()
        return lane

    def submit(self, tenant_id, chunk: EdgeChunk) -> None:
        """Push one chunk onto a tenant's queue (any thread). Raises
        ``ValueError`` to the caller when the chunk doesn't match the
        tier's template."""
        with self._lock:
            t = self._tenants[tenant_id]
            if t.finished:
                raise ValueError(
                    f"tenant {tenant_id!r} is finished; no more chunks"
                )
            batch = self._tiers[t.tier].batch
        if batch.compressed:
            raise ValueError(
                f"tier {t.tier!r} is a compressed tier: it folds "
                "pre-compressed codec payloads — compress at the "
                "producer (the plan's host_compress) and use "
                "submit_payload()"
            )
        h = _normalize_chunk(chunk, batch.chunk_capacity)
        with self._lock:
            batch.check_template(h)
            if self._wmk_on():
                # Ingress stamp keyed by the chunk's dispatch-order
                # position: the per-tenant e2e watermark's time zero.
                obs_bus.get_bus().watermarks.stamp(
                    tenant_id, t.submitted)
            t.submitted += 1
            t.queue.append(h)
        self._work.set()

    def submit_payload(self, tenant_id, payload) -> None:
        """Push one PRE-COMPRESSED codec payload (the tier plan's
        ``host_compress`` output) onto a compressed-tier tenant's queue
        (any thread). Raises to the caller on a payload that doesn't
        match the tier's codec template."""
        with self._lock:
            t = self._tenants[tenant_id]
            if t.finished:
                raise ValueError(
                    f"tenant {tenant_id!r} is finished; no more chunks"
                )
            batch = self._tiers[t.tier].batch
        if not batch.compressed:
            raise ValueError(
                f"tier {t.tier!r} is a raw tier (add_tier("
                "compressed=False)); submit() chunks instead, or "
                "register the tier with compressed=True"
            )
        h = _normalize_payload(payload)
        if batch.agg.codec_payload_check is not None:
            # The plan's own id range check: an out-of-range id raises
            # HERE, on the producer.
            batch.agg.codec_payload_check(h)
        with self._lock:
            batch.check_payload_template(h)
            if self._wmk_on():
                obs_bus.get_bus().watermarks.stamp(
                    tenant_id, t.submitted)
            t.submitted += 1
            t.queue.append(h)
        self._work.set()

    def finish(self, tenant_id) -> None:
        """Mark a push-mode tenant's stream complete: once its queue
        drains, the tenant is done."""
        with self._lock:
            self._tenants[tenant_id].finished = True
        self._work.set()

    def position(self, tenant_id) -> int:
        """Chunks folded for this tenant (the exactly-once resume point
        is the newest checkpoint at or below this)."""
        with self._lock:
            return self._tenants[tenant_id].consumed

    def chunk_capacity(self, tier: str) -> int:
        """The tier's static chunk capacity."""
        with self._lock:
            return self._tiers[tier].batch.chunk_capacity

    def queue_depth(self, tenant_id=None) -> int:
        with self._lock:
            if tenant_id is not None:
                return len(self._tenants[tenant_id].queue)
            return sum(len(t.queue) for t in self._tenants.values())

    def starved_windows(self, tenant_id) -> int:
        with self._lock:
            return self._tenants[tenant_id].starved_windows

    # ------------------------------------------------------------ queries

    def query(self, tenant_id, v: int | None = None):
        """Read a tenant's last merge-window snapshot (staleness bound:
        one merge window) as host numpy. ``v`` indexes array snapshots
        (labels / degrees); ``None`` returns the whole row. Returns
        ``None`` before the first window close, and for a tenant admitted
        after it (its lane is not in the stored snapshot). The lock is
        held only to read the snapshot reference."""
        with self._lock:
            t = self._tenants[tenant_id]
            tier = self._tiers[t.tier]
            snap = tier.snapshot
            lane = t.lane
            width = tier.snapshot_lanes
            # The parked row answers while the tenant holds no lane OR
            # while the published snapshot predates / doesn't cover the
            # lane it was just un-parked onto.
            parked = t.parked if (
                t.parked is not None
                and (lane < 0 or lane >= width
                     or tier.snapshot_window <= t.parked_window)
            ) else None
        if parked is not None:
            if v is None:
                return tree_map(np.asarray, parked)
            return tree_map(lambda l: np.asarray(l)[v], parked)
        if snap is None or lane < 0 or lane >= width:
            # A tenant admitted after the snapshot was taken has no lane
            # in it.
            return None
        # D2H outside the lock.
        return _row_host(snap, lane if v is None else (lane, v),
                         self._query_stream)

    # Canonical reads: labels(tenant, v) for CC tiers, degree(tenant, v)
    # for degree tiers — both the same snapshot indexing.
    labels = query
    degree = query

    def telemetry(self) -> dict:
        """Per-tenant serving-plane snapshot: position, queue depth,
        backlog-age watermark, snapshot staleness and starvation per
        tenant. Read-only; never blocks the scheduler beyond the table
        lock."""
        bus = obs_bus.get_bus()
        wmk = bus.watermarks
        with self._lock:
            rows = []
            for t in self._tenants.values():
                tier = self._tiers[t.tier]
                if t.lane < 0:
                    win = t.parked_window  # evicted: the parked row
                elif t.lane >= tier.snapshot_lanes:
                    win = 0  # admitted after the snapshot was taken
                else:
                    win = tier.snapshot_window
                rows.append((t.tid, t.tier, t.lane, t.consumed,
                             len(t.queue), t.done, t.starved_windows,
                             win))
        states = self.qos.states() if self.qos is not None else {}
        out = {}
        for tid, tier_name, lane, pos, depth, done, starved, win in rows:
            out[str(tid)] = {
                "tier": tier_name,
                "lane": lane,
                "position": pos,
                "queue_depth": depth,
                "done": done,
                "starved_windows": starved,
                "backlog_age_s": round(wmk.backlog_age(tid), 6),
                "snapshot_window": win,
                "qos_state": states.get(tid, QOS_OK),
            }
        return out

    def snapshot_window(self, tenant_id) -> int:
        """Window number the tenant's snapshot was taken at (0 = none
        yet) — the query-staleness handle."""
        with self._lock:
            t = self._tenants[tenant_id]
            tier = self._tiers[t.tier]
            if t.parked is not None and (
                t.lane < 0 or t.lane >= tier.snapshot_lanes
                or tier.snapshot_window <= t.parked_window
            ):
                return t.parked_window  # parked/evicted row answers
            if t.lane < 0:
                return t.parked_window
            if t.lane >= tier.snapshot_lanes:
                return 0  # tenant admitted after the snapshot was taken
            return tier.snapshot_window

    # ------------------------------------------------------------ driving

    def start(self) -> "MultiTenantEngine":
        """Run the scheduler on a background thread (serving mode)."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("engine already started")
            self._stop.clear()
            th = threading.Thread(
                target=self._drive_loop, daemon=True,
                name="gelly-tenants",
            )
            self._thread = th
        th.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._work.set()
        with self._lock:
            th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def drain(self) -> dict:
        """Run the scheduler INLINE until every admitted tenant is done;
        returns ``{tenant_id: final snapshot row}`` from the last closed
        window.

        With a QoS controller, drain() converges only because parked
        tenants un-park once the remaining active backlog drains below
        their threshold; overloaded serving workloads belong on
        :meth:`start`."""
        self._run(until_idle=True)
        with self._lock:
            tids = list(self._tenants)
        return {tid: self.query(tid) for tid in tids}

    def _drive_loop(self) -> None:
        try:
            self._run(until_idle=False)
        except BaseException:
            logger.exception("tenant scheduler died")
            raise

    # ---------------------------------------------------------- internals

    def _pull_sources(self) -> None:
        # Refill empty queues from pull-mode sources (scheduler thread
        # only — sources are single-consumer).
        wmk_on = self._wmk_on()
        with self._lock:
            pulls = [
                t for t in self._tenants.values()
                if t.ready and t.source is not None and not t.finished
                and not t.queue
            ]
        for t in pulls:
            batch = self._tiers[t.tier].batch
            try:
                chunk = next(t.source, None)
                if chunk is None:
                    h = None
                elif batch.compressed:
                    # Compressed tiers pull PAYLOAD sources.
                    h = _normalize_payload(chunk)
                    if batch.agg.codec_payload_check is not None:
                        batch.agg.codec_payload_check(h)
                else:
                    h = _normalize_chunk(chunk, batch.chunk_capacity)
                with self._lock:
                    if h is None:
                        t.finished = True
                    else:
                        if batch.compressed:
                            batch.check_payload_template(h)
                        else:
                            batch.check_template(h)
                        if wmk_on:
                            obs_bus.get_bus().watermarks.stamp(
                                t.tid, t.submitted)
                        t.submitted += 1
                        t.queue.append(h)
            except Exception:
                # Quarantine: one tenant's bad source/chunk must not kill
                # the scheduler for every other tenant.
                logger.exception(
                    "tenant %r: chunk source failed; quarantining "
                    "(stream truncated at chunk %d)", t.tid, t.consumed,
                )
                with self._lock:
                    t.finished = True

    def _run(self, until_idle: bool) -> None:
        bus = obs_bus.get_bus()
        tracer = obs_tracing.active_tracer()
        hb = None
        if tracer is not None and tracer.heartbeat_every_s is not None:
            from ..obs.heartbeat import Heartbeat

            hb = Heartbeat(tracer.heartbeat_every_s)
        gauge_next = 0.0  # first round always publishes
        while not self._stop.is_set():
            self._pull_sources()
            advanced = self._round(bus, tracer)
            # Bound once a scheduling pass: the gauge block below runs only
            # with telemetry on.
            telemetry = _telemetry_on()
            with self._lock:
                for t in self._tenants.values():
                    if t.finished and not t.queue and not t.done:
                        t.done = True
                live = [t for t in self._tenants.values() if not t.done]
                queued = sum(len(t.queue) for t in live)
            bus.gauge("tenants.active", len(live))
            bus.gauge("tenants.queue_depth", queued)
            if self.publish_staged_gauge:
                bus.gauge("pipeline.staged_depth", queued)
            if self.qos is not None:
                self._qos_evaluate(bus)
            backlog_max = 0.0
            hb_due = hb is not None and hb.due()
            if telemetry:
                # Rate-limited: dispatching rounds refresh the per-tenant
                # gauges at most every 0.5 s; idle rounds and due
                # heartbeats publish unconditionally.
                now = _time.monotonic()
                if not advanced or hb_due or now >= gauge_next:
                    gauge_next = now + 0.5
                    wmk = bus.watermarks
                    with self._lock:
                        tids = [(t.tid, t.lane >= 0 and not t.done)
                                for t in self._tenants.values()]
                    for tid, active in tids:
                        # Every tenant, done ones included: a drained
                        # ledger publishes 0.
                        age = wmk.backlog_age(tid)
                        if active:
                            # The headline max is over ACTIVE tenants
                            # only: a parked tenant's ledger ages while
                            # held.
                            backlog_max = max(backlog_max, age)
                        bus.gauge(f"tenants.t{tid}.backlog_age_s",
                                  round(age, 6))
                    bus.gauge("tenants.backlog_age_max_s",
                              round(backlog_max, 6))
                    if self._slo_plane is not None:
                        self._slo_plane.set_tenants(
                            [tid for tid, _ in tids])
                        try:
                            self._slo_plane.tick()
                        except Exception:
                            # Evaluation must never take the scheduler
                            # down with it.
                            logger.exception("SLO plane tick failed")
            if hb_due:
                extras = {}
                if self.qos is not None:
                    counts = self.qos.counts()
                    extras = {
                        "qos_limited": counts[QOS_LIMITED],
                        "qos_parked": counts[QOS_PARKED],
                        "qos_shed": counts[QOS_SHED],
                    }
                hb.tick(
                    tenants_active=len(live),
                    tenants_queue_depth=queued,
                    windows=self.stats["windows_closed"],
                    chunks=self.stats["chunks"],
                    starved=self.stats["starved_lanes"],
                    backlog_age_max_s=round(backlog_max, 3),
                    round_p99_ms=round(
                        bus.quantile("tenants.round_ms", 0.99), 3),
                    slo_breaching=int(bus.gauges.get(
                        "slo.breaching", 0)),
                    **extras,
                )
            if advanced:
                continue
            # Nothing dispatched this round: flush partial windows so
            # finished tenants' tails (and idle serving snapshots) emit.
            self._flush_partial(bus, tracer)
            if until_idle:
                if not live:
                    self._ensure_snapshots()
                    self._final_checkpoints()
                    return
                if not queued:
                    # Remaining live tenants are unfinished push-mode
                    # feeds: drain() would spin forever.
                    raise RuntimeError(
                        "drain() would wait forever: push-mode tenants "
                        f"({[t.tid for t in live]}) have no pending "
                        "chunks and were never finish()ed — call "
                        "finish(tenant) or use start() for serving mode"
                    )
                continue
            self._work.clear()
            self._work.wait(self.poll_s)

    def _round(self, bus, tracer) -> bool:
        """One scheduling round: every tier with pending work gets ONE
        fold advancing each backlogged tenant by one chunk. Returns True
        when any tier dispatched."""
        # The guards, bound once a round: every histogram and watermark
        # site below tests these (the span sites test ``tracer``).
        telemetry = _telemetry_on()
        wmk_on = self.qos is not None or telemetry
        any_dispatch = False
        with self._lock:
            tiers = list(self._tiers.values())
        for tier in tiers:
            with self._lock:
                members = [
                    t for t in self._tenants.values()
                    if t.tier == tier.name and t.ready and t.lane >= 0
                ]
                # Reclamation high-water: LIVE lane occupants this round.
                tier.hw_active = max(
                    tier.hw_active,
                    sum(1 for t in members if not t.done),
                )
                # Index by LANE, not member order: a half-admitted
                # neighbor (ready=False) leaves its lane masked.
                width = 1 + max((t.lane for t in members), default=-1)
                per_lane: list = [None] * width
                took: list = []
                starved_tenants: list = []
                backlogged: list = []
                for t in members:
                    if t.park_pending:
                        # Park decided but not yet executed (waiting for
                        # the window boundary): hold the lane masked.
                        continue
                    if t.queue:
                        backlogged.append(t)
                    elif not t.finished and not t.done:
                        starved_tenants.append(t)
                granted = None
                if self.qos is not None and backlogged:
                    # Deficit-round-robin over policy weights. The
                    # controller's lock is a leaf — safe inside the table
                    # lock. A backlogged-but-ungranted tenant is not
                    # starved: it is paced by policy.
                    granted = self.qos.plan_round(
                        [t.tid for t in backlogged])
                for t in backlogged:
                    if granted is None or t.tid in granted:
                        per_lane[t.lane] = t.queue.popleft()
                        took.append(t)
            if not took:
                # No dispatch, no starvation: a starved window is a masked
                # no-op lane IN a dispatch.
                continue
            starved = len(starved_tenants)
            batch = tier.batch
            t0 = tracer.now() if tracer is not None else 0.0
            t_h = _time.perf_counter() if telemetry else 0.0
            with self._dispatch_lock:
                batch.ensure_lanes(len(per_lane))
                fold = (batch.plan.fold_codec if batch.compressed
                        else batch.plan.fold)
                dev, act, lanes_on = batch.stage(per_lane)
                # ONE fold advances every lane of the tier.
                batch.state = fold(batch.state, dev, act, lanes_on)
            if telemetry:
                # Per-round latency (stack + H2D + fold): the signal a
                # fair-share scheduler budgets rounds against.
                bus.observe("tenants.round_ms",
                            (_time.perf_counter() - t_h) * 1e3)  # graphlint: disable=GL007 -- tenants.round_ms times the round's dispatch
            with self._lock:
                for t in took:
                    t.consumed += 1
                for t in starved_tenants:
                    t.starved_windows += 1
                self.stats["dispatches"] += 1
                self.stats["chunks"] += len(took)
                if starved:
                    self.stats["starved_lanes"] += starved
            if wmk_on:
                # Ingress→fold for every chunk this round advanced.
                for t in took:
                    bus.watermarks.retire_fold(
                        t.tid, t.consumed,
                        bus=bus if telemetry else None,
                        prefix=(f"tenants.t{t.tid}"
                                if telemetry else None))
            if starved:
                bus.inc("tenants.starved_windows", starved)
            bus.inc("tenants.dispatches")
            if batch.compressed:
                bus.inc("tenants.compressed_dispatches")
            bus.inc("tenants.chunks_folded", len(took))
            if tracer is not None:
                tracer.span(
                    "fold", f"tenants/{tier.name}", t0,
                    tier=tier.name, lanes=batch.lanes,
                    advanced=len(took), starved=starved,
                )
            tier.chunks_in_window += 1
            any_dispatch = True
            if tier.chunks_in_window >= self.merge_every:
                self._close_window(tier, bus, tracer)
        return any_dispatch

    # -------------------------------------------------------- QoS ladder

    def _qos_evaluate(self, bus) -> None:
        """The rate-limited QoS pass (scheduler thread only): advance
        every tenant's ladder state, execute pending parks at safe
        points, retry queued admissions, publish the ``qos.*`` gauges and
        fire ``on_qos`` hooks — all hook/bus work OUTSIDE the engine
        locks."""
        qos = self.qos
        now = _time.monotonic()
        wmk = obs_bus.get_bus().watermarks
        with self._lock:
            if now < self._qos_next_eval:
                return
            self._qos_next_eval = now + qos.eval_every_s
            rows = [(t, len(t.queue)) for t in self._tenants.values()
                    if t.ready and not t.done]
            active = [t.tid for t, _ in rows if t.lane >= 0]
        ages = {t.tid: wmk.backlog_age(t.tid) for t, _ in rows}
        active_max = max((ages[tid] for tid in active), default=0.0)
        events: list = []
        for t, depth in rows:
            action = qos.evaluate(
                t.tid, backlog_age_s=ages[t.tid], queue_depth=depth,
                active_backlog_max_s=active_max,
            )
            if action is None:
                continue
            info = {"backlog_age_s": round(ages[t.tid], 6),
                    "queue_depth": depth}
            if action == "limit":
                bus.emit("qos.rate_limited", tenant=str(t.tid), **info)
            elif action == "clear":
                bus.emit("qos.limit_cleared", tenant=str(t.tid), **info)
            elif action == "park":
                with self._lock:
                    t.park_pending = True
                bus.emit("qos.parked", tenant=str(t.tid), **info)
            elif action == "unpark":
                self._unpark_tenant(t)
                bus.emit("qos.unparked", tenant=str(t.tid), **info)
            elif action == "shed":
                info["chunks_dropped"] = self._shed_tenant(t, bus)
                bus.emit("qos.shed", tenant=str(t.tid), **info)
            events.append((t.tid, action, info))
        # Parks execute only at a window boundary — a mid-window park
        # would drop the lane's un-merged folds. Idle tiers are at a
        # boundary RIGHT NOW; busy tiers park in _close_window.
        with self._lock:
            idle_tiers = [tr for tr in self._tiers.values()
                          if tr.chunks_in_window == 0]
        for tr in idle_tiers:
            self._execute_parks(tr, bus)
        self._retry_admissions(bus)
        counts = qos.counts()
        bus.gauge("qos.limited_tenants", counts[QOS_LIMITED])
        bus.gauge("qos.parked_tenants", counts[QOS_PARKED])
        bus.gauge("qos.shed_tenants", counts[QOS_SHED])
        for tid, action, info in events:
            self._fire_qos(tid, action, info)

    def _execute_parks(self, tier: _Tier, bus) -> None:
        """Physically park every ``park_pending`` member of ``tier``
        (scheduler thread, window boundary only): copy the lane's
        snapshot row AND raw running row to the host, final-save through
        the tenant's manager (a durability point), then free the lane."""
        with self._lock:
            pend = [t for t in self._tenants.values()
                    if t.tier == tier.name and t.park_pending
                    and t.lane >= 0 and t.ready]
        if not pend:
            return
        batch = tier.batch
        retired: list = []
        with self._dispatch_lock:
            if batch.plan is None:
                with self._lock:
                    for t in pend:
                        t.lane = -1
                        t.park_pending = False
                return
            src = batch.state if batch.accum else batch.global_
            snap = batch.plan.snapshot(src)
            _ready(snap)
            parked_rows = {t.tid: _row_host(snap, t.lane) for t in pend}
            raw_rows = {t.tid: _row_host(src, t.lane) for t in pend}
            for t in pend:
                if t.manager is not None:
                    pos = t.consumed
                    t.manager.save(
                        batch.slice_lane(t.lane), pos,
                        meta={"tenant": str(t.tid), "tier": tier.name,
                              "window": tier.windows_closed,
                              "qos_parked": True},
                    )
                    retired.append((t.tid, pos))
            with self._lock:
                for t in pend:
                    t.parked = parked_rows[t.tid]
                    t.parked_state = raw_rows[t.tid]
                    t.parked_window = tier.windows_closed
                    t.lane = -1
                    t.park_pending = False
        for tid, pos in retired:
            self._notify_durable(tid, pos, bus)

    def _unpark_tenant(self, t: _Tenant) -> None:
        """Re-seat a parked tenant on a fresh lane, restoring the raw
        running row saved at park time bit-identically. Lane choice and
        assignment happen in ONE locked block."""
        with self._lock:
            if t.lane >= 0:
                return
            lane = 1 + max(
                (x.lane for x in self._tenants.values()
                 if x.tier == t.tier), default=-1,
            )
            t.lane = lane
            state = t.parked_state
        batch = self._tiers[t.tier].batch
        with self._dispatch_lock:
            batch.ensure_lanes(lane + 1)
            if state is not None:
                batch.set_lane(lane, state)
        # t.parked stays for query continuity until a window close covers
        # the new lane (the freshness guard in query()).
        self._work.set()

    def _shed_tenant(self, t: _Tenant, bus) -> int:
        """Close a tenant's stream: drop its queued (never-folded) chunks,
        mark it finished+shed. Returns the dropped-chunk count."""
        with self._lock:
            dropped = len(t.queue)
            t.queue.clear()
            t.finished = True
            t.shed = True
            t.park_pending = False
        if dropped:
            bus.inc("qos.chunks_dropped", dropped)
        obs_bus.get_bus().watermarks.drop(t.tid)
        self._work.set()
        return dropped

    def _retry_admissions(self, bus) -> None:
        """Admit ONE queued tenant per QoS pass once active pressure is
        back under the ceiling."""
        qos = self.qos
        if qos.admission_ceiling_s is None:
            return
        with self._lock:
            if not self._qos_waiting:
                return
        if self._active_backlog_age() > qos.admission_ceiling_s:
            return
        with self._lock:
            if not self._qos_waiting:
                return
            tenant_id, tier, chunks = self._qos_waiting.popleft()
        try:
            lane = self.admit(tenant_id, tier, chunks=chunks)
        except ValueError:
            logger.exception(
                "queued admission for tenant %r failed", tenant_id)
            return
        if lane >= 0:
            bus.emit("qos.admissions_resumed", tenant=str(tenant_id))

    def _notify_durable(self, tenant_id, position: int, bus) -> None:
        """One tenant's durability point: retire the e2e ledger and fire
        the ``on_durable`` hooks. Called outside the engine locks."""
        telemetry = _telemetry_on()
        if self._wmk_on():
            bus.watermarks.retire_durable(
                tenant_id, position,
                bus=bus if telemetry else None,
                prefix=f"tenants.t{tenant_id}" if telemetry else None,
            )
        for fn in list(self.on_durable):
            try:
                fn(tenant_id, position)
            except Exception:
                logger.exception(
                    "on_durable hook failed for tenant %r at %d",
                    tenant_id, position,
                )

    def _fire_qos(self, tenant_id, action: str, info: dict) -> None:
        for fn in list(self.on_qos):
            try:
                fn(tenant_id, action, info)
            except Exception:
                logger.exception(
                    "on_qos hook failed for tenant %r (%s)",
                    tenant_id, action,
                )

    def _close_window(self, tier: _Tier, bus, tracer) -> None:
        batch = tier.batch
        plan = batch.plan
        t0 = tracer.now() if tracer is not None else 0.0
        with self._dispatch_lock:
            if batch.accum:
                snap = plan.snapshot(batch.state)
            else:
                merged = plan.merger(batch.state, batch.global_)
                if batch.agg.transient:
                    # Reference Merger transientState semantics: emit
                    # combine(window, global), then reset the global.
                    out = merged
                    batch.global_ = plan.init()
                else:
                    batch.global_ = merged
                    out = merged
                batch.state = plan.init()
                snap = plan.snapshot(out)
            # The window's one completion barrier: the snapshot — and
            # with it every fold of the window — is written before
            # queries can observe the new window number.
            _ready(snap)
        tier.chunks_in_window = 0
        tier.windows_closed += 1
        bus.inc("tenants.windows_closed")
        # Lane bound from the snapshot's OWN leading dim: an admission may
        # widen the batch between the snapshot and this publication.
        snap_lanes = tree_flatten(snap)[0][0].shape[0]
        with self._lock:
            self.stats["windows_closed"] += 1
            tier.snapshot = snap
            tier.snapshot_lanes = snap_lanes
            tier.snapshot_window = tier.windows_closed
            for t in self._tenants.values():
                # A fresh snapshot covering an un-parked tenant's new lane
                # supersedes its parked row.
                if (t.tier == tier.name and t.parked is not None
                        and 0 <= t.lane < snap_lanes):
                    t.parked = None
                    t.parked_state = None
        if tracer is not None:
            tracer.span("merge_emit", f"tenants/{tier.name}", t0,
                        tier=tier.name, window=tier.windows_closed)
        if (self.checkpoint_dir is not None
                and tier.windows_closed - tier.last_ckpt_window
                >= self.checkpoint_every):
            self._checkpoint_tier(tier)
        elif self.checkpoint_dir is None and (self._wmk_on()
                                              or self.on_durable):
            # No durability point configured: the window close IS the
            # retirement point (with a QoS controller this must run even
            # when telemetry is off, or every backlog age grows forever).
            with self._lock:
                members = [(t.tid, t.consumed)
                           for t in self._tenants.values()
                           if t.tier == tier.name]
            for tid, pos in members:
                self._notify_durable(tid, pos, bus)
        if self.reclaim_after is not None:
            self._maybe_reclaim(tier, bus, tracer)
        if self.qos is not None:
            # Window boundary = the safe point for pending parks.
            self._execute_parks(tier, bus)

    def _checkpoint_tier(self, tier: _Tier) -> None:
        batch = tier.batch
        with self._dispatch_lock:
            if batch.plan is not None and batch.plan.flatten is not None:
                # Path flatten at checkpoint cadence; the flattened stack
                # REPLACES the live state and is what the per-lane saves
                # slice.
                if batch.accum:
                    batch.state = batch.plan.flatten(batch.state)
                else:
                    batch.global_ = batch.plan.flatten(batch.global_)
            with self._lock:
                # Ready tenants only: admit() sets a tenant's manager
                # before it widens the stack to the tenant's lane, and a
                # window closing in between would slice past the stack
                # (gelly_tpu's clamping gather saves another lane's state
                # there).
                members = [
                    (t, t.consumed) for t in self._tenants.values()
                    if t.tier == tier.name and t.manager is not None
                    and t.lane >= 0 and t.ready
                ]
            saved: list = []
            for t, position in members:
                t_h = _time.perf_counter()
                t.manager.save(
                    batch.slice_lane(t.lane), position,
                    meta={"tenant": str(t.tid), "tier": tier.name,
                          "window": tier.windows_closed},
                )
                b = obs_bus.get_bus()
                obs_bus.publish_checkpoint(
                    b, "tenants", t.manager.path_for(position), t0=t_h,
                )
                saved.append((t.tid, position))
        tier.last_ckpt_window = tier.windows_closed
        # The per-tenant durability point, OUTSIDE the dispatch lock.
        b = obs_bus.get_bus()
        for tid, position in saved:
            self._notify_durable(tid, position, b)

    def _maybe_reclaim(self, tier: _Tier, bus, tracer) -> None:
        """Idle-lane reclamation (at every window close when
        ``reclaim_after`` is set): halve the tier's lane stack once the
        high-water LIVE lane count has stayed below width/2 for
        ``reclaim_after`` consecutive windows. Evicted (done) tenants'
        rows are copied host-side — and final-checkpointed when a manager
        exists — BEFORE the stack is rebuilt; live tenants compact into
        the low lanes."""
        batch = tier.batch
        with self._lock:
            members = [t for t in self._tenants.values()
                       if t.tier == tier.name]
            live_cnt = sum(1 for t in members
                           if not t.done and t.lane >= 0)
            hw = tier.hw_active
            tier.hw_active = live_cnt  # restart at the current floor
            width = batch.lanes
            target = batch._width_for(max(width // 2, live_cnt, 1))
            shrinkable = batch.plan is not None and target < width
            if shrinkable and 2 * hw < width:
                tier.low_windows += 1
            else:
                tier.low_windows = 0
            due = shrinkable and tier.low_windows >= self.reclaim_after
            if due:
                tier.low_windows = 0
        if not due:
            return
        with self._dispatch_lock:
            # Re-collect under the dispatch lock: an admission may have
            # widened/occupied lanes since the decision above.
            with self._lock:
                members = [t for t in self._tenants.values()
                           if t.tier == tier.name]
                if any(t.lane >= 0 and not t.ready for t in members):
                    # A half-admitted tenant holds a lane index admit() is
                    # still working against: defer to the next window.
                    return
                live = sorted(
                    (t for t in members if not t.done and t.lane >= 0),
                    key=lambda t: t.lane,
                )
                evicted = [t for t in members if t.done and t.lane >= 0]
                width = batch.lanes
                target = batch._width_for(max(width // 2, len(live), 1))
                if batch.plan is None or target >= width:
                    return
            # Evicted lanes' state is copied FIRST: the parked row answers
            # queries after the lane is gone, and the final checkpoint
            # makes the evicted tenant's resume point durable.
            src = batch.state if batch.accum else batch.global_
            snap = batch.plan.snapshot(src)
            _ready(snap)
            parked = {t.tid: _row_host(snap, t.lane) for t in evicted}
            final_saves: list = []
            for t in evicted:
                if t.manager is not None:
                    t.manager.save(
                        batch.slice_lane(t.lane), t.consumed,
                        meta={"tenant": str(t.tid), "tier": tier.name,
                              "window": tier.windows_closed,
                              "evicted": True},
                    )
                    final_saves.append((t.tid, t.consumed))
            keep_lanes = [t.lane for t in live]
            batch.shrink(keep_lanes, target)
            # Published snapshot rebuilt in the NEW lane order, swapped in
            # with the lane remap in ONE locked write.
            new_snap = None
            if keep_lanes:
                idx = torch.as_tensor(np.asarray(keep_lanes, np.int64))
                new_snap = tree_map(lambda l: l[idx.to(l.device)], snap)
                _ready(new_snap)
            freed = width - target
            with self._lock:
                for i, t in enumerate(live):
                    t.lane = i
                for t in evicted:
                    t.parked = parked[t.tid]
                    t.parked_window = tier.windows_closed
                    t.lane = -1
                if new_snap is not None:
                    tier.snapshot = new_snap
                    tier.snapshot_lanes = len(keep_lanes)
                    tier.snapshot_window = tier.windows_closed
                else:
                    # No live lanes kept: a later admission at lane 0 must
                    # not read an evicted tenant's row from the old one.
                    tier.snapshot = None
                    tier.snapshot_lanes = 0
                self.stats["reclaims"] += 1
                self.stats["lanes_reclaimed"] += freed
        # The evicted tenants' final saves are durability points too.
        for tid, pos in final_saves:
            self._notify_durable(tid, pos, bus)
        if self._wmk_on():
            # Evicted tenants fold nothing further: drop their ledgers.
            for t in evicted:
                bus.watermarks.drop(t.tid)
        bus.inc("tenants.reclaims")
        bus.inc("tenants.lanes_reclaimed", freed)
        logger.info(
            "tier %r reclaimed %d idle lanes (width %d -> %d, %d "
            "evicted, %d live)", tier.name, freed, width, target,
            len(evicted), len(live),
        )
        if tracer is not None:
            tracer.instant("tenants.reclaim", tier=tier.name,
                           width=target, freed=freed,
                           evicted=len(evicted))

    def _flush_partial(self, bus, tracer) -> None:
        with self._lock:
            tiers = list(self._tiers.values())
        for tier in tiers:
            if tier.chunks_in_window:
                self._close_window(tier, bus, tracer)

    def _ensure_snapshots(self) -> None:
        # A tenant that resumed at end-of-stream folds zero new chunks and
        # closes no window; its restored summary must still be queryable
        # after drain() — snapshot the running state without counting a
        # window.
        with self._lock:
            tiers = [
                tier for tier in self._tiers.values()
                if tier.snapshot is None and tier.batch.plan is not None
                and any(t.tier == tier.name
                        for t in self._tenants.values())
            ]
        for tier in tiers:
            batch = tier.batch
            with self._dispatch_lock:
                src = batch.state if batch.accum else batch.global_
                snap = batch.plan.snapshot(src)
                _ready(snap)
            with self._lock:
                tier.snapshot = snap
                tier.snapshot_lanes = tree_flatten(snap)[0][0].shape[0]

    def _final_checkpoints(self) -> None:
        if self.checkpoint_dir is None:
            return
        with self._lock:
            tiers = list(self._tiers.values())
        for tier in tiers:
            if tier.last_ckpt_window < tier.windows_closed:
                self._checkpoint_tier(tier)
