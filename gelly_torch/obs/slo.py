"""Per-tenant SLO plane: declarative latency/backlog objectives
evaluated against the event bus, burn-rate gauges, breach events, and a
Prometheus text exposition of every bus metric.

The QoS roadmap item needs a *signal*, not a dashboard: admission
control wants to know "is tenant 3 burning its fold-latency budget
right now?" as a gauge it can read and an event it can subscribe to.
This module produces exactly that from the histograms and watermarks
the runtime already publishes — it adds no new instrumentation to hot paths.

Pieces
------

- :class:`SloSpec` — one declarative objective: a bus metric (histogram
  quantile, gauge, or the backlog-age watermark), a threshold, and a
  rolling window. ``per_tenant=True`` specs template ``{tenant}`` into
  the metric name and evaluate once per attached tenant.
- :class:`SloPlane` — evaluates every spec instance on :meth:`~SloPlane.tick`
  (caller-driven, e.g. from the tenant scheduler loop, or via the
  optional :meth:`~SloPlane.start` thread). Each tick publishes:

  * ``slo.<key>.burn_rate`` gauge — the fraction of window samples in
    breach (0.0 healthy .. 1.0 hard down). ``<key>`` is the spec name,
    suffixed ``.t<tid>`` for per-tenant instances.
  * ``slo.breaching`` gauge — total breaching instances this tick (the
    ``Heartbeat`` ``slo_breaching=N`` field reads this).
  * ``slo.breach`` / ``slo.recovered`` events on threshold crossings,
    carrying ``slo=``/``tenant=``/``value=``/``threshold=``/
    ``burn_rate=`` fields — the push-alert plane (ingest/server.py
    SUBSCRIBE filters) and future QoS admission control consume these.

- :func:`prometheus_text` — text-format (0.0.4) exposition of a bus
  snapshot: counters as ``gelly_<name>_total``, gauges as
  ``gelly_<name>``, histograms as summaries with quantile labels.
  Served by the STATS wire frame (``{"format": "prometheus"}`` payload)
  and ``python -m gelly_torch.obs.status --prometheus``.
- :class:`SummaryDeltaWatch` — the ROADMAP "subscriber callbacks firing
  on summary deltas" piece: feed it per-batch summary observations and
  it emits ``alerts.component_merge`` (component count dropped — a
  merge happened) and ``alerts.degree_spike`` (max degree jumped past
  ``spike_factor`` x its trailing EMA) for the alert plane to push.

Evaluation is deliberately pull-based and O(specs) per tick: no
subscriber on the hot emit path, no per-sample work. A tick with an
unpopulated metric (histogram never observed, gauge never set) counts
the instance as healthy — absence of data is not a breach.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from collections import deque
from dataclasses import dataclass

from . import bus as bus_mod

logger = logging.getLogger("gelly_torch.obs.slo")

# Sentinel metric name: evaluate bus.watermarks.max_backlog_age()
# live instead of reading a published gauge — the watermark ledger is
# always current even between heartbeat gauge publications.
WATERMARK_BACKLOG = "watermarks.max_backlog_age"


@dataclass(frozen=True)
class SloSpec:
    """One declarative objective.

    ``metric`` names a bus histogram (with ``quantile``) or gauge
    (``quantile=None``), or the :data:`WATERMARK_BACKLOG` sentinel.
    ``per_tenant`` specs must embed ``{tenant}`` in the metric name;
    the plane evaluates one instance per attached tenant id. A value
    strictly above ``threshold`` is a breach.
    """

    name: str
    metric: str
    threshold: float
    quantile: float | None = None
    per_tenant: bool = False
    window_s: float = 60.0

    def __post_init__(self):
        if self.per_tenant and "{tenant}" not in self.metric:
            raise ValueError(
                f"per_tenant spec {self.name!r} needs '{{tenant}}' in "
                f"metric, got {self.metric!r}")


def fold_p99_ms(threshold_ms: float, window_s: float = 60.0) -> SloSpec:
    """p99 fold-dispatch latency objective (ms)."""
    return SloSpec("fold_p99_ms", "engine.fold_dispatch_ms", threshold_ms,
                   quantile=0.99, window_s=window_s)


def backlog_age_max_s(threshold_s: float, window_s: float = 60.0) -> SloSpec:
    """Worst backlog age across all streams (s) — read live from the
    watermark ledger, not from the heartbeat-published gauge."""
    return SloSpec("backlog_age_max_s", WATERMARK_BACKLOG, threshold_s,
                   window_s=window_s)


def e2e_durable_p90_ms(threshold_ms: float,
                       window_s: float = 60.0) -> SloSpec:
    """p90 ingress-to-durable latency objective (ms)."""
    return SloSpec("e2e_durable_p90_ms", "engine.e2e_ingress_to_durable_ms",
                   threshold_ms, quantile=0.90, window_s=window_s)


def tenant_backlog_age_s(threshold_s: float,
                         window_s: float = 60.0) -> SloSpec:
    """Per-tenant backlog-age objective against the router-published
    ``tenants.t<tid>.backlog_age_s`` gauges."""
    return SloSpec("backlog_age_s", "tenants.t{tenant}.backlog_age_s",
                   threshold_s, per_tenant=True, window_s=window_s)


class SloPlane:
    """Evaluates :class:`SloSpec` instances against the bus on demand.

    Caller-driven by default (:meth:`tick` from an existing loop — the
    tenant scheduler does this); :meth:`start`/:meth:`stop` run a
    bounded background thread for standalone use. All published state
    lands on the bus, so readers (heartbeats, STATS, alert
    subscriptions) need no reference to the plane itself.
    """

    def __init__(self, specs, *, bus=None, tenants=(),
                 clock=time.monotonic):
        self.specs: list[SloSpec] = list(specs)
        self._bus = bus
        self.tenants: list[int] = list(tenants)
        self._clock = clock
        # key -> {"breaching": bool, "samples": deque[(t, bool)]}
        self._state: dict = {}
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    def _resolve_bus(self):
        return self._bus if self._bus is not None else bus_mod.get_bus()

    def set_tenants(self, tids) -> None:
        """Replace the evaluated tenant set (the tenant scheduler syncs
        its live tenants here each tick)."""
        with self._lock:
            self.tenants = list(tids)

    def attach_tenant(self, tid: int) -> None:
        with self._lock:
            if tid not in self.tenants:
                self.tenants.append(tid)

    def detach_tenant(self, tid: int) -> None:
        with self._lock:
            if tid in self.tenants:
                self.tenants.remove(tid)

    def _value(self, bus, spec: SloSpec, tenant) -> float | None:
        metric = (spec.metric.format(tenant=tenant) if spec.per_tenant
                  else spec.metric)
        if metric == WATERMARK_BACKLOG:
            return bus.watermarks.max_backlog_age()
        if spec.quantile is not None:
            h = bus.histogram(metric)
            return None if h is None else h.quantile(spec.quantile)
        return bus.gauges.get(metric)

    def tick(self) -> int:
        """Evaluate every spec instance once; returns the number of
        instances currently in breach (also published as the
        ``slo.breaching`` gauge)."""
        bus = self._resolve_bus()
        now = self._clock()
        with self._lock:
            tenants = list(self.tenants)
        breaching_total = 0
        for spec in self.specs:
            instances = tenants if spec.per_tenant else (None,)
            for tenant in instances:
                key = (spec.name if tenant is None
                       else f"{spec.name}.t{tenant}")
                value = self._value(bus, spec, tenant)
                breach = value is not None and value > spec.threshold
                with self._lock:
                    st = self._state.setdefault(
                        key, {"breaching": False, "samples": deque()})
                    samples = st["samples"]
                    samples.append((now, breach))
                    while samples and now - samples[0][0] > spec.window_s:
                        samples.popleft()
                    burn = (sum(1 for _, b in samples if b)
                            / max(len(samples), 1))
                    was = st["breaching"]
                    st["breaching"] = breach
                bus.gauge(f"slo.{key}.burn_rate", round(burn, 4))
                if breach:
                    breaching_total += 1
                val = round(float(value), 6) if value is not None else None
                if breach and not was:
                    bus.emit("slo.breach", slo=spec.name, key=key,
                             tenant=tenant, value=val,
                             threshold=spec.threshold,
                             burn_rate=round(burn, 4))
                elif was and not breach:
                    bus.emit("slo.recovered", slo=spec.name, key=key,
                             tenant=tenant, value=val,
                             threshold=spec.threshold,
                             burn_rate=round(burn, 4))
        bus.gauge("slo.breaching", breaching_total)
        return breaching_total

    # -- optional background evaluation ------------------------------

    def start(self, period_s: float = 1.0) -> "SloPlane":
        """Spawn the evaluation thread (daemon; :meth:`stop` joins it
        with a bound). Raises if already running."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("SLO plane already started")
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, args=(float(period_s),), daemon=True,
            name="gelly-obs-slo")
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None

    def _run(self, period_s: float) -> None:
        while not self._stop_evt.wait(period_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — evaluation must not die
                logger.exception("SLO tick failed")


class SummaryDeltaWatch:
    """Summary-delta alert source (ROADMAP: "subscriber callbacks
    firing on summary deltas").

    Caller-invoked — the engine (or a test harness) calls
    :meth:`observe` with per-batch summary figures; crossings emit
    ``alerts.component_merge`` / ``alerts.degree_spike`` events, which
    the server's SUBSCRIBE filters turn into pushed ALERT frames.
    Stateful but lock-free: callers are expected to observe from one
    thread (the fold/summary consumer).
    """

    def __init__(self, *, bus=None, spike_factor: float = 4.0,
                 min_degree: float = 8.0, ema_alpha: float = 0.3):
        self._bus = bus
        self.spike_factor = float(spike_factor)
        self.min_degree = float(min_degree)
        self.ema_alpha = float(ema_alpha)
        self._components: int | None = None
        self._deg_ema: float | None = None

    def observe(self, *, components=None, max_degree=None, tenant=None,
                position=None) -> None:
        bus = self._bus if self._bus is not None else bus_mod.get_bus()
        extra = {}
        if tenant is not None:
            extra["tenant"] = tenant
        if position is not None:
            extra["position"] = position
        if components is not None:
            c = int(components)
            if self._components is not None and c < self._components:
                bus.emit("alerts.component_merge", components=c,
                         merged=self._components - c, **extra)
            self._components = c
        if max_degree is not None:
            d = float(max_degree)
            ema = self._deg_ema
            if (ema is not None and d >= self.min_degree
                    and d > self.spike_factor * max(ema, 1e-9)):
                bus.emit("alerts.degree_spike", degree=d,
                         baseline=round(ema, 3), **extra)
            self._deg_ema = (d if ema is None
                             else (1.0 - self.ema_alpha) * ema
                             + self.ema_alpha * d)


# -- Prometheus exposition -------------------------------------------

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "gelly_" + _NAME_BAD.sub("_", name)


def _prom_num(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(bus=None) -> str:
    """Render the bus snapshot in Prometheus text format 0.0.4.

    Counters become ``gelly_<name>_total``, gauges ``gelly_<name>``
    (dots sanitised to underscores), histograms become summaries with
    ``quantile`` labels plus ``_sum``/``_count`` series, and per-stream
    watermark backlog ages become a ``stream``-labelled gauge. Served
    by the STATS wire frame with a ``{"format": "prometheus"}`` payload
    and by the status CLI's ``--prometheus`` flag.
    """
    bus = bus if bus is not None else bus_mod.get_bus()
    snap = bus.snapshot()
    lines: list[str] = []
    for name in sorted(snap["counters"]):
        m = _prom_name(name) + "_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_prom_num(snap['counters'][name])}")
    for name in sorted(snap["gauges"]):
        m = _prom_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_prom_num(snap['gauges'][name])}")
    for name in sorted(snap["histograms"]):
        h = snap["histograms"][name]
        m = _prom_name(name)
        lines.append(f"# TYPE {m} summary")
        for q_label, q_key in (("0.5", "p50"), ("0.9", "p90"),
                               ("0.99", "p99")):
            lines.append(
                f'{m}{{quantile="{q_label}"}} {_prom_num(h[q_key])}')
        lines.append(f"{m}_sum {_prom_num(h['sum'])}")
        lines.append(f"{m}_count {_prom_num(h['count'])}")
    wm = snap.get("watermarks") or {}
    if wm:
        m = _prom_name("watermarks.backlog_age_s")
        lines.append(f"# TYPE {m} gauge")
        for stream in sorted(wm, key=str):
            age = wm[stream].get("backlog_age_s", 0.0)
            label = _NAME_BAD.sub("_", str(stream))
            lines.append(f'{m}{{stream="{label}"}} {_prom_num(age)}')
    return "\n".join(lines) + "\n"
