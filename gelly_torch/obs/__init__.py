"""Observability runtime: span tracing, event bus, trace export.

The reference delegates ALL of this to Flink's runtime (web UI, metrics
registry, checkpoint stats — SURVEY.md §5: the repo's sole in-tree
instrument is a ``getNetRuntime()`` printout). ``gelly_torch`` re-owns it,
as a copy of ``gelly_tpu/obs`` (host code: no module here imports
``torch``):

- :mod:`~gelly_torch.obs.bus` — a process-wide :class:`EventBus` of
  counters, gauges and structured events. Runtime modules
  (``engine/resilience.py``, ``engine/faults.py``, the pipelined
  executor, ``parallel/sharded_cc.py``) publish here instead of
  log-text-only, so tests and bench assert on runtime behavior
  programmatically (``get_bus().counters[...]``) rather than grepping
  logs.
- :mod:`~gelly_torch.obs.tracing` — a low-overhead per-unit
  :class:`SpanTracer`: every pipeline unit carries its id through
  produce → compress (worker K) → H2D (buffer slot) → fold →
  merge-window close → checkpoint, each span recording thread/worker,
  queue depth and payload sizes into a bounded ring buffer. Disabled
  (the default) the unit path performs ZERO extra allocations — every
  call site is guarded by a plain ``tracer is not None`` check on a
  generator-local binding.
- :mod:`~gelly_torch.obs.export` — Chrome-trace-event JSON
  (Perfetto-loadable): one track per stage/worker, instant events for
  retries/faults/window closes, and the tracer's ``trace_id`` in
  ``otherData`` so a device-side ``torch.profiler`` trace captured around
  the same run (``utils.metrics.trace(log_dir, tracer=...)``) can be
  laid alongside it.
- :mod:`~gelly_torch.obs.heartbeat` — a periodic progress line (eps,
  queue depths, last-retired position, backlog-age watermark, p99 fold
  dispatch) for long streams.
- :mod:`~gelly_torch.obs.histogram` — fixed-memory log-bucketed
  :class:`StreamingHistogram` latency distributions
  (``bus.observe(name, ms)``), recorded at the serving plane's hot
  boundaries only when a tracer is installed or
  :func:`~gelly_torch.obs.bus.recording` is on.
- :mod:`~gelly_torch.obs.watermarks` — per-stream/per-tenant end-to-end
  latency ledgers (``bus.watermarks``): ingress stamps ride the
  exactly-once positions through fold and durability, and the oldest
  unretired stamp IS the backlog-age low watermark QoS gates on.
- :mod:`~gelly_torch.obs.status` — the live STATS introspection endpoint:
  ``python -m gelly_torch.obs.status HOST:PORT`` asks a running ingest
  server for a JSON snapshot mid-stream.
"""

from .bus import (
    EventBus,
    get_bus,
    record_metrics,
    recording,
    scope,
    set_recording,
)
from .export import (
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)
from .heartbeat import Heartbeat
from .histogram import StreamingHistogram
from .tracing import SpanTracer, active_tracer, install
from .watermarks import Watermarks

__all__ = [
    "EventBus",
    "get_bus",
    "scope",
    "recording",
    "record_metrics",
    "set_recording",
    "SpanTracer",
    "active_tracer",
    "install",
    "to_chrome_trace",
    "validate_chrome_trace",
    "write_chrome_trace",
    "Heartbeat",
    "StreamingHistogram",
    "Watermarks",
]
