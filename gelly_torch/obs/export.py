"""Chrome-trace-event JSON export (Perfetto-loadable).

The exported object is the Chrome Trace Event format's "JSON Object
Format" (the one Perfetto, ``chrome://tracing`` and ``ui.perfetto.dev``
all load):

    {"traceEvents": [...], "displayTimeUnit": "ms",
     "otherData": {"trace_id": ..., "counters": ..., "gauges": ...}}

Tracks: every distinct ``track`` string the tracer recorded (one per
stage/worker — ``compress/w140233…``, ``h2d/slot0``, ``fold``,
``merge_emit``, ``checkpoint``, ``events``) becomes one ``tid`` inside
``pid`` 1, named via ``"M"``-phase ``thread_name`` metadata events so
the viewer shows lanes by stage, not by raw thread id. Span timestamps
are converted from the tracer's seconds to the microseconds the format
requires; instant events carry ``"s": "g"`` (global scope) so they draw
as full-height markers.

Alignment with a device-side ``torch.profiler`` trace: both carry the
tracer's ``trace_id`` (``otherData.trace_id`` here; the
``torch_profiler_start`` / ``torch_profiler_stop`` instants that
``utils.metrics.trace(log_dir, tracer=...)`` records carry it too), so
the two timelines can be opened side by side and matched.

:func:`validate_chrome_trace` is the schema check the tests and the
bench artifact path share — load-bearing validation, not a smoke print.

Multi-host stitching: each host of a coordinated run exports its own
trace file (one ring per process; ``otherData.host`` carries the
``process_index`` identity). :func:`stitch_traces` merges them into a
single timeline — one ``pid`` per host, clocks aligned on the first
``coordination.barrier_agreed`` instant every host recorded (matched by
its ``epoch`` arg), and Perfetto flow arrows (``"s"``/``"f"`` phase
pairs sharing an ``id``) synthesized at every shared barrier so the
viewer draws the cross-host hand-off explicitly.
"""

from __future__ import annotations

import json
from typing import Any

from .tracing import SpanTracer

_US = 1e6  # tracer seconds -> trace-event microseconds

PID = 1


def to_chrome_trace(tracer: SpanTracer, bus=None,
                    extra: dict | None = None) -> dict:
    """Render ``tracer``'s ring (and optionally a bus snapshot) to a
    Chrome-trace dict. ``extra`` merges into ``otherData``."""
    records = tracer.records()
    # Stable track -> tid assignment in first-seen order.
    tids: dict[str, int] = {}
    events: list[dict] = [{
        "ph": "M", "name": "process_name", "pid": PID, "tid": 0,
        "args": {"name": f"gelly_torch:{tracer.trace_id}"},
    }]
    for r in records:
        track = r["track"]
        if track not in tids:
            tids[track] = len(tids) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": PID,
                "tid": tids[track], "args": {"name": track},
            })
    for r in records:
        ev: dict[str, Any] = {
            "name": r["name"], "ph": r["ph"], "cat": "gelly",
            "ts": round(r["ts"] * _US, 3),
            "pid": PID, "tid": tids[r["track"]],
            "args": dict(r["args"], thread=r["thread"]),
        }
        if r["ph"] == "X":
            ev["dur"] = round(r["dur"] * _US, 3)
        elif r["ph"] == "i":
            ev["s"] = "g"
        events.append(ev)
    from .heartbeat import host_fields

    other = {
        "trace_id": tracer.trace_id,
        "span_capacity": tracer.capacity,
        "spans_dropped": tracer.dropped,
        # Host identity (process_index/count, coordinator address):
        # multi-host Perfetto captures — one trace file
        # per host — stay attributable after they leave the machine.
        "host": host_fields(),
    }
    if bus is not None:
        other.update(bus.snapshot())
    if extra:
        other.update(extra)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def write_chrome_trace(path: str, tracer: SpanTracer, bus=None,
                       extra: dict | None = None) -> dict:
    """Validate + write the trace to ``path``; returns the trace dict."""
    trace = to_chrome_trace(tracer, bus=bus, extra=extra)
    validate_chrome_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
        f.write("\n")
    return trace


def validate_chrome_trace(trace: dict) -> None:
    """Raise ``ValueError`` unless ``trace`` is well-formed Chrome-trace
    JSON (object format): JSON-serializable, ``traceEvents`` a list of
    events each carrying ``name``/``ph``/``pid``/``tid``, numeric ``ts``
    on non-metadata phases, numeric non-negative ``dur`` on ``"X"``
    spans, flow events (``"s"``/``"f"``) carrying an ``id`` (and
    ``"bp": "e"`` on the finish side), and every referenced
    ``(pid, tid)`` named by a ``thread_name`` metadata event."""
    if not isinstance(trace, dict):
        raise ValueError(f"trace must be a dict, got {type(trace).__name__}")
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace['traceEvents'] must be a list")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as e:
        raise ValueError(f"trace is not JSON-serializable: {e}") from e
    named_tids = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event #{i} is not a dict")
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event #{i} ({ev.get('name')}) lacks "
                                 f"required key {key!r}")
        ph = ev["ph"]
        if ph == "M":
            if ev["name"] == "thread_name":
                named_tids.add((ev["pid"], ev["tid"]))
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"event #{i} ({ev['name']}): ts must be numeric")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"event #{i} ({ev['name']}): 'X' span needs numeric "
                    f"dur >= 0, got {dur!r}")
        elif ph == "i":
            if ev.get("s") not in ("g", "p", "t"):
                raise ValueError(
                    f"event #{i} ({ev['name']}): instant needs scope "
                    "'s' in g/p/t")
        elif ph in ("s", "f"):
            if "id" not in ev:
                raise ValueError(
                    f"event #{i} ({ev['name']}): flow event needs an 'id'")
            if ph == "f" and ev.get("bp") != "e":
                raise ValueError(
                    f"event #{i} ({ev['name']}): flow finish needs "
                    "'bp': 'e' to bind at the enclosing slice")
        else:
            raise ValueError(f"event #{i}: unexpected phase {ph!r}")
        if ev["tid"] != 0 and (ev["pid"], ev["tid"]) not in named_tids:
            raise ValueError(
                f"event #{i} ({ev['name']}): tid {ev['tid']} has no "
                "thread_name metadata (track unnamed in the viewer)")


def _load_trace(t) -> dict:
    if isinstance(t, dict):
        return t
    with open(t) as f:
        return json.load(f)


def stitch_traces(traces, out_path: str | None = None,
                  barrier_name: str = "coordination.barrier_agreed") -> dict:
    """Merge per-host Chrome traces into one multi-process timeline.

    ``traces`` is a sequence of trace dicts or file paths (one per
    host, as written by :func:`write_chrome_trace`). Each host becomes
    its own ``pid`` (``process_index + 1``; enumeration order when a
    trace carries no host identity), keeping every per-host track lane
    intact. Host clocks are monotonic-from-different-epochs, so they
    are aligned on the first ``barrier_name`` instant **every** host
    recorded (matched by its ``epoch`` arg — the agreement instant is
    the one event all hosts log for the same logical moment); hosts
    missing a shared barrier merge unaligned with offset 0. At every
    shared barrier epoch a Perfetto flow arrow (``"s"`` on the
    reference host, ``"f"``/``"bp": "e"`` on each other host, shared
    ``id``) is synthesized so the cross-host hand-off draws explicitly.

    Validates the stitched trace, optionally writes it to
    ``out_path``, and returns it.
    """
    loaded = [_load_trace(t) for t in traces]
    if not loaded:
        raise ValueError("stitch_traces needs at least one trace")
    hosts: list[tuple[int, dict]] = []
    for i, tr in enumerate(loaded):
        other = tr.get("otherData") or {}
        hinfo = other.get("host") or {}
        idx = hinfo.get("process_index")
        hosts.append((idx if isinstance(idx, int) else i, tr))
    hosts.sort(key=lambda p: p[0])

    def _barriers(tr: dict) -> dict:
        out: dict = {}
        for ev in tr.get("traceEvents", []):
            if ev.get("ph") == "i" and ev.get("name") == barrier_name:
                ep = (ev.get("args") or {}).get("epoch")
                if ep is not None and ep not in out:
                    out[ep] = ev
        return out

    per_host = [_barriers(tr) for _, tr in hosts]
    common = set(per_host[0])
    for b in per_host[1:]:
        common &= set(b)
    # Align on the FIRST shared barrier: offsets shift every host's
    # timeline so that instant lands at the reference host's timestamp.
    offsets: list[float] = []
    for b in per_host:
        if common:
            ep0 = min(common)
            offsets.append(per_host[0][ep0]["ts"] - b[ep0]["ts"])
        else:
            offsets.append(0.0)

    events: list[dict] = []
    host_meta: dict[str, dict] = {}
    for (hidx, tr), off in zip(hosts, offsets):
        pid = hidx + 1
        other = tr.get("otherData") or {}
        host_meta[str(pid)] = {
            "trace_id": other.get("trace_id"),
            "host": other.get("host") or {},
            "clock_offset_us": round(off, 3),
        }
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"host{hidx}:{other.get('trace_id', '')}"},
        })
        for ev in tr.get("traceEvents", []):
            ev = dict(ev)
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue  # replaced by the per-host name above
            ev["pid"] = pid
            if ev.get("ph") != "M":
                ev["ts"] = round(ev["ts"] + off, 3)
            events.append(ev)

    ref_pid = hosts[0][0] + 1
    for ep in sorted(common):
        ref_ev = per_host[0][ep]
        fid = f"barrier-{ep}"
        events.append({
            "ph": "s", "name": "barrier_flow", "cat": "gelly", "id": fid,
            "ts": round(ref_ev["ts"] + offsets[0], 3),
            "pid": ref_pid, "tid": ref_ev["tid"],
        })
        for slot in range(1, len(hosts)):
            bev = per_host[slot][ep]
            events.append({
                "ph": "f", "bp": "e", "name": "barrier_flow",
                "cat": "gelly", "id": fid,
                "ts": round(bev["ts"] + offsets[slot], 3),
                "pid": hosts[slot][0] + 1, "tid": bev["tid"],
            })

    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "stitched_hosts": len(hosts),
            "hosts": host_meta,
            "barrier_epochs": sorted(common),
        },
    }
    validate_chrome_trace(trace)
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(trace, f, indent=1)
            f.write("\n")
    return trace
