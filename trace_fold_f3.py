#!/usr/bin/env python3
"""Trace the k = 2 fold's calls in the path of ``chip_smoke.py`` phase F3
on one CUDA card, to see where a call's time goes when it runs slower in
the path than again on its own inputs.

    python3 trace_fold_f3.py [--chunks=5] [--out=chiprun_out]

It runs phase F3's spanner (``sparse_spanner(2^24, 2, 16,
gate_batch=2^14)``, ``merge_every=4``) over the first ``--chunks``
``2^22``-edge chunks of phase 4's stream (seed 17), through the same
``drive`` and ``FoldCheck`` (chunks 1 and 2 kept and checked) as
chip_smoke, three times: once to build and warm everything, once timed
with CUDA events (each fold call in the path, then chunks 1 and 2 again
on their own inputs, warm), and once under ``torch.profiler`` (CPU and
CUDA activities). From the trace it prints, for each fold call, the
device time of its own operations (two memsets, the two prepass kernels,
the chain, the finish), the idle time on its stream inside the call and
just before it (the start event's share of a CUDA-event time that no
operation of the call fills), how far the host ran ahead of the device
when it queued the call, the host's runtime calls in that gap, and the
time other streams' operations overlapped the chain. One JSON line ends
the output; the trace and the per-call table are written under
``--out`` (``trace_fold_f3.json.gz``, ``trace_fold_f3_calls.json``).
Needs a card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import gzip
import json
import os
import sys
import time

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def _arg(name: str, default: str) -> str:
    for a in sys.argv[1:]:
        if a.startswith(f"--{name}="):
            return a.split("=", 1)[1]
    return default


def run_path(torch, cs, device, src, dst, n_chunks: int, profile=None):
    """Phase F3's spanner over the first ``n_chunks`` chunks, the folds
    through ``chip_smoke.FoldCheck`` (chunks 1 and 2 kept): ``(folds,
    stats)``."""
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.ops import kernels

    sp = __import__("gelly_torch.library.spanner", fromlist=["spanner"])
    n = cs.N_VERTICES
    e = n_chunks * cs.CHUNK
    agg = sp.sparse_spanner(n, 2, cs.SPANNER_D, gate_batch=cs.SPANNER_SUB)
    source = EdgeChunkSource(src[:e], dst[:e], chunk_size=cs.CHUNK,
                             table=IdentityVertexTable(n))
    with cs.FoldCheck(torch, kernels, "trace", check=2) as folds:
        if profile is None:
            _, st = cs.drive(torch, device, agg, source, n, e,
                             cs.MERGE_EVERY, 1, None)
        else:
            with profile:
                _, st = cs.drive(torch, device, agg, source, n, e,
                                 cs.MERGE_EVERY, 1, None)
    return folds, st


def device_ops(events):
    """Device operations by stream, each list in start order."""
    by_stream: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            by_stream.setdefault(e["args"].get("stream"), []).append(e)
    for ops in by_stream.values():
        ops.sort(key=lambda e: e["ts"])
    return by_stream


def fold_calls(events) -> list:
    """Per fold call, from the trace: its device operations (found around
    each chain kernel on its stream: the memsets and prepass kernels just
    before it, the finish just after), their busy and idle time, the idle
    time before the call on its stream, the host's lead, the runtime
    calls in the gap, and other streams' overlap with the chain."""
    streams = device_ops(events)
    runtime = sorted((e for e in events if e.get("ph") == "X"
                      and e.get("cat") == "cuda_runtime"),
                     key=lambda e: e["ts"])
    by_corr = {e["args"].get("correlation"): e for e in runtime}
    calls = []
    for stream, ops in streams.items():
        for i, op in enumerate(ops):
            if "fold_k2_chain" not in op["name"] or i < 4:
                continue
            own = ops[i - 4:i + 2]
            first, last = own[0], own[-1]
            span = last["ts"] + last["dur"] - first["ts"]
            busy = sum(o["dur"] for o in own)
            prev = ops[i - 5] if i >= 5 else None
            before = None
            if prev:
                before = first["ts"] - (prev["ts"] + prev["dur"])
            host = by_corr.get(first["args"].get("correlation"))
            lead = first["ts"] - host["ts"] if host else None
            gap_calls: dict = {}
            if host and prev:
                # Runtime calls made while the device sat idle before the
                # call: between the previous operation's end and the call's
                # first operation being queued.
                lo = prev["ts"] + prev["dur"]
                for r in runtime:
                    if r["ts"] >= host["ts"]:
                        break
                    if r["ts"] + r["dur"] > lo:
                        gap_calls[r["name"]] = gap_calls.get(r["name"], 0.0) \
                            + r["dur"]
            c0, c1 = op["ts"], op["ts"] + op["dur"]
            overlap: dict = {}
            for s2, ops2 in streams.items():
                if s2 == stream:
                    continue
                for o in ops2:
                    a = max(c0, o["ts"])
                    b = min(c1, o["ts"] + o["dur"])
                    if b > a:
                        key = o["name"][:60]
                        overlap[key] = overlap.get(key, 0.0) + (b - a)
            calls.append({
                "stream": stream, "device_start_us": first["ts"],
                "ops": [o["name"][:40] for o in own],
                "chain_ms": op["dur"] / 1e3,
                "prepass_ms": (own[2]["dur"] + own[3]["dur"]) / 1e3,
                "finish_ms": last["dur"] / 1e3,
                "memset_ms": (own[0]["dur"] + own[1]["dur"]) / 1e3,
                "span_ms": span / 1e3, "busy_ms": busy / 1e3,
                "idle_in_ms": (span - busy) / 1e3,
                "idle_before_ms": None if before is None else before / 1e3,
                "host_lead_ms": None if lead is None else lead / 1e3,
                "gap_runtime_ms": {k: v / 1e3 for k, v in sorted(
                    gap_calls.items(), key=lambda kv: -kv[1])[:6]},
                "other_streams_over_chain_ms": {
                    k: v / 1e3 for k, v in sorted(
                        overlap.items(), key=lambda kv: -kv[1])[:4]},
            })
    calls.sort(key=lambda c: c["device_start_us"])
    return calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trace_fold_f3: no CUDA device; this script runs on a card "
              "only", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from gelly_torch.ops import _build, kernels

    n_chunks = int(_arg("chunks", "5"))
    out_dir = _arg("out", os.path.join(here, "chiprun_out"))
    os.makedirs(out_dir, exist_ok=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi)
    for res in _build.build_all(["spanner_fold_k2", "spanner_gate"],
                                force=True):
        print(f"build {res.name}: nvcc {res.seconds:.2f} s")
    t = time.perf_counter()
    src, dst = cs.synth_edges(cs.N_EDGES, cs.N_VERTICES, cs.SEED)
    print(f"stream: {cs.N_EDGES} edges in {time.perf_counter() - t:.1f} s; "
          f"the path over its first {n_chunks} chunks of {cs.CHUNK}")

    run_path(torch, cs, device, src, dst, min(n_chunks, 2))  # warm-up
    folds, st = run_path(torch, cs, device, src, dst, n_chunks)
    path_ms = folds.timings()
    host_ms = folds.host_ms
    warm = [cs.fold_warm_ms(torch, kernels, k[0], k[1], k[2])
            for k in folds.kept]
    del folds
    print(f"timed run: wall {st['wall_s']:.4f} s, stage busy s "
          f"{ {k: round(v, 4) for k, v in st['busy'].items()} }")
    print(f"  fold ms in the path (CUDA events) "
          f"{[round(m, 4) for m in path_ms]}; chunks 1-2 again on their "
          f"inputs, warm (mean of {cs.FOLD_REPS}) "
          f"{[round(m, 4) for m in warm]}; the host's ms in each call "
          f"{[round(m, 4) for m in host_ms]}")

    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    folds, st = run_path(torch, cs, device, src, dst, n_chunks, prof)
    traced_ms = folds.timings()
    del folds
    path = os.path.join(out_dir, "trace_fold_f3.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        g.write(f.read())
    os.remove(path)
    calls = fold_calls(events)
    for i, c in enumerate(calls):
        c["event_ms"] = traced_ms[i] if i < len(traced_ms) else None
    with open(os.path.join(out_dir, "trace_fold_f3_calls.json"), "w") as f:
        json.dump(calls, f, indent=1)
    print(f"traced run: wall {st['wall_s']:.4f} s; "
          f"{sum(e.get('cat') == 'kernel' for e in events)} kernels traced, "
          f"{len(calls)} fold calls found")
    for i, c in enumerate(calls):
        print(f"  call {i + 1}: event {c['event_ms']:.4f} ms = idle before "
              f"{c['idle_before_ms']} + span {c['span_ms']:.4f} (chain "
              f"{c['chain_ms']:.4f}, prepass {c['prepass_ms']:.4f}, finish "
              f"{c['finish_ms']:.4f}, memsets {c['memset_ms']:.4f}, idle in "
              f"{c['idle_in_ms']:.4f}); host lead {c['host_lead_ms']} ms; "
              f"runtime calls in the gap {c['gap_runtime_ms']}; other "
              f"streams over the chain {c['other_streams_over_chain_ms']}")
    ok = len(calls) == n_chunks
    print(json.dumps({
        "ok": ok, "device": smi, "chunks": n_chunks,
        "path_ms": path_ms, "path_host_ms": host_ms,
        "warm_ms_chunks_1_2": warm,
        "traced_event_ms": traced_ms,
        "chain_ms": [c["chain_ms"] for c in calls],
        "span_ms": [c["span_ms"] for c in calls],
        "idle_before_ms": [c["idle_before_ms"] for c in calls],
        "idle_in_ms": [c["idle_in_ms"] for c in calls],
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
