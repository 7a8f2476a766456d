"""Coordinated recovery on a real 2-process gloo mesh of the port (CPU
subprocesses).

Mirrors ``tests/test_coordinated_recovery.py``. Each worker (this file,
run as a script) joins a process group through
``gelly_torch.parallel.mesh.initialize_multihost``, folds its own edge
partition through a coordinated ``ResilientRunner`` (checkpoint barriers
and the two-phase commit into a shared store, the cadenced path flatten),
then merges the label forests across the two processes with a
cross-process ``butterfly_merge`` and writes its outputs. The test:

1. runs the golden pass in the test process on the port: every host's
   expected final local state (same folds, same flatten cadence) and the
   merged forest;
2. starts the pair slowed down, waits for a committed manifest, and
   SIGKILLs one host (the leader or the follower) mid-stream — the
   survivor sees the lease expire and dies loudly within its bound;
3. restarts the pair: both hosts re-join at the manifest's position, fold
   only the remaining chunks, and end with local states byte-identical to
   the golden pass, the merged components equal to the numpy oracle's.

A third test exports one trace ring per host and stitches them into one
timeline (``obs.export.stitch_traces``). Inputs are made from seeds with
numpy; tolerance: none.

Worker: ``python tests/test_torch_coordinated_recovery.py <store> <out>
<process> <count> <host:port> <sleep_s> [trace prefix]`` with the
repository root on ``PYTHONPATH``; it prints ``COORD_RESUMED <position>
<chunks folded>`` and ``COORD_OK <process>``.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_EDGES = 768
N_V = 96
CHUNK = 16
CADENCE = 4
NPROCS = 2
# 768 edges / 2 hosts / 16-edge chunks = 24 chunks a host.
CHUNKS_PER_HOST = 24
LEASE_TTL_S = 3.0


def all_edges():
    rng = np.random.default_rng(11)
    pairs = rng.integers(0, N_V, (N_EDGES, 2))
    return [(int(a), int(b)) for a, b in pairs]


def host_stream(pid):
    """Host ``pid``'s partition: a strided slice, equal chunk counts."""
    from gelly_torch import edge_stream_from_edges

    return edge_stream_from_edges(all_edges()[pid::NPROCS],
                                  vertex_capacity=N_V, chunk_size=CHUNK,
                                  device="cpu")


def build_plan():
    from gelly_torch.library.connected_components import (
        connected_components,
    )

    return connected_components(N_V)


def merge_comb(a, b):
    from gelly_torch.ops import unionfind

    return (unionfind.merge_forests(a[0], b[0]), a[1] | b[1])


def write_out(path, parent, seen, merged_parent, merged_seen, position):
    from gelly_torch.engine.checkpoint import save_checkpoint

    save_checkpoint(path, {
        "parent": np.asarray(parent), "seen": np.asarray(seen),
        "merged_parent": np.asarray(merged_parent),
        "merged_seen": np.asarray(merged_seen),
    }, position=position)


def worker(store, out, pid, nprocs, addr, sleep_s, trace_prefix=None):
    import contextlib

    import torch
    import torch.distributed as dist

    from gelly_torch import obs
    from gelly_torch.engine.coordination import (
        CoordinationConfig,
        Coordinator,
        HostIdentity,
    )
    from gelly_torch.engine.resilience import (
        ResilienceConfig,
        ResilientRunner,
    )
    from gelly_torch.parallel import collectives
    from gelly_torch.parallel import mesh as mesh_lib

    mesh_lib.initialize_multihost(addr, nprocs, pid)
    assert mesh_lib.host_info()["process_count"] == nprocs
    stack = contextlib.ExitStack()
    tracer = None
    if trace_prefix:
        # One ring per host: every span and instant of this process,
        # the coordination.barrier_agreed instants the stitcher aligns
        # clocks on included.
        tracer = obs.SpanTracer(capacity=16384, heartbeat_every_s=None)
        stack.enter_context(obs.install(tracer))
    agg = build_plan()
    cpu = torch.device("cpu")

    def step(s, c):
        if sleep_s:
            time.sleep(sleep_s)
        return agg.fold(s, c), None

    coordinator = Coordinator(
        store, HostIdentity(pid, nprocs, coordinator_address=addr),
        CoordinationConfig(lease_ttl=LEASE_TTL_S, poll_s=0.01,
                           barrier_timeout=30.0),
    )
    runner = ResilientRunner(
        step, host_stream(pid), lambda: agg.init(cpu),
        coordinator=coordinator,
        config=ResilienceConfig(checkpoint_every_chunks=CADENCE,
                                watchdog_timeout=60.0),
        flatten_state=agg.flatten, adopt_state=agg.combine,
    )
    try:
        final = runner.run()
    except BaseException as e:  # noqa: BLE001
        # Die hard: the peer is gone, and the process group's teardown
        # would wait on it. The test asserts only rc != 0.
        import traceback

        print("COORD_DEAD", type(e).__name__, e, flush=True)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    # Start-of-run position = final position minus the chunks folded in
    # this incarnation: the resumed pair must re-enter at the manifest's.
    print("COORD_RESUMED", runner.position - runner.stats["chunks"],
          runner.stats["chunks"], flush=True)

    # The cross-host merge over the gloo mesh (the timeWindowAll fan-in).
    mesh = mesh_lib.make_mesh(devices=["cpu"])
    local = [None] * nprocs
    local[pid] = (final.parent, final.seen)
    merged = collectives.butterfly_merge(merge_comb, local, nprocs,
                                         mesh=mesh)[pid]
    write_out(f"{out}.{pid}", final.parent, final.seen, merged[0],
              merged[1], runner.position)
    if tracer is not None:
        obs.write_chrome_trace(f"{trace_prefix}.{pid}.json", tracer)
    stack.close()
    dist.destroy_process_group()
    print("COORD_OK", pid, flush=True)


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
           sys.argv[5], float(sys.argv[6]),
           sys.argv[7] if len(sys.argv) > 7 else None)
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the tests

import json  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_pair(store, out, sleep_s, trace_prefix=None):
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    extra = [trace_prefix] if trace_prefix else []
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), store, out, str(pid),
         str(NPROCS), addr, str(sleep_s)] + extra,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(NPROCS)]


def _golden():
    """Every host's expected final local state, replicating the
    coordinated runner's flatten cadence (a flatten at every barrier
    position, and at the final one past the last cadence point), plus
    the merged forest."""
    import torch

    from gelly_torch.ops import unionfind

    agg = build_plan()
    locals_ = []
    for pid in range(NPROCS):
        s = agg.init(torch.device("cpu"))
        pos = last = 0
        for chunk in host_stream(pid):
            s = agg.fold(s, chunk)
            pos += 1
            if pos - last >= CADENCE:
                s = agg.flatten(s)
                last = pos
        if pos > last:
            s = agg.flatten(s)
        locals_.append(s)
    mp, ms = locals_[0].parent, locals_[0].seen
    for other in locals_[1:]:
        mp = unionfind.merge_forests(mp, other.parent)
        ms = ms | other.seen
    return locals_, mp.numpy(), ms.numpy()


def _load_out(path):
    from gelly_torch.engine.checkpoint import load_checkpoint

    leaves, position, _ = load_checkpoint(path)
    # a dict tree: leaves in sorted-key order
    keys = ["merged_parent", "merged_seen", "parent", "seen"]
    return dict(zip(keys, leaves)), position


def _comps(parent, seen):
    out = {}
    for v in np.nonzero(seen)[0].tolist():
        r = v
        while parent[r] != r:
            r = parent[r]
        out.setdefault(r, set()).add(v)
    return sorted(sorted(c) for c in out.values())


def _oracle_comps():
    from gelly_torch.library.connected_components import cc_labels_numpy

    pairs = np.asarray(all_edges(), dtype=np.int64)
    full = cc_labels_numpy(pairs[:, 0], pairs[:, 1], None, N_V)
    return _comps(np.where(full >= 0, full, np.arange(N_V)), full >= 0)


def _wait_manifest(store, min_epoch, timeout=120.0):
    path = os.path.join(store, "MANIFEST.json")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                man = json.load(f)
            if man.get("epoch", 0) >= min_epoch:
                return man
        except (OSError, json.JSONDecodeError):
            pass
        time.sleep(0.02)
    raise AssertionError(f"no manifest at epoch >= {min_epoch} in {store}")


def _drain(procs, timeout=120.0):
    outs = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    return outs


def _kill_and_restart(tmp_path, victim):
    """Crash ``victim`` (0 = the leader, 1 = the follower) mid-stream,
    restart the pair, and hold the resumed finals to the golden pass."""
    golden, golden_mp, golden_ms = _golden()
    store = str(tmp_path / "store")
    out = str(tmp_path / "run.npz")

    # Run A: slowed, so the kill lands mid-stream after >= 2 committed
    # barriers (position >= 8 of 24).
    procs = _spawn_pair(store, out, sleep_s=0.15)
    try:
        _wait_manifest(store, min_epoch=2)
        os.kill(procs[victim].pid, signal.SIGKILL)
        killed_at = time.monotonic()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    outs = _drain(procs)
    survivor_rc, _, survivor_err = outs[1 - victim]
    assert survivor_rc != 0, "the survivor should abort when its peer dies"
    assert "CoordinationError" in survivor_err, survivor_err[-2000:]
    # The survivor's bound: lease expiry plus one lease-check period.
    assert time.monotonic() - killed_at < 30.0
    man = _wait_manifest(store, min_epoch=2)
    resume_pos = man["position"]
    assert 0 < resume_pos < CHUNKS_PER_HOST, (
        f"kill did not land mid-stream (manifest at {resume_pos})")

    # Run B: a fresh pair over the same store re-joins and finishes.
    procs = _spawn_pair(store, out, sleep_s=0.0)
    outs = _drain(procs)
    for rc, stdout, stderr in outs:
        assert rc == 0, f"restarted worker failed\n{stdout}\n{stderr}"
        assert "COORD_OK" in stdout
        resumed = [ln for ln in stdout.splitlines()
                   if ln.startswith("COORD_RESUMED")][0].split()
        start, folded = int(resumed[1]), int(resumed[2])
        assert start == resume_pos
        assert folded == CHUNKS_PER_HOST - resume_pos > 0

    oracle = _oracle_comps()
    for pid in range(NPROCS):
        got, pos = _load_out(f"{out}.{pid}")
        assert pos == CHUNKS_PER_HOST
        # byte-identical local summaries (the acceptance bar)
        assert got["parent"].tobytes() == golden[pid].parent.numpy().tobytes()
        assert got["seen"].tobytes() == golden[pid].seen.numpy().tobytes()
        assert got["merged_parent"].tobytes() == golden_mp.tobytes()
        assert got["merged_seen"].tobytes() == golden_ms.tobytes()
        assert _comps(got["merged_parent"], got["merged_seen"]) == oracle


@pytest.mark.faults
def test_gloo_sigkill_leader_midstream_resumes_bit_identical(tmp_path):
    """SIGKILL the leader (process 0) mid-window: the restarted pair
    re-joins at the barrier-agreed position and finishes bit-identical
    to the uninterrupted fold."""
    _kill_and_restart(tmp_path, victim=0)


@pytest.mark.faults
def test_gloo_sigkill_follower_midstream_resumes_bit_identical(tmp_path):
    """The same contract with the follower (process 1) killed: the leader
    aborts its next barrier on the dead peer's lease."""
    _kill_and_restart(tmp_path, victim=1)


def test_gloo_per_host_traces_stitch_into_one_timeline(tmp_path):
    """An uninterrupted 2-process run exports one trace ring per host;
    ``stitch_traces`` merges them into one valid timeline — one pid per
    host, clocks aligned on the first shared barrier epoch, and a flow
    pair drawn at every shared barrier."""
    from gelly_torch.obs.export import stitch_traces, validate_chrome_trace

    store = str(tmp_path / "store")
    out = str(tmp_path / "run.npz")
    tprefix = str(tmp_path / "ring")
    outs = _drain(_spawn_pair(store, out, 0.0, tprefix))
    for rc, stdout, stderr in outs:
        assert rc == 0, f"worker failed\n{stdout}\n{stderr}"
        assert "COORD_OK" in stdout

    rings = [f"{tprefix}.{pid}.json" for pid in range(NPROCS)]
    for r in rings:
        with open(r) as f:
            validate_chrome_trace(json.load(f))
    merged_path = str(tmp_path / "stitched.json")
    trace = stitch_traces(rings, out_path=merged_path)
    other = trace["otherData"]
    assert other["stitched_hosts"] == 2
    assert other["barrier_epochs"], "no shared barrier epoch recorded"
    assert {m["host"]["process_index"]
            for m in other["hosts"].values()} == {0, 1}
    pids = {ev["pid"] for ev in trace["traceEvents"]}
    assert pids == {1, 2}
    flows_s = [ev for ev in trace["traceEvents"] if ev["ph"] == "s"]
    flows_f = [ev for ev in trace["traceEvents"] if ev["ph"] == "f"]
    assert len(flows_s) == len(flows_f) == len(other["barrier_epochs"])
    ep0 = other["barrier_epochs"][0]
    at = [ev["ts"] for ev in trace["traceEvents"]
          if ev.get("name") == "coordination.barrier_agreed"
          and (ev.get("args") or {}).get("epoch") == ep0]
    assert len(at) == 2 and abs(at[0] - at[1]) < 1e-6
    with open(merged_path) as f:
        validate_chrome_trace(json.load(f))
