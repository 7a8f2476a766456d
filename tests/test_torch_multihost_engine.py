"""gelly_torch's engine and sharded library over a mesh that spans
processes (gloo CPU subprocesses).

Built as ``tests/test_torch_multihost.py`` is: every worker joins a
``torch.distributed`` process group over gloo on the loopback
(``initialize_multihost``) and builds the global mesh with
``make_mesh(devices=["cpu"] * d)``. Two topologies, one process group
each, every case run in it: 2 processes x 2 shards and 4 processes x 1
shard (S = 4 both). Every process passes the same global stream and
arguments, as every ``jax.distributed`` controller passes the same global
value.

Each worker runs every case twice, on the global mesh and on the port's
single controller (one process, ``Mesh(["cpu"] * S)``), and holds every
emission, state, ``merge_modes`` entry and drop count of the first to the
second. It saves what it got; the test process holds every saved value
equal across the processes (each one is replicated) and equal to
``gelly_tpu``'s run over ``make_mesh(4)`` on the conftest's 8 virtual CPU
devices. The cases:

- ``run_aggregation(mesh=)``: the raw CC plan with the kernel backend
  (its plain version on the CPU) and replicated merges, the plain backend
  with delta merges, the ``merge_stacked`` gather and the
  ``merge_degree`` tree, a sparse codec plan, the compact plan, event-time
  windows with lateness, a pane ring, a fused pair of queries, and a
  checkpoint written at window 2 and resumed by every process (the file's
  entries equal the single controller's byte for byte);
- ``ShardedCC``, ``ShardedDegrees`` with deletions (the skew replay and
  the exchange), ``ShardedSnapshotStream.reduce_on_edges``,
  ``sharded_window_triangles``, ``ShardedExactTriangles`` and the sharded
  sampler.

Inputs are made from seeds with numpy. Tolerance: none, except the
sampler's estimate against ``gelly_tpu`` (``rtol=1e-6``: its ``psum``
groups the float32 partials otherwise); its states are held bit for bit.
Two more tests need no process group: the tenant engine refuses a mesh
that spans processes naming item 8e, and only its two call sites use the
guard.

Worker: ``python tests/test_torch_multihost_engine.py <process> <count>
<host:port> <shards a process> <output directory>`` with the repository
root on ``PYTHONPATH``; it writes ``<process>.npz`` there and prints
``MULTIHOST_ENGINE_OK <process>``.
"""

import os
import re
import socket
import subprocess
import sys
import zipfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_V = 256  # the kernel backend's smallest window-blockable capacity
CHUNK = 32
S = 4  # the global shard count of both topologies


# ---------------------------------------------------------------------- #
# the seeded inputs (workers and the gelly_tpu reference build them alike)


def edges(seed, n=384, n_v=N_V):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n_v, (2, n))
    return src.astype(np.int64), dst.astype(np.int64)


def event_times(seed, n=384):
    """Mostly increasing event times with late stragglers."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 4000, n)).astype(np.int64)
    late = rng.random(n) < 0.1
    ts[late] = np.maximum(ts[late] - rng.integers(50, 400, late.sum()), 0)
    return ts


def deletions(seed):
    """A skewed stream (a hub is the source of most edges, so its owner's
    exchange bucket overflows) whose tail deletes a prefix of its
    edges."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N_V, (2, 512)).astype(np.int64)
    src[:448] = 0
    s2 = np.concatenate([src, src[:96]])
    d2 = np.concatenate([dst, dst[:96]])
    ev = np.concatenate([np.zeros(512, np.int8), np.ones(96, np.int8)])
    return s2, d2, ev


W_V = 48  # the window cases' vertices: dense enough for triangles


def windows_data(seed, n=400):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, W_V, (2, n)).astype(np.int64)
    val = rng.integers(1, 10, n).astype(np.float32)
    ts = np.sort(rng.integers(0, 4000, n)).astype(np.int64)
    src[50:100], dst[50:100] = src[:50], dst[:50]  # duplicates: dedup
    return src, dst, val, ts


def pair_batches(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, N_V, (2, n)).astype(np.int32)
            for n in (100, 37, 150)]


# Each engine case: (plan builder arguments, run_aggregation keywords,
# stream keywords). "t" / "j" pick the package.
ENGINE_CASES = {
    "raw_kernel": (dict(ingest_combine=False, fold_backend="kernel",
                        merge_mode="replicated"), dict(merge_every=2), {}),
    "raw_plain_delta": (dict(ingest_combine=False, fold_backend="plain",
                             merge_mode="delta"), dict(merge_every=3), {}),
    "raw_gather": (dict(ingest_combine=False, merge="gather",
                        merge_mode="replicated"),
                   dict(merge_every=2, fold_batch=2), {}),
    "sparse_codec": (dict(codec="sparse", merge_mode="replicated"),
                     dict(merge_every=4, fold_batch=4), {}),
    "compact": (dict(codec="compact", compact_capacity=N_V,
                     merge_mode="delta"), dict(merge_every=4, fold_batch=4),
                {}),
    "event_time": (dict(ingest_combine=False, merge_mode="delta"),
                   dict(window_ms=600, allowed_lateness=300), "ts"),
    "panes": (dict(ingest_combine=False, windowed=3),
              dict(merge_every=2), {}),
}


def plan(pkg, case):
    import importlib

    cc = importlib.import_module(
        f"{'gelly_tpu' if pkg == 'j' else 'gelly_torch'}.library."
        "connected_components")
    if case == "tree":
        return cc.connected_components_tree(N_V, degree=2)
    kw = dict(ENGINE_CASES[case][0])
    if pkg == "j" and "fold_backend" in kw:  # gelly_tpu's names
        kw["fold_backend"] = {"kernel": "pallas",
                              "plain": "xla"}[kw["fold_backend"]]
    return cc.connected_components(N_V, **kw)


def stream(pkg, src, dst, chunk=CHUNK, n_v=N_V, **kw):
    if pkg == "j":
        from gelly_tpu.core.io import EdgeChunkSource, TimeCharacteristic
        from gelly_tpu.core.stream import edge_stream_from_source
        from gelly_tpu.core.vertices import IdentityVertexTable
        dev = {}
    else:
        from gelly_torch.core.io import EdgeChunkSource, TimeCharacteristic
        from gelly_torch.core.stream import edge_stream_from_source
        from gelly_torch.core.vertices import IdentityVertexTable
        dev = {"device": "cpu"}
    if "timestamps" in kw:
        kw["time"] = TimeCharacteristic.EVENT
    return edge_stream_from_source(EdgeChunkSource(
        src, dst, chunk_size=chunk, table=IdentityVertexTable(n_v), **kw),
        n_v, **dev)


def engine_stream(pkg, case, seed):
    src, dst = edges(seed)
    if case in ENGINE_CASES and ENGINE_CASES[case][2] == "ts":
        return stream(pkg, src, dst, timestamps=event_times(seed))
    return stream(pkg, src, dst)


def run_kw(pkg, mesh, **kw):
    out = dict(ingest_workers=0, prefetch_depth=0, h2d_depth=0, mesh=mesh)
    out.update(kw)
    return out


def leaves(tree):
    """Host numpy leaves of a tree of either package."""
    from gelly_torch.engine.checkpoint import tree_flatten

    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in tree_flatten(tree)[0]]


# ---------------------------------------------------------------------- #
# the cases, as run by the port (each returns {name: list of arrays})


def _aggregate(agg, st, mesh, **kw):
    from gelly_torch.engine.aggregation import run_aggregation

    res = run_aggregation(agg, st, **run_kw("t", mesh, **kw))
    out = {"emissions": [a for e in res for a in leaves(e)]}
    out["merge_modes"] = [np.array([res.stats["merge_modes"]["delta"],
                                    res.stats["merge_modes"]["replicated"]])]
    if "late_edges" in res.stats:
        out["late"] = [np.array([res.stats["late_edges"],
                                 res.stats["windows_closed"]])]
    return out, res.stats


def engine_case(case):
    def run(mesh, out_dir, tag):
        kw = dict(ENGINE_CASES[case][1]) if case in ENGINE_CASES else \
            dict(merge_every=2)
        out, stats = _aggregate(plan("t", case), engine_stream("t", case, 5),
                                mesh, **kw)
        out["h2d"] = [np.array([stats["h2d_bytes"]])]
        return out
    return run


def case_fused(mesh, out_dir, tag):
    from gelly_torch.engine.aggregation import run_aggregation
    from gelly_torch.library.connected_components import cc_query
    from gelly_torch.library.degrees import degrees_query

    src, dst = edges(9)
    res = run_aggregation(None, stream("t", src, dst),
                          queries=[cc_query(N_V), degrees_query(N_V)],
                          **run_kw("t", mesh, merge_every=2))
    out = {"cc": [], "degrees": []}
    for e in res:
        for name in out:
            out[name].extend(leaves(e[name]))
    return out


def case_checkpoint(mesh, out_dir, tag):
    """Stop after window 3's emission (window 2's checkpoint written),
    resume in every process, and read the file."""
    from gelly_torch.engine.aggregation import run_aggregation
    from gelly_torch.engine.checkpoint import load_checkpoint

    path = os.path.join(out_dir, f"ckpt-{tag}.npz")
    agg = plan("t", "raw_plain_delta")
    kw = run_kw("t", mesh, merge_every=2, checkpoint_path=path)
    it = iter(run_aggregation(agg, engine_stream("t", "ckpt", 6), **kw))
    first = [next(it) for _ in range(3)]
    it.close()
    with zipfile.ZipFile(path) as z:
        entries = {n: z.read(n) for n in sorted(z.namelist())}
    summary, position, meta = load_checkpoint(path)
    rest = list(run_aggregation(plan("t", "raw_plain_delta"),
                                engine_stream("t", "ckpt", 6),
                                resume=True, **kw))
    return {"first": [a for e in first for a in leaves(e)],
            "resumed": [a for e in rest for a in leaves(e)],
            "file": leaves(summary) + [np.array([position,
                                                 meta["windows"]])],
            "entries": [np.frombuffer(v, np.uint8) for v in
                        entries.values()]}


def case_sharded_cc(mesh, out_dir, tag):
    from gelly_torch.parallel.sharded_cc import ShardedCC

    cc = ShardedCC(N_V, mesh=mesh)
    out = {"labels": []}
    for a, b in pair_batches(11):
        cc.fold(a, b)
        out["labels"].append(cc.labels())
    st = cc.stats
    out["stats"] = [np.array([st["dropped"], st["rounds"],
                              st["chase_levels"], st["emissions_dense"],
                              st["emissions_sparse"]])]
    return out


def case_degrees(mesh, out_dir, tag):
    from gelly_torch.library.degrees import sharded_degrees

    s2, d2, ev = deletions(12)
    out = {}
    for mode, slack in (("auto", 1.0), ("exchange", 4.0)):
        sd = sharded_degrees(stream("t", s2, d2, chunk=256, events=ev),
                             mesh=mesh, mode=mode, bucket_slack=slack)
        got = sd.final_degrees()
        keys = np.array(sorted(got), np.int64)
        out[mode] = [keys, np.array([got[k] for k in keys], np.int64),
                     np.array([sd.stats["dropped"],
                               sd.stats["fallback_chunks"]])]
    return out


def _collect(updates):
    out = []
    for upd in updates:
        ok = np.asarray(upd.valid).astype(bool)
        out += [np.array([upd.window]), np.asarray(upd.slots)[ok],
                np.asarray(upd.values)[ok]]
    return out


def case_window_reduce(mesh, out_dir, tag):
    from gelly_torch.parallel.sharded_window import sharded_slice

    src, dst, val, ts = windows_data(13)
    st = stream("t", src, dst, val=val, timestamps=ts, n_v=W_V)
    return {"reduce": _collect(sharded_slice(
        st, 1000, "all", window_capacity=2 * len(src), mesh=mesh
    ).reduce_on_edges(torch.minimum))}


def case_window_triangles(mesh, out_dir, tag):
    from gelly_torch.library.triangles import sharded_window_triangles

    src, dst, _, ts = windows_data(14, 600)
    got = [(w, int(c)) for w, c in sharded_window_triangles(
        stream("t", src, dst, timestamps=ts, n_v=W_V), 1000,
        window_capacity=2400,
        mesh=mesh)]
    return {"counts": [np.array(got, np.int64)]}


def case_exact(mesh, out_dir, tag):
    from gelly_torch.library.sharded_triangles import ShardedExactTriangles

    src, dst = edges(15, 700, 256)
    t = ShardedExactTriangles(stream("t", src, dst, chunk=64, n_v=256),
                              max_degree=32, mesh=mesh).run()
    got = t.final_counts()
    keys = np.array(sorted(got), np.int64)
    return {"counts": [keys, np.array([got[k] for k in keys], np.int64),
                       np.array([t.total, t.n_seen, t.overflow])]}


def case_sampler(mesh, out_dir, tag):
    from gelly_torch.library.triangles import SamplerState, \
        sharded_sampler_run
    from gelly_torch.parallel.mesh import all_gather_shards

    src, dst = edges(16, 300, 48)
    out = {"states": [], "estimates": []}
    for states, est in sharded_sampler_run(
            stream("t", src, dst, chunk=128, n_v=48), 64, mesh, seed=9):
        full = all_gather_shards(mesh, states)
        for f in SamplerState._fields:
            parts = [getattr(s, f) for s in full]
            out["states"].append(
                torch.cat(parts).numpy() if parts[0].dim()
                else parts[0].numpy())
        out["estimates"].append(np.array([est], np.float64))
    return out


CASES = {name: engine_case(name) for name in ENGINE_CASES}
CASES.update({"tree": engine_case("tree"), "fused": case_fused,
              "checkpoint": case_checkpoint, "sharded_cc": case_sharded_cc,
              "degrees": case_degrees, "window_reduce": case_window_reduce,
              "window_triangles": case_window_triangles,
              "exact": case_exact, "sampler": case_sampler})


def _check_same(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for name in want:
        assert len(got[name]) == len(want[name]), (what, name)
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (
                what, name, i, a.dtype, b.dtype, a.shape, b.shape)
            assert a.tobytes() == b.tobytes(), (what, name, i)


def worker(pid: int, nprocs: int, addr: str, devs: int, out_dir: str):
    import torch.distributed as dist

    from gelly_torch.parallel import mesh as mesh_lib

    mesh_lib.initialize_multihost(addr, nprocs, pid)
    try:
        mesh = mesh_lib.make_mesh(devices=["cpu"] * devs)
        assert mesh.num_shards == S == nprocs * devs
        ref = mesh_lib.Mesh(["cpu"] * S)
        arrays = {}
        for case, fn in CASES.items():
            got = fn(mesh, out_dir, "multi")
            want = fn(ref, out_dir, f"single-{pid}")
            if case in ENGINE_CASES or case == "tree":
                # Each process copies only its own shards to the device.
                h2d = int(got.pop("h2d")[0][0])
                full = int(want.pop("h2d")[0][0])
                assert 0 < h2d and h2d * S == full * devs, (
                    case, h2d, full)
            _check_same(got, want, case)
            for name, vals in got.items():
                for i, v in enumerate(vals):
                    arrays[f"{case}/{name}/{i}"] = np.asarray(v)
        np.savez(os.path.join(out_dir, f"{pid}.npz"), **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("MULTIHOST_ENGINE_OK", pid, flush=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
           int(sys.argv[4]), sys.argv[5])
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the tests

import pytest  # noqa: E402

TOPOLOGIES = {"2x2": (2, 2), "4x1": (4, 1)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(nprocs: int, devs: int, out_dir, timeout: float = 240):
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), str(nprocs),
         addr, str(devs), str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"{nprocs}x{devs} workers timed out")
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed rc={rc}\n{out}\n{err[-4000:]}"
        assert f"MULTIHOST_ENGINE_OK {pid}" in out
    got = []
    for pid in range(nprocs):
        with np.load(os.path.join(out_dir, f"{pid}.npz")) as z:
            got.append({k: z[k] for k in z.files})
    return got


@pytest.fixture(scope="module", params=sorted(TOPOLOGIES))
def topology(request, tmp_path_factory):
    """One process group per topology, every case run in it: each
    process's saved results."""
    nprocs, devs = TOPOLOGIES[request.param]
    return _run_workers(nprocs, devs, tmp_path_factory.mktemp(request.param))


def _case(results: list, case: str) -> dict:
    """The case's values, held equal across the processes (each one is
    replicated): ``{name: [arrays]}``."""
    first = results[0]
    for pid, r in enumerate(results[1:], 1):
        assert sorted(r) == sorted(first), pid
        for k in first:
            assert r[k].dtype == first[k].dtype and \
                r[k].tobytes() == first[k].tobytes(), (pid, k)
    out: dict = {}
    for k in first:
        c, name, i = k.split("/")
        if c == case:
            out.setdefault(name, {})[int(i)] = first[k]
    assert out, case
    return {n: [v[i] for i in range(len(v))] for n, v in out.items()}


_JAX: dict = {}


def _jax(case: str) -> dict:
    if case not in _JAX:
        _JAX[case] = JAX_CASES[case]()
    return _JAX[case]


def _jmesh():
    from gelly_tpu.parallel import mesh as jmesh

    return jmesh.make_mesh(S)


def _j_aggregate(agg, st, **kw):
    from gelly_tpu.engine.aggregation import run_aggregation

    res = run_aggregation(agg, st, **run_kw("j", _jmesh(), **kw))
    out = {"emissions": [a for e in res for a in leaves(e)]}
    out["merge_modes"] = [np.array([res.stats["merge_modes"]["delta"],
                                    res.stats["merge_modes"]["replicated"]])]
    if "late_edges" in res.stats:
        out["late"] = [np.array([res.stats["late_edges"],
                                 res.stats["windows_closed"]])]
    return out


def _j_engine(case):
    def run():
        kw = dict(ENGINE_CASES[case][1]) if case in ENGINE_CASES else \
            dict(merge_every=2)
        return _j_aggregate(plan("j", case), engine_stream("j", case, 5),
                            **kw)
    return run


def _j_fused():
    from gelly_tpu.engine.aggregation import run_aggregation
    from gelly_tpu.library.connected_components import cc_query
    from gelly_tpu.library.degrees import degrees_query

    src, dst = edges(9)
    res = run_aggregation(None, stream("j", src, dst),
                          queries=[cc_query(N_V), degrees_query(N_V)],
                          **run_kw("j", _jmesh(), merge_every=2))
    out = {"cc": [], "degrees": []}
    for e in res:
        for name in out:
            out[name].extend(leaves(e[name]))
    return out


def _j_checkpoint():
    import tempfile

    from gelly_tpu.engine.aggregation import run_aggregation
    from gelly_tpu.engine.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        kw = run_kw("j", _jmesh(), merge_every=2, checkpoint_path=path)
        it = iter(run_aggregation(plan("j", "raw_plain_delta"),
                                  engine_stream("j", "ckpt", 6), **kw))
        first = [next(it) for _ in range(3)]
        it.close()
        summary, position, meta = load_checkpoint(path)
        rest = list(run_aggregation(plan("j", "raw_plain_delta"),
                                    engine_stream("j", "ckpt", 6),
                                    resume=True, **kw))
    return {"first": [a for e in first for a in leaves(e)],
            "resumed": [a for e in rest for a in leaves(e)],
            "file": leaves(summary) + [np.array([position,
                                                 meta["windows"]])]}


def _j_sharded_cc():
    from gelly_tpu.parallel.sharded_cc import ShardedCC

    cc = ShardedCC(N_V, mesh=_jmesh())
    out = {"labels": []}
    for a, b in pair_batches(11):
        cc.fold(a, b)
        out["labels"].append(np.asarray(cc.labels()))
    return out


def _j_degrees():
    from gelly_tpu.library.degrees import sharded_degrees

    s2, d2, ev = deletions(12)
    out = {}
    for mode, slack in (("auto", 1.0), ("exchange", 4.0)):
        sd = sharded_degrees(stream("j", s2, d2, chunk=256, events=ev),
                             mesh=_jmesh(), mode=mode, bucket_slack=slack)
        got = sd.final_degrees()
        keys = np.array(sorted(got), np.int64)
        out[mode] = [keys, np.array([got[k] for k in keys], np.int64),
                     np.array([sd.stats["dropped"],
                               sd.stats["fallback_chunks"]])]
    return out


def _j_window_reduce():
    import jax.numpy as jnp

    from gelly_tpu.parallel.sharded_window import sharded_slice

    src, dst, val, ts = windows_data(13)
    st = stream("j", src, dst, val=val, timestamps=ts, n_v=W_V)
    return {"reduce": _collect(sharded_slice(
        st, 1000, "all", window_capacity=2 * len(src), mesh=_jmesh()
    ).reduce_on_edges(jnp.minimum))}


def _j_window_triangles():
    from gelly_tpu.library.triangles import sharded_window_triangles

    src, dst, _, ts = windows_data(14, 600)
    got = [(w, int(c)) for w, c in sharded_window_triangles(
        stream("j", src, dst, timestamps=ts, n_v=W_V), 1000,
        window_capacity=2400,
        mesh=_jmesh())]
    return {"counts": [np.array(got, np.int64)]}


def _j_exact():
    from gelly_tpu.library.sharded_triangles import ShardedExactTriangles

    src, dst = edges(15, 700, 256)
    t = ShardedExactTriangles(stream("j", src, dst, chunk=64, n_v=256),
                              max_degree=32, mesh=_jmesh()).run()
    got = t.final_counts()
    keys = np.array(sorted(got), np.int64)
    return {"counts": [keys, np.array([got[k] for k in keys], np.int64),
                       np.array([t.total, t.n_seen, t.overflow])]}


def _j_sampler():
    import jax
    import jax.numpy as jnp

    from gelly_tpu.library import triangles as jtri

    src, dst = edges(16, 300, 48)
    st = stream("j", src, dst, chunk=128, n_v=48)
    step = jax.jit(jtri._sampler_step)
    state = jtri._fresh_sampler(64, 9)
    out = {"states": [], "estimates": []}
    for c in st:
        state = step(state, c, jnp.int32(st.ctx.table.num_vertices))
        for f in jtri.SamplerState._fields:
            x = np.asarray(getattr(state, f))
            out["states"].append(x.astype(np.uint32).astype(np.int64)
                                 if f == "keys" else x)
        out["estimates"].append(np.array([jtri.sampler_estimate(state)],
                                         np.float64))
    return out


JAX_CASES = {name: _j_engine(name) for name in ENGINE_CASES}
JAX_CASES.update({"tree": _j_engine("tree"), "fused": _j_fused,
                  "checkpoint": _j_checkpoint, "sharded_cc": _j_sharded_cc,
                  "degrees": _j_degrees, "window_reduce": _j_window_reduce,
                  "window_triangles": _j_window_triangles,
                  "exact": _j_exact, "sampler": _j_sampler})


def _hold_to_jax(got: dict, want: dict, case: str) -> None:
    for name in want:
        assert len(got[name]) == len(want[name]), (case, name)
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            assert a.shape == b.shape, (case, name, i, a.shape, b.shape)
            if name == "estimates":
                np.testing.assert_allclose(a, b, rtol=1e-6)
                continue
            if case == "sampler" and a.dtype != b.dtype:
                # The port keeps the u32 key words in i64 lanes.
                b = b.astype(a.dtype)
            assert a.dtype == b.dtype, (case, name, i, a.dtype, b.dtype)
            assert a.tobytes() == b.tobytes(), (case, name, i)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES) + ["tree"])
def test_engine_across_processes_equals_jax(topology, case):
    got = _case(topology, case)
    _hold_to_jax(got, _jax(case), case)
    assert got["emissions"]


def test_fused_queries_across_processes_equal_jax(topology):
    _hold_to_jax(_case(topology, "fused"), _jax("fused"), "fused")


def test_checkpoint_across_processes_resumes_and_equals_jax(topology):
    got = _case(topology, "checkpoint")
    # Written at window 2 (the consumer stopped after emission 3).
    assert int(got["file"][-1][1]) == 2
    entries = got.pop("entries")
    assert entries and all(e.size for e in entries)
    _hold_to_jax(got, _jax("checkpoint"), "checkpoint")


@pytest.mark.parametrize("case", ["sharded_cc", "degrees", "window_reduce",
                                  "window_triangles", "exact", "sampler"])
def test_sharded_library_across_processes_equals_jax(topology, case):
    got = _case(topology, case)
    want = _jax(case)
    if case == "sharded_cc":
        stats = got.pop("stats")[0]
        assert stats[0] == 0  # no exchange drop
    if case == "degrees":
        assert got["auto"][2][1] > 0  # the skew replay ran
    if case == "window_triangles":
        assert got["counts"][0][:, 1].sum() > 0
    _hold_to_jax(got, want, case)


def test_tenant_engine_refuses_a_mesh_across_processes():
    from gelly_torch.engine.tenants import MultiTenantEngine, TenantBatch
    from gelly_torch.library import connected_components as cc
    from gelly_torch.parallel.mesh import Mesh

    mesh = Mesh(["cpu", None], processes=[0, 1], process_index=0)
    with pytest.raises(NotImplementedError, match="item 8e"):
        MultiTenantEngine(mesh=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8e"):
        TenantBatch(cc.connected_components(N_V, ingest_combine=False), 32,
                    mesh=mesh, device="cpu")


def test_one_process_guard_only_at_the_tenant_engine():
    sites = []
    pkg = os.path.join(ROOT, "gelly_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if re.search(r"\brequire_one_process\(", line) \
                                and "def require_one_process" not in line:
                            sites.append((os.path.relpath(path, pkg),
                                          line.strip()))
    assert sorted(sites) == [
        ("engine/tenants.py",
         'require_one_process(mesh, "MultiTenantEngine(mesh=...)")'),
        ("engine/tenants.py",
         'require_one_process(mesh, "TenantBatch(mesh=...)")'),
    ]
