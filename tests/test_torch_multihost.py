"""gelly_torch's mesh across processes on gloo (CPU subprocesses).

Mirrors ``tests/test_multihost.py`` on the port: every worker joins a
``torch.distributed`` process group over gloo through
``gelly_torch.parallel.mesh.initialize_multihost`` on the loopback, builds
the global mesh with ``make_mesh(devices=["cpu"] * d)`` and runs its body:

- 2 processes: the join, the global mesh and a psum; per-host CC forests
  merged by a cross-process butterfly; the keyed exchange;
- 4 processes x 2 shards: the butterfly and ``hierarchical_merge(degree
  = 4)``, whose phase-2 leader hop crosses processes; the keyed exchange
  over 8 shards.

Each worker holds its cross-process results, bit for bit, to the same
merge or exchange on the port's single-controller CPU mesh of S shards,
and the CC merges to ``cc_labels_numpy``'s components. It then saves its
shards' results; the test process runs the same inputs through
``gelly_tpu``'s collectives and ``repartition_by_key`` in a ``shard_map``
over ``make_mesh(S)`` on the conftest's 8 virtual CPU devices, and holds
every saved shard to it bit for bit. Two more cases: rounds whose both
partners are in other processes (a process idle in a round must not
block, and must not take another pair's message), and ``keep=`` across
processes, both with a combine that is not commutative, so the schedule
and the argument order show (``gelly_tpu`` has no ``keep=``: a kept
shard equals its full merge's). Inputs are made from seeds with numpy;
tolerance: none.

Worker: ``python tests/test_torch_multihost.py <case> <process> <count>
<host:port> <shards a process> <output directory>`` with the repository
root on ``PYTHONPATH``; it writes ``<case>-<process>.npz`` there and
prints ``MULTIHOST_OK <case> <process>``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _comps(parent, seen):
    out = {}
    for v in np.nonzero(seen)[0].tolist():
        r = v
        while parent[r] != r:
            r = parent[r]
        out.setdefault(r, set()).add(v)
    return sorted(sorted(c) for c in out.values())


def _forest(src, dst, n_v):
    from gelly_torch.library.connected_components import cc_labels_numpy

    lab = cc_labels_numpy(src, dst, None, n_v)
    parent = np.where(lab >= 0, lab, np.arange(n_v)).astype(np.int32)
    return parent, lab >= 0


def _local(mesh, values):
    """The list of S with ``None`` at shards other processes hold."""
    return [v if mesh.devices[i] is not None else None
            for i, v in enumerate(values)]


def _equal_trees(a, b) -> bool:
    from gelly_torch.engine.checkpoint import tree_flatten

    fa, fb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(fa, fb))


def _check_kept(mesh, got, want, what):
    for i in range(mesh.num_shards):
        if mesh.devices[i] is None or want[i] is None:
            assert got[i] is None, (what, i)
        else:
            assert _equal_trees(got[i], want[i]), (what, i)


# The seeded inputs of each case, as numpy: the workers and the
# gelly_tpu reference in the test process build them alike.
def psum_inputs(S):
    return np.arange(1, S + 1, dtype=np.float32)[:, None]


def exchange_inputs(S, L=64):
    rng = np.random.default_rng(7)  # same seed everywhere: global view
    keys = rng.integers(0, 32, (S, L)).astype(np.int32)
    pay = rng.integers(0, 1000, (S, L)).astype(np.int32)
    ok = rng.random((S, L)) < 0.9
    return keys, {"p": pay, "w": pay.astype(np.int64) * 3}, ok


def idle_inputs(S):
    return np.random.default_rng(11).integers(0, 100, (S, 6)).astype(
        np.int64)


def keep_inputs(S):
    return np.random.default_rng(13).integers(0, 100, (S, 5)).astype(
        np.int64)


IDLE_KEEPS = lambda S: ([0], [S - 1])  # noqa: E731
KEEP_KEEPS = lambda S: ([1, S - 2], list(range(S)), [0])  # noqa: E731


def case_psum(mesh, ref):
    from gelly_torch.parallel import collectives, mesh as mesh_lib

    info = mesh_lib.host_info()
    assert info["process_count"] == mesh.process_count
    assert info["process_index"] == mesh.process_index
    S = mesh.num_shards
    vals = [(torch.from_numpy(r.copy()),) for r in psum_inputs(S)]
    got = collectives.psum_tree(_local(mesh, vals), mesh=mesh)
    want = collectives.psum_tree(vals, mesh=ref)
    _check_kept(mesh, got, want, "psum")
    for i in mesh.local_shards:
        assert float(got[i][0]) == S * (S + 1) / 2
    return {"psum": got}


def _cc_states(S, n_v, n_e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_v, n_e).astype(np.int32)
    dst = rng.integers(0, n_v, n_e).astype(np.int32)
    states = []
    for d in range(S):  # every shard folds its OWN edge partition
        parent, seen = _forest(src[d::S], dst[d::S], n_v)
        states.append((torch.from_numpy(parent), torch.from_numpy(seen)))
    full = _forest(src, dst, n_v)
    return states, _comps(*full)


def _cc_comb(a, b):
    from gelly_torch.ops import unionfind

    return (unionfind.merge_forests(a[0], b[0]), a[1] | b[1])


def case_cc(mesh, ref, n_e=300, seed=3):
    from gelly_torch.parallel import collectives

    S = mesh.num_shards
    states, want_comps = _cc_states(S, 64, n_e, seed)
    schedules = [("butterfly", lambda s, m: collectives.butterfly_merge(
        _cc_comb, s, S, mesh=m))]
    if S > 2:
        # degree = the process count: phase 1 stays inside each process,
        # phase 2's leader hop crosses processes.
        schedules.append(("hierarchical", lambda s, m: (
            collectives.hierarchical_merge(
                _cc_comb, s, S, mesh.process_count, mesh=m))))
    out = {}
    for name, merge in schedules:
        got = merge(_local(mesh, states), mesh)
        want = merge([tuple(x.clone() for x in s) for s in states], ref)
        _check_kept(mesh, got, want, name)
        for i in mesh.local_shards:
            comps = _comps(got[i][0].numpy(), got[i][1].numpy())
            assert comps == want_comps, (name, i)
        out[name] = got
    return out


CC_ARGS = {"cc": (300, 3), "cc4": (800, 9)}  # case: (edges, seed)


def case_cc4(mesh, ref):
    return case_cc(mesh, ref, *CC_ARGS["cc4"])


def case_exchange(mesh, ref):
    from gelly_torch.parallel import partition

    S = mesh.num_shards
    L = 64
    keys, payload, ok = exchange_inputs(S, L)
    pay = payload["p"]

    def args():
        return ([torch.from_numpy(keys[i].copy()) for i in range(S)],
                [{k: torch.from_numpy(v[i].copy())
                  for k, v in payload.items()} for i in range(S)],
                [torch.from_numpy(ok[i].copy()) for i in range(S)])

    out = {}
    for bucket in (L, 4):  # worst case always fits; then overflow
        k, p, v = args()
        got = partition.repartition_by_key(
            mesh, _local(mesh, k), _local(mesh, p), _local(mesh, v), S,
            bucket)
        want = partition.repartition_by_key(ref, *args(), S, bucket)
        for g, w in zip(got, want):
            _check_kept(mesh, g, w, f"exchange bucket {bucket}")
        for d in mesh.local_shards:
            lk, lv = got[0][d].numpy(), got[2][d].numpy()
            assert (lk[lv] % S == d).all()  # striped ownership
            if bucket == L:
                mine = ok & (keys % S == d)
                assert sorted(zip(lk[lv].tolist(),
                                  got[1][d]["p"].numpy()[lv].tolist())) \
                    == sorted(zip(keys[mine].tolist(), pay[mine].tolist()))
                assert int(got[3][d]) == 0
        assert mesh.sent_bytes > 0 and mesh.received_bytes > 0
        out[f"exchange{bucket}"] = [
            None if got[0][d] is None else
            (got[0][d], got[1][d], got[2][d],
             torch.tensor(int(got[3][d]), dtype=torch.int64))
            for d in range(S)]
    return out


def _nc_comb(a, b):
    """Not commutative: the argument order and schedule show."""
    return (a[0] * 3 + b[0],)


def case_idle_rounds(mesh, ref):
    """Rounds in which this process holds neither partner: with one shard
    a process, the hierarchical phase-2 hop (degree 2) joins shards 0 and
    2 only, and a butterfly kept at one shard leaves most processes idle
    in its last rounds."""
    from gelly_torch.parallel import collectives

    S = mesh.num_shards
    data = idle_inputs(S)

    def vals():
        return [(torch.from_numpy(data[i].copy()),) for i in range(S)]

    out = {}
    for degree in (1, 2, S):
        got = collectives.hierarchical_merge(
            _nc_comb, _local(mesh, vals()), S, degree, mesh=mesh)
        want = collectives.hierarchical_merge(_nc_comb, vals(), S, degree,
                                              mesh=ref)
        _check_kept(mesh, got, want, f"hierarchical degree {degree}")
        out[f"hierarchical{degree}"] = got
    for keep in IDLE_KEEPS(S):
        got = collectives.butterfly_merge(
            _nc_comb, _local(mesh, vals()), S, mesh=mesh, keep=keep)
        want = collectives.butterfly_merge(_nc_comb, vals(), S, mesh=ref,
                                           keep=keep)
        _check_kept(mesh, got, want, f"butterfly keep {keep}")
        out[_keep_name("butterfly", keep)] = got
    got = collectives.gather_merge(
        _idle_stacked, _local(mesh, vals()), mesh=mesh, keep=[S - 1])
    want = collectives.gather_merge(_idle_stacked, vals(), mesh=ref,
                                    keep=[S - 1])
    _check_kept(mesh, got, want, "gather keep")
    out[_keep_name("gather", [S - 1])] = got
    return out


def _idle_stacked(st):
    return (st[0][0] * 5 + st[0].sum(0),)


def _keep_stacked(st):
    return (st[0].sum(0) * 7 + st[0][-1],)


def _keep_name(merge, keep):
    return merge + "-keep-" + "-".join(map(str, keep))


def case_keep(mesh, ref):
    """``keep=`` across processes: the kept shards' results equal the
    single controller's, every other entry is None."""
    from gelly_torch.parallel import collectives

    S = mesh.num_shards
    data = keep_inputs(S)

    def vals():
        return [(torch.from_numpy(data[i].copy()),) for i in range(S)]

    out = {}
    for keep in KEEP_KEEPS(S):
        got = collectives.butterfly_merge(
            _nc_comb, _local(mesh, vals()), S, mesh=mesh, keep=keep)
        want = collectives.butterfly_merge(_nc_comb, vals(), S, mesh=ref,
                                           keep=keep)
        _check_kept(mesh, got, want, f"keep {keep}")
        out[_keep_name("butterfly", keep)] = got
        got = collectives.gather_merge(
            _keep_stacked, _local(mesh, vals()), mesh=mesh, keep=keep)
        want = collectives.gather_merge(_keep_stacked, vals(), mesh=ref,
                                        keep=keep)
        _check_kept(mesh, got, want, f"gather keep {keep}")
        out[_keep_name("gather", keep)] = got
    return out


CASES = {"psum": case_psum, "cc": case_cc, "cc4": case_cc4,
         "exchange": case_exchange, "idle": case_idle_rounds,
         "keep": case_keep}


def save_results(path: str, results: dict) -> None:
    """One ``.npz`` of this process's results: ``<name>__<shard>__<leaf>``
    for every shard it holds, leaves in ``jax.tree.flatten``'s order."""
    from gelly_torch.engine.checkpoint import tree_flatten

    arrays = {}
    for name, per_shard in results.items():
        for shard, tree in enumerate(per_shard):
            if tree is not None:
                for j, leaf in enumerate(tree_flatten(tree)[0]):
                    arrays[f"{name}__{shard}__{j}"] = leaf.numpy()
    np.savez(path, **arrays)


def worker(case: str, pid: int, nprocs: int, addr: str, devs: int,
           out_dir: str) -> None:
    import torch.distributed as dist

    from gelly_torch.parallel import mesh as mesh_lib

    mesh_lib.initialize_multihost(addr, nprocs, pid)
    try:
        mesh = mesh_lib.make_mesh(devices=["cpu"] * devs)
        assert mesh.num_shards == nprocs * devs
        assert mesh.local_shards == tuple(range(pid * devs,
                                                (pid + 1) * devs))
        ref = mesh_lib.Mesh(["cpu"] * mesh.num_shards)
        results = CASES[case](mesh, ref)
        save_results(os.path.join(out_dir, f"{case}-{pid}.npz"), results)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("MULTIHOST_OK", case, pid, flush=True)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           int(sys.argv[5]), sys.argv[6])
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the tests

import pytest  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jrun(S, body, *args):
    """gelly_tpu: a jitted ``shard_map`` of ``body`` over ``make_mesh(S)``,
    every input and output split on its leading axis; numpy leaves of
    each shard's output."""
    import jax
    from jax.sharding import PartitionSpec as P

    from gelly_tpu.parallel import mesh as jmesh

    f = jmesh.shard_map_fn(jmesh.make_mesh(S), body,
                           in_specs=(P("shards"),) * len(args),
                           out_specs=P("shards"))
    leaves = [np.asarray(x) for x in jax.tree.leaves(jax.jit(f)(*args))]
    return [[x[i] for x in leaves] for i in range(S)]


def _jax_results(case: str, S: int, nprocs: int) -> dict:
    """Each result name of ``case``: (the shards it is kept at, gelly_tpu's
    leaves at every shard) on the inputs the workers used."""
    import jax.numpy as jnp

    from gelly_tpu.ops import unionfind as juf
    from gelly_tpu.parallel import collectives as jcol
    from gelly_tpu.parallel import partition as jpart

    every = set(range(S))

    def nc(a, b):
        return (a[0] * 3 + b[0],)

    if case == "psum":
        return {"psum": (every, _jrun(
            S, lambda v: (jcol.psum_tree(v[0])[None],), psum_inputs(S)))}
    if case in CC_ARGS:
        states, _ = _cc_states(S, 64, *CC_ARGS[case])
        parent = np.stack([p.numpy() for p, _ in states])
        seen = np.stack([s.numpy() for _, s in states])

        def comb(a, b):
            return (juf.merge_forests(a[0], b[0]), a[1] | b[1])

        def lift(out):
            return tuple(x[None] for x in out)

        out = {"butterfly": (every, _jrun(S, lambda p, s: lift(
            jcol.butterfly_merge(comb, (p[0], s[0]), S)), parent, seen))}
        if S > 2:
            out["hierarchical"] = (every, _jrun(S, lambda p, s: lift(
                jcol.hierarchical_merge(comb, (p[0], s[0]), S, nprocs)),
                parent, seen))
        return out
    if case == "exchange":
        keys, payload, ok = exchange_inputs(S)
        out = {}
        for bucket in (keys.shape[1], 4):
            def body(k, p, v, b=bucket):
                k2, p2, v2, dropped = jpart.repartition_by_key(
                    k[0], {n: x[0] for n, x in p.items()}, v[0], S, b)
                return (k2[None], {n: x[None] for n, x in p2.items()},
                        v2[None], dropped.astype(jnp.int64)[None])

            out[f"exchange{bucket}"] = (
                every, _jrun(S, body, keys, payload, ok))
        return out
    if case == "idle":
        data = idle_inputs(S)
        out = {}
        for degree in (1, 2, S):
            out[f"hierarchical{degree}"] = (every, _jrun(
                S, lambda v, d=degree: (jcol.hierarchical_merge(
                    nc, (v[0],), S, d)[0][None],), data))
        full = _jrun(S, lambda v: (jcol.butterfly_merge(
            nc, (v[0],), S)[0][None],), data)
        for keep in IDLE_KEEPS(S):
            out[_keep_name("butterfly", keep)] = (set(keep), full)
        out[_keep_name("gather", [S - 1])] = ({S - 1}, _jrun(
            S, lambda v: (jcol.gather_merge(
                lambda st: (st[0][0] * 5 + jnp.sum(st[0], axis=0),),
                (v[0],))[0][None],), data))
        return out
    assert case == "keep", case
    data = keep_inputs(S)
    full = _jrun(S, lambda v: (jcol.butterfly_merge(
        nc, (v[0],), S)[0][None],), data)
    gathered = _jrun(S, lambda v: (jcol.gather_merge(
        lambda st: (jnp.sum(st[0], axis=0) * 7 + st[0][-1],),
        (v[0],))[0][None],), data)
    out = {}
    for keep in KEEP_KEEPS(S):
        out[_keep_name("butterfly", keep)] = (set(keep), full)
        out[_keep_name("gather", keep)] = (set(keep), gathered)
    return out


def _check_against_jax(case: str, out_dir: str, nprocs: int, devs: int):
    """Every shard's saved result equals gelly_tpu's bit for bit, and each
    result is held at exactly the shards it is kept at."""
    S = nprocs * devs
    got: dict = {}
    for pid in range(nprocs):
        with np.load(os.path.join(out_dir, f"{case}-{pid}.npz")) as z:
            for key in z.files:
                name, shard, j = key.split("__")
                leaves = got.setdefault(name, {}).setdefault(int(shard), {})
                leaves[int(j)] = z[key]
    want = _jax_results(case, S, nprocs)
    assert sorted(got) == sorted(want)
    for name, (kept, per_shard) in want.items():
        assert set(got[name]) == kept, name
        for shard in kept:
            mine = got[name][shard]
            theirs = per_shard[shard]
            assert len(mine) == len(theirs), (name, shard)
            for j, b in enumerate(theirs):
                a = mine[j]
                assert a.dtype == b.dtype and a.shape == b.shape, (
                    name, shard, j, a.dtype, b.dtype)
                assert a.tobytes() == b.tobytes(), (name, shard, j)


def _run_procs(case: str, nprocs: int, out_dir, devs: int = 1,
               timeout: float = 120):
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(pid),
         str(nprocs), addr, str(devs), str(out_dir)],
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
        pytest.fail(f"multihost case {case} timed out")
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed rc={rc}\n{out}\n{err[-3000:]}"
        assert f"MULTIHOST_OK {case} {pid}" in out
    _check_against_jax(case, str(out_dir), nprocs, devs)


def test_initialize_multihost_two_processes(tmp_path):
    _run_procs("psum", 2, tmp_path)


def test_multihost_cc_merge_two_processes(tmp_path):
    _run_procs("cc", 2, tmp_path)


def test_multihost_keyed_exchange_two_processes(tmp_path):
    _run_procs("exchange", 2, tmp_path)


def test_multihost_cc_merge_four_processes_hierarchical(tmp_path):
    """4 processes x 2 shards: butterfly AND hierarchical (degree 4: each
    phase-1 group is one process, the leader hop crosses processes)."""
    _run_procs("cc4", 4, tmp_path, devs=2)


def test_multihost_keyed_exchange_four_processes(tmp_path):
    _run_procs("exchange", 4, tmp_path, devs=2)


def test_rounds_with_both_partners_in_other_processes(tmp_path):
    _run_procs("idle", 4, tmp_path)


def test_keep_across_processes(tmp_path):
    _run_procs("keep", 4, tmp_path, devs=2)
