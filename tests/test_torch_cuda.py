"""gelly_torch on the card: each CUDA kernel vs its plain version (the
gather, the wedge kernel, both entries of the spanner gate and the
matching fold, on random states and on their edge cases); the CC (raw,
compact and sparse plans), window-triangle, degree and bipartiteness
(raw, dense and sparse plans) paths, the spanner plans, the matching and
the stream API on CUDA vs the same paths on the CPU; the engine's pinned
H2D ring; resumes that come back on the card; the mesh paths on four
logical shards of the card vs four CPU shards.

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
when the machine has no card (decided at run time, never at import time,
so every pytest-xdist worker collects the same tests). Run on a card with
``python -m pytest tests/test_torch_cuda.py -m cuda``. Tolerance: exact
equality (integer outputs).
"""

import numpy as np
import pytest
import torch

from gelly_torch.core.io import EdgeChunkSource, TimeCharacteristic
from gelly_torch.core.stream import edge_stream_from_source
from gelly_torch.core.vertices import IdentityVertexTable
from gelly_torch.engine.aggregation import PinnedRing
from gelly_torch.engine.checkpoint import tree_flatten
from gelly_torch.library import connected_components as tcc
from gelly_torch.library import triangles as ttri
from gelly_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,L,window_rows,tile", [
    (1 << 12, 2000, 128, 512),
    (1 << 16, 5000, 128, 1024),
    (1 << 20, 1 << 16, 128, 1024),
    (1 << 16, 3000, 4, 256),
])
def test_kernel_equals_plain(cuda_device, n, L, window_rows, tile):
    g = torch.Generator(device="cpu").manual_seed(n + L)
    table = torch.randint(0, n, (n,), generator=g, dtype=torch.int32)
    half = L // 2
    idx = torch.cat([
        torch.sort(torch.randint(0, n, (half,), generator=g))[0],
        torch.sort(torch.randint(0, n, (L - half,), generator=g))[0],
    ]).to(torch.int32)  # piecewise sorted: one seam of misses
    t, i = table.to(cuda_device), idx.to(cuda_device)
    before = kernels.sorted_window_gather.launches
    got = kernels.sorted_window_gather(t, i, window_rows=window_rows,
                                       tile=tile)
    torch.cuda.synchronize()
    assert kernels.sorted_window_gather.launches == before + 1
    want = kernels.sorted_window_gather_plain(
        table, idx, window_rows=window_rows, tile=tile)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", ["ragged-tile-100", "tile-6", "offset-view",
                                  "negative"])
def test_kernel_equals_plain_off_the_fast_path(cuda_device, case):
    # Lane quads that straddle tiles, a sidx view at a 4-byte offset, and
    # negative indices (which stay -1 misses) take the scalar path.
    n, L = 1 << 16, 5003
    rng = np.random.default_rng(len(case))
    table = torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
    idx = torch.from_numpy(np.sort(rng.integers(0, n, L + 1)).astype(np.int32))
    tile = {"ragged-tile-100": 100, "tile-6": 6}.get(case, 1024)
    if case == "negative":
        idx[:700] = torch.arange(-700, 0, dtype=torch.int32)
    t, i = table.to(cuda_device), idx.to(cuda_device)
    if case == "offset-view":
        i, idx = i[1:], idx[1:]
        assert i.data_ptr() % 16 == 4
    got = kernels.sorted_window_gather(t, i, window_rows=4, tile=tile)
    torch.cuda.synchronize()
    want = kernels.sorted_window_gather_plain(table, idx, window_rows=4,
                                              tile=tile)
    assert torch.equal(got.cpu(), want)
    assert bool((want >= 0).any())
    if case != "tile-6":  # 6-lane tiles never leave their window pair
        assert bool((want < 0).any())
    if case == "negative":
        assert bool((got[:699] == -1).all())


def test_kernel_wrapper_rejects(cuda_device):
    t = torch.arange(1 << 12, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.sorted_window_gather(
            t, torch.arange(64, dtype=torch.int32, device=cuda_device)[::2])
    with pytest.raises(ValueError):
        kernels.sorted_window_gather(t, torch.arange(8, dtype=torch.int32))


def test_cc_path_on_card_equals_cpu(cuda_device, monkeypatch):
    monkeypatch.setattr(tcc, "RAW_DEDUP_MIN_CHUNK", 1 << 14)
    n = 1 << 16
    rng = np.random.default_rng(17)
    src = (rng.zipf(1.3, 1 << 17) % n).astype(np.int32)
    dst = (rng.zipf(1.3, 1 << 17) % n).astype(np.int32)

    def run(device, backend):
        s = edge_stream_from_source(
            EdgeChunkSource(src, dst, chunk_size=1 << 14,
                            table=IdentityVertexTable(n)), n, device=device)
        agg = tcc.connected_components(n, merge="gather",
                                       ingest_combine=False,
                                       fold_backend=backend)
        return [x.cpu() for x in s.aggregate(agg, merge_every=4)]

    before = kernels.sorted_window_gather.launches
    on_card = run("cuda", "kernel")
    assert kernels.sorted_window_gather.launches > before
    on_cpu = run("cpu", "plain")
    assert len(on_card) == len(on_cpu) == 2
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a, b)
    assert np.array_equal(on_card[-1].numpy(),
                          tcc.cc_labels_numpy(src, dst, None, n))


@pytest.mark.parametrize("density", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("n", [128, 384, 1024, 4096])
def test_wedge_kernel_equals_plain(cuda_device, n, density):
    rng = np.random.default_rng(n)
    m = torch.from_numpy(rng.random((n, n)) < density).to(cuda_device)
    before = kernels.wedge_count_matrix.launches
    got = kernels.wedge_count_matrix(m)
    torch.cuda.synchronize()
    assert kernels.wedge_count_matrix.launches == before + 1
    want = kernels.wedge_count_matrix_plain(m.cpu())
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu(), want)


def _structured_mask(n, kind, rng):
    if kind == "upper":
        return np.triu(rng.random((n, n)) < 0.3, k=1)
    if kind == "block":  # one live 128 x 128 block
        m = np.zeros((n, n), bool)
        k, i = n // 128 - 1, max(0, n // 128 - 2)
        m[k * 128:(k + 1) * 128, i * 128:(i + 1) * 128] = \
            rng.random((128, 128)) < 0.3
        return m
    if kind == "rows":  # whole zero block rows
        m = rng.random((n, n)) < 0.3
        for k in range(0, n // 128, 2):
            m[k * 128:(k + 1) * 128] = False
        return m
    return np.ones((n, n), bool)


@pytest.mark.parametrize("kind,n", [
    ("upper", 128), ("upper", 384), ("upper", 2048), ("block", 128),
    ("block", 384), ("block", 1024), ("rows", 384), ("rows", 1024),
    ("ones", 128), ("ones", 384), ("ones", 1024),
])
def test_wedge_kernel_skip_and_mirror_equal_plain(cuda_device, kind, n):
    m = _structured_mask(n, kind, np.random.default_rng(n + len(kind)))
    tm = torch.from_numpy(m).to(cuda_device)
    got = kernels.wedge_count_matrix(tm)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.wedge_count_matrix_plain(
        torch.from_numpy(m)))
    # The pre-pass: flags equal the plain flags, Mt the transpose on every
    # live block (dead blocks of Mt are never written).
    mt, flags = kernels.wedge_block_prepass(tm)
    torch.cuda.synchronize()
    want_flags = kernels.wedge_block_flags_plain(torch.from_numpy(m))
    assert torch.equal(flags.cpu().bool(), want_flags)
    mt = mt.cpu()
    for k, i in want_flags.nonzero().tolist():
        assert torch.equal(
            mt[i * 128:(i + 1) * 128, k * 128:(k + 1) * 128].bool(),
            torch.from_numpy(m[k * 128:(k + 1) * 128,
                               i * 128:(i + 1) * 128]).T)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_wedge_kernel_int_mask_equals_plain(cuda_device, dtype):
    m = torch.from_numpy(np.random.default_rng(9).random((512, 512)) < 0.2)
    got = kernels.wedge_count_matrix(m.to(dtype).to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.wedge_count_matrix_plain(m))


def test_window_triangles_on_card_equals_cpu(cuda_device):
    n, per_window = 1024, 1 << 14
    rng = np.random.default_rng(5)
    src = (rng.zipf(1.3, 4 * per_window) % n).astype(np.int32)
    dst = (rng.zipf(1.3, 4 * per_window) % n).astype(np.int32)
    ts = np.arange(src.shape[0], dtype=np.int64)

    def run(device):
        s = edge_stream_from_source(
            EdgeChunkSource(src, dst, timestamps=ts, chunk_size=1 << 12,
                            table=IdentityVertexTable(n),
                            time=TimeCharacteristic.EVENT),
            n, device=device)
        wins, counts = zip(*ttri.window_triangle_counts_batched(
            s, per_window, window_capacity=2 * per_window, batch=3))
        return wins, torch.stack(counts).cpu()

    before = kernels.wedge_count_matrix.launches
    on_card = run("cuda")
    assert kernels.wedge_count_matrix.launches == before + 4
    on_cpu = run("cpu")
    assert on_card[0] == on_cpu[0] == (0, 1, 2, 3)
    assert on_card[1].dtype == torch.int64
    assert torch.equal(on_card[1], on_cpu[1]) and int(on_cpu[1].sum()) > 0


@pytest.mark.parametrize("plan", ["compact-segments", "compact-pairs",
                                  "sparse"])
def test_codec_plans_on_card_equal_cpu(cuda_device, plan):
    n = 1 << 12
    rng = np.random.default_rng(23)
    src = (rng.zipf(1.3, 20000) % n).astype(np.int32)
    dst = (rng.zipf(1.3, 20000) % n).astype(np.int32)

    def make():
        if plan == "sparse":
            return tcc.connected_components(n, codec="sparse")
        return tcc.connected_components_compact(
            n, compact_capacity=n, wire=plan.split("-")[1])

    def run(device):
        s = edge_stream_from_source(
            EdgeChunkSource(src, dst, chunk_size=1024,
                            table=IdentityVertexTable(n)), n, device=device)
        out = [x.cpu() for x in s.aggregate(make(), merge_every=4,
                                            fold_batch=2, ingest_workers=2)]
        assert all(x.device.type == "cpu" for x in out)
        return out

    on_card, on_cpu = run("cuda"), run("cpu")
    assert len(on_card) == len(on_cpu) == 5
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a, b)
    assert np.array_equal(on_card[-1].numpy(),
                          tcc.cc_labels_numpy(src, dst, None, n))


def test_pinned_ring_reuses_a_buffer_only_after_its_copy(cuda_device):
    # 64 MiB units through 2 slots, no waits by the caller: put must wait
    # on a slot's previous copy event before it writes the slot again, and
    # every device copy must hold its own unit's values.
    ring = PinnedRing(cuda_device, 2, torch.cuda.current_stream())
    units = 8
    outs, events = [], []
    for i in range(units):
        host = {"x": np.full(1 << 24, i, np.int32),
                "base": np.asarray(i, np.int32)}
        dev, event = ring.put(host)
        outs.append(dev)
        events.append(event)
        if i >= 2:
            assert events[i - 2].query()  # the slot's last copy is done
    assert ring.reuses == units - 2
    torch.cuda.synchronize()
    for i, dev in enumerate(outs):
        assert int(dev["base"]) == i
        assert bool((dev["x"] == i).all())
    assert ring.bytes == units * ((1 << 24) * 4 + 4)


def test_raw_plan_copies_only_the_fields_its_fold_reads(cuda_device):
    n = 1 << 12
    rng = np.random.default_rng(29)
    src = (rng.zipf(1.3, 8192) % n).astype(np.int32)
    dst = (rng.zipf(1.3, 8192) % n).astype(np.int32)
    s = edge_stream_from_source(
        EdgeChunkSource(src, dst, chunk_size=1024,
                        table=IdentityVertexTable(n)), n, device="cuda")
    agg = tcc.connected_components(n, ingest_combine=False)
    seen = []
    fold = agg.fold
    agg.fold = lambda st, c: (seen.append(
        {f: getattr(c, f).device.type for f in c._fields}), fold(st, c))[1]
    res = s.aggregate(agg, merge_every=4)
    labels = res.result().cpu().numpy()
    assert np.array_equal(labels, tcc.cc_labels_numpy(src, dst, None, n))
    assert all(d["src"] == d["dst"] == d["valid"] == "cuda"
               and d["raw_src"] == d["val"] == d["ts"] == "cpu"
               for d in seen)
    assert res.stats["h2d_bytes"] == 8 * 1024 * 9


def test_summary_checkpoint_round_trip_comes_back_on_the_card(cuda_device,
                                                              tmp_path):
    from gelly_torch.engine.checkpoint import load_checkpoint, save_checkpoint

    agg = tcc.connected_components(1 << 12, codec="compact",
                                   compact_capacity=1 << 11)
    s = agg.init(cuda_device)
    s = s._replace(vertex_of=torch.arange(1 << 11, dtype=torch.int32,
                                          device=cuda_device))
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, s, position=5)
    loaded, pos, _ = load_checkpoint(p, like=agg.init(cuda_device))
    assert pos == 5
    for got, want in zip(loaded, s):
        assert got.device.type == "cuda"
        assert torch.equal(got, want)


def test_compact_resume_on_card_equals_uninterrupted(cuda_device, tmp_path):
    n = 1 << 12
    rng = np.random.default_rng(31)
    src = (rng.zipf(1.3, 20000) % n).astype(np.int32)
    dst = (rng.zipf(1.3, 20000) % n).astype(np.int32)
    p = str(tmp_path / "ck.npz")

    def run(stop_after=None, **kw):
        s = edge_stream_from_source(
            EdgeChunkSource(src, dst, chunk_size=1024,
                            table=IdentityVertexTable(n)), n, device="cuda")
        agg = tcc.connected_components(n, merge="gather", codec="compact",
                                       compact_capacity=n)
        res = s.aggregate(agg, merge_every=4, fold_batch=2,
                          checkpoint_path=p, **kw)
        out = []
        for x in res:
            assert x.device.type == "cuda"
            out.append(x.cpu())
            if len(out) == stop_after:
                break
        return out, res

    full, _ = run()
    assert len(full) == 5
    run(stop_after=3)  # the window-2 checkpoint is on disk
    got, res = run(resume=True)
    assert res.stats["resumed_at"] == 8
    assert len(got) == 3
    for a, b in zip(got, full[2:]):
        assert torch.equal(a, b)


def test_resilient_kernel_fold_on_card_survives_a_step_fault(cuda_device,
                                                             tmp_path,
                                                             monkeypatch):
    from gelly_torch.engine import faults
    from gelly_torch.engine.resilience import (
        ResilienceConfig,
        ResilientRunner,
        RetryPolicy,
    )

    monkeypatch.setattr(tcc, "RAW_DEDUP_MIN_CHUNK", 1 << 14)
    n = 1 << 16
    rng = np.random.default_rng(17)
    src = (rng.zipf(1.3, 1 << 17) % n).astype(np.int32)
    dst = (rng.zipf(1.3, 1 << 17) % n).astype(np.int32)
    agg = tcc.connected_components(n, merge="gather", ingest_combine=False,
                                   fold_backend="kernel")
    stream = edge_stream_from_source(
        EdgeChunkSource(src, dst, chunk_size=1 << 14,
                        table=IdentityVertexTable(n)), n, device="cuda")
    plan = faults.FaultPlan([faults.Fault("step", at=3)])
    before = kernels.sorted_window_gather.launches
    with faults.install(plan):
        r = ResilientRunner(
            lambda s, c: (agg.fold(s, c.to(cuda_device)), None), stream,
            lambda: agg.init(cuda_device), checkpoint_dir=str(tmp_path),
            flatten_state=agg.flatten,
            config=ResilienceConfig(
                checkpoint_every_chunks=2, watchdog_timeout=60.0,
                retry=RetryPolicy(base_delay=0.01)))
        final = r.run()
    assert r.stats["retries"] == 1 and r.stats["checkpoints"] == 4
    assert kernels.sorted_window_gather.launches > before
    assert final.parent.device.type == "cuda"
    labels = tcc.unionfind.component_labels(final.parent, final.seen)
    assert np.array_equal(labels.cpu().numpy(),
                          tcc.cc_labels_numpy(src, dst, None, n))


def _zipf_events(n, e, seed, deletions=True):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.3, e) % n).astype(np.int32)
    dst = (rng.zipf(1.3, e) % n).astype(np.int32)
    ev = ((rng.random(e) < 0.2) if deletions
          else np.zeros(e, bool)).astype(np.int8)
    return src, dst, ev


def _event_stream(src, dst, ev, n, device, chunk=1024):
    return edge_stream_from_source(
        EdgeChunkSource(src, dst, events=ev, chunk_size=chunk,
                        table=IdentityVertexTable(n)), n, device=device)


_PLANS = {"raw": dict(ingest_combine=False), "dense": dict(codec="dense"),
          "sparse": dict(codec="sparse")}


@pytest.mark.parametrize("plan", sorted(_PLANS))
def test_degree_plans_on_card_equal_cpu(cuda_device, plan):
    from gelly_torch.library import degrees as tdeg

    n = 1 << 12
    src, dst, ev = _zipf_events(n, 20000, 37)

    def run(device):
        res = _event_stream(src, dst, ev, n, device).aggregate(
            tdeg.degree_aggregate(n, **_PLANS[plan]), merge_every=4,
            fold_batch=2, ingest_workers=2)
        out = [x for x in res]
        assert all(x.device.type == device and x.dtype == torch.int64
                   for x in out)
        return [x.cpu() for x in out]

    on_card, on_cpu = run("cuda"), run("cpu")
    assert len(on_card) == len(on_cpu) == 5
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a, b)
    want = np.zeros(n, np.int64)
    sign = np.where(ev == 1, -1, 1)
    np.add.at(want, src, sign)
    np.add.at(want, dst, sign)
    assert np.array_equal(on_card[-1].numpy(), want)


@pytest.mark.parametrize("plan", sorted(_PLANS))
@pytest.mark.parametrize("kind", ["bipartite", "odd"])
def test_bipartiteness_plans_on_card_equal_cpu(cuda_device, plan, kind):
    from gelly_torch.library import bipartiteness as tbp

    n = 1 << 12
    src, dst, _ = _zipf_events(n, 20000, 41, deletions=False)
    if kind == "bipartite":
        src, dst = src & ~1, dst | 1

    def run(device):
        res = _event_stream(src, dst, None, n, device).aggregate(
            tbp.bipartiteness_check(n, **_PLANS[plan]), merge_every=4,
            fold_batch=2, ingest_workers=2)
        out = list(res)
        assert all(r.labels.device.type == device for r in out)
        return [tuple(x.cpu() for x in r) for r in out]

    on_card, on_cpu = run("cuda"), run("cpu")
    assert len(on_card) == len(on_cpu) == 5
    for a, b in zip(on_card, on_cpu):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert bool(on_card[-1][0]) is (kind == "bipartite")
    if kind == "bipartite":
        col = on_card[-1][2].numpy()
        assert bool((col[src] != col[dst]).all())


def test_stream_api_on_card_equals_cpu(cuda_device):
    from gelly_torch.library import degrees as tdeg

    n = 1 << 12
    src, dst, ev = _zipf_events(n, 20000, 43)
    out = {}
    for device in ("cuda", "cpu"):
        s = _event_stream(src, dst, ev, n, device)
        updates = [tuple(x.cpu() for x in u) for u in s.get_degrees()]
        vertices = [tuple(x.cpu() for x in u) for u in s.get_vertices()]
        hists = [h.cpu() for h in tdeg.degree_distribution(s, 1 << 14)]
        out[device] = (updates, vertices, hists, list(s.number_of_edges()),
                       list(s.number_of_vertices()))
    card, cpu = out["cuda"], out["cpu"]
    for a, b in zip(card[:3], cpu[:3]):
        assert len(a) == len(b) == 20
        for x, y in zip(a, b):
            for p, q in zip(x if isinstance(x, tuple) else (x,),
                            y if isinstance(y, tuple) else (y,)):
                assert torch.equal(p, q)
    assert card[3:] == cpu[3:]
    assert card[3][-1] == int((ev == 0).sum()) - int((ev == 1).sum())


def test_degree_checkpoint_resumes_on_card(cuda_device, tmp_path):
    from gelly_torch.library import degrees as tdeg

    n = 1 << 12
    src, dst, ev = _zipf_events(n, 20000, 47)
    p = str(tmp_path / "ck.npz")

    def run(stop_after=None, **kw):
        res = _event_stream(src, dst, ev, n, "cuda").aggregate(
            tdeg.degree_aggregate(n, codec="sparse"), merge_every=4,
            fold_batch=2, checkpoint_path=p, **kw)
        out = []
        for x in res:
            assert x.device.type == "cuda"
            out.append(x.cpu())
            if len(out) == stop_after:
                break
        return out, res

    full, _ = run()
    run(stop_after=3)
    got, res = run(resume=True)
    assert res.stats["resumed_at"] == 8 and len(got) == 3
    for a, b in zip(got, full[2:]):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ #
# The spanner gates and the matching fold


def _gate_state(rng, n, D, E, fill=0.0, preload=0):
    """A sparse spanner summary as numpy fields: rows filled to a random
    degree (``fill`` of them), ``preload`` accepted edges already listed."""
    nbr = np.full((n, D), -1, np.int32)
    deg = np.zeros(n, np.int32)
    if fill:
        deg = (rng.integers(0, D + 1, n) * (rng.random(n) < fill)).astype(
            np.int32)
        for i in range(n):
            nbr[i, :deg[i]] = rng.integers(0, n, deg[i])
    esrc = np.zeros(E, np.int32)
    edst = np.zeros(E, np.int32)
    esrc[:preload] = rng.integers(0, n, preload)
    edst[:preload] = rng.integers(0, n, preload)
    return [nbr, deg, np.array(int(deg.sum()) % 7, np.int32), esrc, edst,
            np.array(preload, np.int32), np.array(False)]


def _on(fields, device):
    return [torch.from_numpy(np.array(f)).to(device) for f in fields]


def _equal(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


# (n, D, F, k, E, lanes, fill, valid share): random states, then the edge
# cases — empty lane list, all lanes invalid, full rows, an edge list that
# overflows, a frontier truncated to 2 ids, k = 0, the card's shapes.
_GATE_CASES = {
    "random": (200, 4, 16, 3, 400, 300, 0.3, 0.9),
    "empty": (64, 4, 16, 2, 64, 0, 0.3, 1.0),
    "all-invalid": (64, 4, 16, 2, 64, 100, 0.3, 0.0),
    "full-rows": (50, 2, 8, 2, 400, 300, 1.0, 1.0),
    "list-overflow": (100, 4, 16, 2, 8, 300, 0.0, 1.0),
    "truncated": (80, 6, 2, 3, 400, 300, 0.5, 1.0),
    "k0": (80, 4, 16, 0, 400, 100, 0.2, 1.0),
    "card-shape": (4096, 16, 64, 2, 8192, 2000, 0.5, 1.0),
}


@pytest.mark.parametrize("case", sorted(_GATE_CASES))
def test_sparse_insert_edges_equals_plain(cuda_device, case):
    n, D, F, k, E, L, fill, share = _GATE_CASES[case]
    rng = np.random.default_rng(len(case) * 31 + L)
    st = _gate_state(rng, n, D, E, fill, preload=min(E, 5))
    src = (rng.zipf(1.4, L) % n).astype(np.int32)
    dst = rng.integers(0, n, L).astype(np.int32)
    valid = rng.random(L) < share
    lanes = [torch.from_numpy(x) for x in (src, dst, valid)]
    want = _on(st, "cpu")
    kernels.sparse_insert_edges(*want, *lanes, k, D, F)
    got = _on(st, cuda_device)
    before = kernels.sparse_insert_edges.launches
    kernels.sparse_insert_edges(*got, *(x.to(cuda_device) for x in lanes),
                                k, D, F)
    torch.cuda.synchronize()
    assert kernels.sparse_insert_edges.launches == before + (L > 0)
    assert _equal(got, want)


@pytest.mark.parametrize("case", sorted(_GATE_CASES))
@pytest.mark.parametrize("batch", [64, 7])
def test_sparse_insert_edges_batched_equals_plain(cuda_device, case, batch):
    n, D, F, k, E, L, fill, share = _GATE_CASES[case]
    rng = np.random.default_rng(len(case) * 17 + L + batch)
    st = _gate_state(rng, n, D, E, fill, preload=min(E, 5))
    C = max(L, 1)
    csrc = (rng.zipf(1.4, C) % n).astype(np.int32)
    cdst = rng.integers(0, n, C).astype(np.int32)
    # The donor's count: all lanes, none (the empty and all-invalid
    # cases), or more than its list holds (an overflowed donor).
    n_valid = {"empty": 0, "all-invalid": 0, "list-overflow": C + 9}.get(
        case, C)
    donor = [torch.from_numpy(x) for x in (csrc, cdst)]
    nv = torch.tensor(n_valid, dtype=torch.int32)
    want = _on(st, "cpu")
    kernels.sparse_insert_edges_batched(*want, *donor, nv, k, D, F, batch)
    got = _on(st, cuda_device)
    before = kernels.sparse_insert_edges_batched.launches
    kernels.sparse_insert_edges_batched(
        *got, *(x.to(cuda_device) for x in donor), nv.to(cuda_device), k, D,
        F, batch)
    torch.cuda.synchronize()
    assert kernels.sparse_insert_edges_batched.launches == before + 1
    assert _equal(got, want)


def test_spanner_gate_refuses_what_it_cannot_take(cuda_device):
    st = _on(_gate_state(np.random.default_rng(0), 16, 4, 8), cuda_device)
    lanes = [torch.zeros(4, dtype=torch.int32, device=cuda_device)] * 2 + [
        torch.ones(4, dtype=torch.bool, device=cuda_device)]
    with pytest.raises(ValueError, match="shared memory"):
        kernels.sparse_insert_edges(*st, *lanes, 2, 4, 1 << 16)
    with pytest.raises(ValueError, match="src"):
        kernels.sparse_insert_edges(*st, lanes[0].long(), *lanes[1:], 2, 4,
                                    16)
    with pytest.raises(ValueError, match="nbr"):
        kernels.sparse_insert_edges(*st, *lanes, 2, 5, 16)


@pytest.mark.parametrize("n,L,seed", [(64, 3000, 1), (4096, 1 << 16, 2),
                                      (1 << 16, 5000, 3), (8, 0, 4)])
def test_matching_step_equals_plain(cuda_device, n, L, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, L).astype(np.int32)
    dst = rng.integers(0, n, L).astype(np.int32)
    w = (rng.integers(1, 9, L) * rng.choice([1.0, 0.1, 0.3], L)).astype(
        np.float32)
    valid = rng.random(L) < 0.9
    partner = np.full(n, -1, np.int32)
    weight = np.zeros(n, np.float32)
    args = [torch.from_numpy(x) for x in (partner, weight, src, dst, w,
                                          valid)]
    # Only the first 2000 lanes through the (slow) plain version.
    cut = min(L, 2000)
    want = kernels.matching_step(*args[:2], *(x[:cut] for x in args[2:]))
    before = kernels.matching_step.launches
    got = kernels.matching_step(*(x.to(cuda_device) for x in args[:2]),
                                *(x[:cut].to(cuda_device) for x in args[2:]))
    torch.cuda.synchronize()
    assert kernels.matching_step.launches == before + (cut > 0)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def _spanner_stream(device, n=512, e=6000, seed=23, chunk=1000):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.5, e) % n).astype(np.int64)
    dst = (rng.zipf(1.5, e) % n).astype(np.int64)
    return edge_stream_from_source(EdgeChunkSource(
        src, dst, chunk_size=chunk, table=IdentityVertexTable(n)), n,
        device=device)


@pytest.mark.parametrize("plan", ["sparse-k3", "gate-batch", "codec",
                                  "dense"])
def test_spanner_plans_on_card_equal_cpu(cuda_device, plan):
    import importlib

    tsp = importlib.import_module("gelly_torch.library.spanner")
    n = 512
    kw = {"sparse-k3": dict(k=3, max_degree=8),
          "gate-batch": dict(k=2, max_degree=8, gate_batch=256),
          "codec": dict(k=2, max_degree=8, ingest_combine=True,
                        payload_cap=1024),
          "dense": dict(k=2)}[plan]
    out = {}
    for device in ("cuda", "cpu"):
        res = _spanner_stream(device).aggregate(
            tsp.spanner(n, **kw), merge_every=2)
        out[device] = [tuple(x.cpu() for x in s) for s in res]
    assert len(out["cuda"]) == len(out["cpu"]) == 3
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _equal(a, b)


def test_weighted_matching_device_on_card_equals_cpu(cuda_device):
    from gelly_torch.library.matching import weighted_matching

    n = 256
    rng = np.random.default_rng(5)
    src = rng.integers(0, n, 3000).astype(np.int64)
    dst = rng.integers(0, n, 3000).astype(np.int64)
    w = rng.integers(1, 50, 3000).astype(np.float64)
    out = {}
    for device in ("cuda", "cpu"):
        s = edge_stream_from_source(EdgeChunkSource(
            src, dst, val=w, chunk_size=500, table=IdentityVertexTable(n)),
            n, device=device)
        out[device] = weighted_matching(s, device=True).final_matching()
    assert out["cuda"] == out["cpu"]


def test_spanner_checkpoint_resumes_on_card(cuda_device, tmp_path):
    import importlib

    tsp = importlib.import_module("gelly_torch.library.spanner")
    p = str(tmp_path / "ck.npz")

    def run(stop_after=None, **kw):
        res = _spanner_stream("cuda").aggregate(
            tsp.spanner(512, 3, max_degree=8), merge_every=2,
            checkpoint_path=p, **kw)
        out = []
        for s in res:
            assert s.nbr.device.type == "cuda"
            out.append(tuple(x.cpu() for x in s))
            if len(out) == stop_after:
                break
        return out, res

    full, _ = run()
    run(stop_after=2)
    got, res = run(resume=True)
    assert res.stats["resumed_at"] == 2 and len(got) == 2
    for a, b in zip(got, full[1:]):
        assert _equal(a, b)


# ---------------------------------------------------------------------- #
# the hash set (csrc/hashset.cu) and the row insert (csrc/row_insert.cu)


def _hash_case(cap, n, seed, hi, fill=0):
    g = np.random.default_rng(seed)
    table = np.full(cap, kernels.HASH_EMPTY, np.int64)
    count = 0
    if fill:  # a prefilled table: long probe runs, wrap-around
        pre = g.choice(4 * cap, fill, replace=False).astype(np.int64)
        t, c, _ = kernels.hashset_insert_plain(
            torch.from_numpy(table), torch.zeros((), dtype=torch.int32),
            torch.from_numpy(pre), torch.ones(fill, dtype=torch.bool))
        table, count = t.numpy(), int(c)
    keys = g.integers(0, hi, n).astype(np.int64)
    keys[g.random(n) < 0.25] = keys[0]  # in-chunk duplicates
    valid = g.random(n) < 0.9
    return (torch.from_numpy(table), torch.tensor(count, dtype=torch.int32),
            torch.from_numpy(keys), torch.from_numpy(valid))


@pytest.mark.parametrize("cap,n,seed,hi,fill", [
    (16, 10, 0, 40, 0), (1 << 10, 600, 1, 5000, 0),
    (1 << 12, 2000, 2, 1 << 40, 2000), (64, 40, 3, 200, 20),
    (1 << 16, 1 << 14, 4, 1 << 20, 1 << 15), (1 << 8, 1 << 10, 5, 120, 0),
])
def test_hashset_insert_equals_plain(cuda_device, cap, n, seed, hi, fill):
    table, count, keys, valid = _hash_case(cap, n, seed, hi, fill)
    before = kernels.hashset_insert.launches
    got = kernels.hashset_insert(table.to(cuda_device),
                                 count.to(cuda_device),
                                 keys.to(cuda_device), valid.to(cuda_device))
    assert kernels.hashset_insert.launches == before + 1
    want = kernels.hashset_insert_plain(table, count, keys, valid)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    absent = max(hi, 4 * cap)  # above every inserted and prefilled key
    q = torch.cat([keys, torch.arange(absent, absent + 300,
                                      dtype=torch.int64)])
    t_dev = got[0]
    found = kernels.hashset_contains(t_dev, q.to(cuda_device))
    assert torch.equal(found.cpu(), kernels.hashset_contains_plain(want[0],
                                                                   q))
    assert found[:n][valid.to(cuda_device)].all()
    assert not found[n:].any()


def test_hashset_full_table_raises_on_card(cuda_device):
    table = torch.full((4,), kernels.HASH_EMPTY, dtype=torch.int64,
                       device=cuda_device)
    count = torch.zeros((), dtype=torch.int32, device=cuda_device)
    keys = torch.arange(5, dtype=torch.int64, device=cuda_device)
    with pytest.raises(RuntimeError, match="hash set full"):
        kernels.hashset_insert(table, count, keys,
                               torch.ones(5, dtype=torch.bool,
                                          device=cuda_device))


def test_device_hashset_and_distinct_on_card(cuda_device):
    from gelly_torch.ops.hashset import DeviceHashSet

    g = np.random.default_rng(9)
    sets = {d: DeviceHashSet(capacity=16, device=d)
            for d in ("cpu", cuda_device)}
    for c in range(8):
        keys = torch.from_numpy(g.integers(0, 20000, 700).astype(np.int64))
        valid = torch.from_numpy(g.random(700) < 0.9)
        masks = [s.insert(keys.to(d), valid.to(d)).cpu()
                 for d, s in sets.items()]
        assert torch.equal(masks[0], masks[1])
    a, b = sets.values()
    assert torch.equal(a.state.keys, b.state.keys.cpu())
    # Growth past the first (empty) table re-inserts through the kernel.
    assert a.rehashes == b.rehashes >= 2
    src = g.integers(0, 50, 4000)
    dst = g.integers(0, 50, 4000)
    out = {}
    for d in ("cpu", "cuda"):
        s = edge_stream_from_source(EdgeChunkSource(
            src, dst, chunk_size=512, table=IdentityVertexTable(64)), 64,
            device=d)
        out[d] = [c.valid.cpu() for c in s.distinct(device=True)]
        host = [c.valid.cpu() for c in s.distinct()]
        assert all(torch.equal(x, y) for x, y in zip(out[d], host))
    assert all(torch.equal(x, y) for x, y in zip(out["cpu"], out["cuda"]))


def _row_case(n, max_degree, n_e, seed, fill_rows=0, loops=True):
    g = np.random.default_rng(seed)
    nbr = np.full((n, max_degree), -1, np.int32)
    deg = np.zeros(n, np.int32)
    for r in range(fill_rows):  # full rows: every insert there overflows
        nbr[r] = np.arange(max_degree) + 1000
        deg[r] = max_degree
    src = g.integers(0, n, n_e).astype(np.int32)
    dst = g.integers(0, n, n_e).astype(np.int32)
    if loops:
        dst[::13] = src[::13]  # self-loops
        src[1::17] = src[0::17][:len(src[1::17])]  # duplicates
        dst[1::17] = dst[0::17][:len(dst[1::17])]
    valid = g.random(n_e) < 0.9
    return (torch.from_numpy(nbr), torch.from_numpy(deg),
            torch.zeros((), dtype=torch.int32), torch.from_numpy(src),
            torch.from_numpy(dst), torch.from_numpy(valid))


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("n,max_degree,n_e,seed,fill_rows", [
    (64, 4, 300, 0, 0), (32, 16, 500, 1, 4), (1 << 12, 8, 1 << 12, 2, 10),
    (8, 3, 200, 3, 2),
])
def test_row_insert_chunk_equals_plain(cuda_device, directed, n, max_degree,
                                       n_e, seed, fill_rows):
    state = _row_case(n, max_degree, n_e, seed, fill_rows)
    before = kernels.row_insert_chunk.launches
    got = kernels.row_insert_chunk(*(t.to(cuda_device) for t in state),
                                   directed, max_degree)
    assert kernels.row_insert_chunk.launches == before + 1
    want = kernels.row_insert_chunk_plain(*state, directed, max_degree)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    if fill_rows:
        assert int(got[2]) > 0


def test_row_insert_chunk_no_live_lane_launches_nothing(cuda_device):
    state = [t.to(cuda_device) for t in _row_case(16, 4, 10, 0)]
    state[5] = torch.zeros_like(state[5])
    before = kernels.row_insert_chunk.launches
    nbr, deg, over = kernels.row_insert_chunk(*state, False, 4)
    assert kernels.row_insert_chunk.launches == before
    assert torch.equal(nbr, state[0]) and int(over) == 0


def test_windowed_and_event_time_paths_on_card(cuda_device):
    g = np.random.default_rng(3)
    n = 256
    src = (g.zipf(1.4, 64 * 20) % n).astype(np.int64)
    dst = (g.zipf(1.4, 64 * 20) % n).astype(np.int64)
    ts = np.arange(src.size, dtype=np.int64)
    g.shuffle(ts[:640])

    def stream(d):
        return edge_stream_from_source(EdgeChunkSource(
            src, dst, timestamps=ts, chunk_size=64,
            table=IdentityVertexTable(n), time=TimeCharacteristic.EVENT),
            n, device=d)

    for plan, kw in (
            (lambda: tcc.connected_components(n, codec="compact",
                                              compact_capacity=n,
                                              windowed=3, ttl_panes=4),
             dict(merge_every=2, prefetch_depth=0, h2d_depth=0)),
            (lambda: tcc.connected_components(n, codec="dense", windowed=4),
             dict(merge_every=2)),
            (lambda: tcc.connected_components(n, ingest_combine=False),
             dict(window_ms=256, allowed_lateness=700))):
        out = {d: [o.cpu() for o in stream(d).aggregate(plan(), **kw)]
               for d in ("cpu", "cuda")}
        assert len(out["cpu"]) == len(out["cuda"]) > 1
        assert all(torch.equal(a, b) for a, b in zip(out["cpu"],
                                                      out["cuda"]))


def test_neighborhood_and_snapshot_on_card(cuda_device):
    g = np.random.default_rng(4)
    n = 128
    src = g.integers(0, n, 2000)
    dst = g.integers(0, n, 2000)
    ts = np.arange(2000, dtype=np.int64)

    def stream(d):
        return edge_stream_from_source(EdgeChunkSource(
            src, dst, timestamps=ts, chunk_size=256,
            table=IdentityVertexTable(n), time=TimeCharacteristic.EVENT),
            n, device=d)

    res = {}
    for d in ("cpu", "cuda"):
        nb = stream(d).build_neighborhood(max_degree=64)
        nbr, deg = nb.final_adjacency()
        red = [u.values.cpu()[u.valid.cpu()] for u in
               stream(d).slice(500, "all").reduce_on_edges(torch.add)]
        fold = [u.values.cpu() for u in stream(d).slice(500, "out")
                .fold_neighbors(torch.zeros((), dtype=torch.int64),
                                lambda a, v, nb_, val: a * 2 + nb_)]
        res[d] = (nbr.cpu(), deg.cpu(), red, fold)
    a, b = res["cpu"], res["cuda"]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for x, y in zip(a[2] + a[3], b[2] + b[3]):
        assert torch.equal(x, y)


# --------------------------------------------------------------------- #
# the triangle library's rest: the sampler kernel, the wedge kernel at
# N = 2^16, and the sparse, bucketed and exact paths on the card


def _sampler_state(s, seed, device):
    """A random mid-stream sampler state (found flags, third vertices and
    draw-time counts set) on ``device``."""
    g = np.random.default_rng(seed)
    st = list(ttri._fresh_sampler(s, seed))
    st[0] = torch.from_numpy(g.integers(-1, 50, s).astype(np.int32))
    st[1] = torch.from_numpy(g.integers(-1, 50, s).astype(np.int32))
    st[2] = torch.from_numpy(g.integers(-1, 50, s).astype(np.int32))
    st[3] = torch.from_numpy(g.random(s) < 0.5)
    st[4] = torch.from_numpy(g.random(s) < 0.5)
    st[5] = torch.from_numpy(g.integers(0, 60, s).astype(np.int32))
    st[6] = torch.tensor(int(g.integers(0, 3000)), dtype=torch.int32)
    return tuple(x.to(device) for x in st)


@pytest.mark.parametrize("s,lanes,n_v,seed", [
    (1, 50, 10, 1), (100, 777, 50, 2), (4096, 2048, 50, 3),
    (300, 5000, 3, 4), (129, 64, 2, 5)])
def test_sampler_step_equals_plain(cuda_device, s, lanes, n_v, seed):
    g = np.random.default_rng(seed)
    state = _sampler_state(s, seed, cuda_device)
    src = torch.from_numpy(g.integers(0, 50, lanes).astype(np.int32))
    dst = torch.from_numpy(g.integers(0, 50, lanes).astype(np.int32))
    src[::7] = dst[::7]  # self-loops
    valid = torch.from_numpy(g.random(lanes) < 0.9)
    args = [x.to(cuda_device) for x in (src, dst, valid)]
    before = kernels.sampler_step.launches
    got = kernels.sampler_step(state, *args, n_v)
    torch.cuda.synchronize()
    assert kernels.sampler_step.launches == before + 1
    want = kernels.sampler_step_plain(state, *args, n_v)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    # the input state is unchanged
    assert torch.equal(state[7].cpu(), _sampler_state(s, seed, "cpu")[7])


def test_wedge_count_matrix_at_2_16_equals_column_products(cuda_device):
    # N^2 = 2^32: the first size whose byte offsets pass 32 bits.
    n = 1 << 16
    g = torch.Generator(device=cuda_device).manual_seed(16)
    m = torch.zeros((n, n), dtype=torch.bool, device=cuda_device)
    rows = torch.randint(0, n, (1 << 22,), generator=g, device=cuda_device)
    cols = torch.randint(0, n, (1 << 22,), generator=g, device=cuda_device)
    m[rows, cols] = True
    m[-128:, -128:] = True  # the last block: offsets past 2^32
    m.triu_(diagonal=1)
    before = kernels.wedge_count_matrix.launches
    w = kernels.wedge_count_matrix(m)
    torch.cuda.synchronize()
    assert kernels.wedge_count_matrix.launches == before + 1
    a = torch.cat([torch.randint(0, n, (4096,), generator=g,
                                 device=cuda_device),
                   torch.arange(n - 128, n, device=cuda_device)])
    b = torch.cat([torch.randint(0, n, (4096,), generator=g,
                                 device=cuda_device),
                   torch.arange(n - 128, n, device=cuda_device).flip(0)])
    want = (m[:, a] & m[:, b]).sum(dim=0).float()
    assert torch.equal(w[a, b], want)
    assert torch.equal(w[b, a], want)
    last = float(m[:, n - 1].sum())  # column n-1's ones, the block's 127
    assert last >= 127 and float(w[n - 1, n - 1]) == last


def _tri_stream(src, dst, n, chunk, device):
    ts = np.arange(src.shape[0], dtype=np.int64)
    return edge_stream_from_source(EdgeChunkSource(
        src, dst, timestamps=ts, chunk_size=chunk,
        table=IdentityVertexTable(n), time=TimeCharacteristic.EVENT),
        n, device=device)


def test_triangle_library_on_card_equals_cpu(cuda_device):
    g = np.random.default_rng(9)
    n = 512
    src = (g.zipf(1.3, 6000) % n).astype(np.int32)
    dst = (g.zipf(1.3, 6000) % n).astype(np.int32)
    res = {}
    for d in ("cpu", "cuda"):
        s = lambda: _tri_stream(src, dst, n, 512, d)  # noqa: E731
        buck = [int(c) for _, c in ttri.window_triangles_bucketed(
            s(), 2000, window_capacity=8192, batch=2)]
        sparse = [int(c) for _, c in ttri.window_triangle_counts_batched(
            s(), 2000, window_capacity=8192, batch=2, max_degree=n)]
        dense = ttri.exact_triangle_count(s(), arrival_budget=2500).final()
        sp = ttri.exact_triangle_count(s(), max_degree=n).final()
        est = list(ttri.sampled_triangle_count(s(), 256, seed=3))
        res[d] = (buck, sparse, [x.cpu() for x in dense],
                  [x.cpu() for x in sp], est)
    a, b = res["cpu"], res["cuda"]
    assert a[0] == b[0] == a[1] == b[1] and sum(a[0]) > 0
    for x, y in zip(a[2] + a[3], b[2] + b[3]):
        assert torch.equal(x, y)
    assert a[4] == b[4]


# --------------------------------------------------------------------- #
# the mesh: four logical shards of the card against four CPU shards


def _mesh_path(path: str, device):
    """One mesh path at a small size on ``[device] * 4`` shards; integer
    outputs pulled to numpy."""
    from gelly_torch.library import degrees as tdeg
    from gelly_torch.library.sharded_triangles import ShardedExactTriangles
    from gelly_torch.parallel.mesh import make_mesh
    from gelly_torch.parallel.sharded_cc import ShardedCC

    mesh = make_mesh(4, devices=[device] * 4)
    n = 1 << 12
    rng = np.random.default_rng(len(path))
    src = (rng.zipf(1.3, 1 << 14) % n).astype(np.int32)
    dst = (rng.zipf(1.3, 1 << 14) % n).astype(np.int32)

    def stream(chunk=1 << 12, **kw):
        return edge_stream_from_source(EdgeChunkSource(
            src, dst, chunk_size=chunk, table=IdentityVertexTable(n), **kw),
            n, device=device)

    if path in ("raw-delta", "raw-tree"):
        agg = (tcc.connected_components(n, ingest_combine=False,
                                        fold_backend="kernel",
                                        merge_mode="delta")
               if path == "raw-delta" else tcc.connected_components_tree(
                   n, degree=2))
        res = stream().aggregate(agg, mesh=mesh, merge_every=2)
        out = [x.cpu().numpy() for x in res]
        return out + [np.array(sorted(res.stats["merge_modes"].items()))]
    if path == "compact":
        agg = tcc.connected_components(n, codec="compact", compact_capacity=n,
                                       merge_mode="delta")
        return [x.cpu().numpy() for x in stream(1 << 10).aggregate(
            agg, mesh=mesh, merge_every=8, fold_batch=8)]
    if path == "sharded-cc":
        cc = ShardedCC(n, mesh=mesh)
        cc.fold(src, dst)
        return [cc.labels()] + [p.cpu().numpy() for p in cc.parent]
    if path == "degrees":
        got = tdeg.sharded_degrees(stream(), mesh=mesh,
                                   mode="auto").final_degrees()
        return [np.array(sorted(got.items()))]
    if path == "sampler":  # 4 chunks of 128 lanes (the plain loop is slow)
        src, dst = src[:512], dst[:512]
        states = list(ttri.sharded_sampler_run(stream(128), 256, mesh))[-1][0]
        return [f.cpu().numpy() for st in states for f in st]
    ts = np.arange(src.shape[0], dtype=np.int64)
    win = [(w, int(c)) for w, c in ttri.sharded_window_triangles(
        stream(timestamps=ts, time=TimeCharacteristic.EVENT), 1 << 13,
        capacity=n, window_capacity=1 << 15, mesh=mesh)]
    exact = ShardedExactTriangles(stream(), max_degree=n,
                                  mesh=mesh).run().final_counts()
    return [np.array(win), np.array(sorted(exact.items()))]


@pytest.mark.parametrize("path", ["raw-delta", "raw-tree", "compact",
                                  "sharded-cc", "degrees", "sampler",
                                  "triangles"])
def test_mesh_paths_on_card_equal_cpu(cuda_device, path, monkeypatch):
    # Each shard's 1024-lane slice takes the dedup fold and its gather.
    monkeypatch.setattr(tcc, "RAW_DEDUP_MIN_CHUNK", 1 << 10)
    before = (kernels.sorted_window_gather.launches,
              kernels.sampler_step.launches)
    got = _mesh_path(path, cuda_device)
    if path == "raw-delta":
        assert kernels.sorted_window_gather.launches > before[0]
    if path == "sampler":  # 4 chunks on 4 shards
        assert kernels.sampler_step.launches == before[1] + 16
    want = _mesh_path(path, torch.device("cpu"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------- #
# fused multi-query (engine/multiquery.py)


def _fused_run(device, queries, mesh=None, merge_every=2, **kw):
    from gelly_torch.engine.multiquery import run_multiquery

    res = run_multiquery(queries(), _spanner_stream(device, chunk=1024),
                         merge_every=merge_every, mesh=mesh, **kw)
    return [{n: [x.cpu().numpy() for x in tree_flatten(e[n])[0]]
             for n in e} for e in res], res


def _fused_equal(got, want, windows=3):
    assert len(got) == len(want) == windows
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for n in a:
            assert len(a[n]) == len(b[n])
            for x, y in zip(a[n], b[n]):
                assert x.dtype == y.dtype and np.array_equal(x, y), n


def _quartet_queries():
    from gelly_torch.library import (bipartiteness_query, cc_query,
                                     degrees_query, spanner_query)

    return [cc_query(512, fold_backend="kernel"), degrees_query(512),
            bipartiteness_query(512),
            spanner_query(512, 2, every=2, max_degree=8, gate_batch=256)]


def _codec_trio():
    from gelly_torch.library import (bipartiteness_query, cc_query,
                                     degrees_query)

    return [q(512, compressed=True, codec="sparse")
            for q in (cc_query, degrees_query, bipartiteness_query)]


@pytest.mark.parametrize("path", ["quartet", "codec", "mesh"])
def test_fused_multiquery_on_card_equals_cpu(cuda_device, path,
                                             monkeypatch):
    # The quartet's raw CC fold takes the dedup fold (and its gather) on
    # 1024-lane chunks; the spanner's every=2 merge launches entry 2.
    from gelly_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(tcc, "RAW_DEDUP_MIN_CHUNK", 1 << 10)
    queries = {"quartet": _quartet_queries, "codec": _codec_trio,
               "mesh": _codec_trio}[path]
    meshes = {"cuda": None, "cpu": None}
    kw = {}
    if path == "mesh":  # the codec engages with merge_every a multiple of S
        meshes = {d: make_mesh(4, devices=[d] * 4) for d in meshes}
        kw = dict(merge_every=4, fold_batch=4)
    before = (kernels.sorted_window_gather.launches,
              kernels.sparse_insert_edges_batched.launches)
    got, res = _fused_run(cuda_device, queries, meshes["cuda"], **kw)
    if path == "quartet":
        assert kernels.sorted_window_gather.launches > before[0]
        assert kernels.sparse_insert_edges_batched.launches > before[1]
    else:
        assert res.stats["multiquery.compressed_chunks"] == 6
    want, _ = _fused_run(torch.device("cpu"), queries, meshes["cpu"], **kw)
    _fused_equal(got, want, 2 if path == "mesh" else 3)


def test_fused_quartet_checkpoint_resumes_on_card(cuda_device, tmp_path):
    from gelly_torch.engine.multiquery import run_multiquery

    p = str(tmp_path / "ck.npz")

    def run(stop_after=None, **kw):
        res = run_multiquery(_quartet_queries(),
                             _spanner_stream("cuda", chunk=1024),
                             merge_every=2, checkpoint_path=p, **kw)
        out = []
        for e in res:
            assert e["spanner"].nbr.device.type == "cuda"
            out.append({n: [x.cpu().numpy() for x in tree_flatten(e[n])[0]]
                        for n in e})
            if len(out) == stop_after:
                break
        return out, res

    full, _ = run()
    run(stop_after=2)
    got, res = run(resume=True)
    assert res.stats["resumed_at"] == 2
    _fused_equal(full[:1] + got, full)


def test_traced_raw_kernel_run_equals_untraced(cuda_device, monkeypatch,
                                               tmp_path):
    # A small raw kernel run under a tracer and inside trace(): the same
    # emissions as untraced, one fold span a chunk, and the profile's
    # CUDA events hold the gather kernel as often as it launched.
    import glob
    import json

    from gelly_torch import obs
    from gelly_torch.utils.metrics import trace

    monkeypatch.setattr(tcc, "RAW_DEDUP_MIN_CHUNK", 1 << 14)
    n = 1 << 16
    rng = np.random.default_rng(17)
    src = (rng.zipf(1.3, 1 << 17) % n).astype(np.int32)
    dst = (rng.zipf(1.3, 1 << 17) % n).astype(np.int32)

    def run():
        s = edge_stream_from_source(
            EdgeChunkSource(src, dst, chunk_size=1 << 14,
                            table=IdentityVertexTable(n)), n, device="cuda")
        agg = tcc.connected_components(n, ingest_combine=False,
                                       fold_backend="kernel")
        return [x.cpu() for x in s.aggregate(agg, merge_every=4)]

    untraced = run()
    tr = obs.SpanTracer(heartbeat_every_s=None)
    log_dir = str(tmp_path / "prof")
    with obs.scope() as bus, obs.install(tr):
        before = kernels.sorted_window_gather.launches
        with trace(log_dir, tracer=tr):
            traced = run()
        torch.cuda.synchronize()
        launches = kernels.sorted_window_gather.launches - before
        counters = bus.snapshot()["counters"]
    assert len(traced) == len(untraced) == 2
    for a, b in zip(traced, untraced):
        assert torch.equal(a, b)
    assert len(tr.spans("fold")) == counters["engine.chunks_folded"] == 8
    assert counters["engine.windows_closed"] == 2
    assert launches > 0
    (path,) = glob.glob(f"{log_dir}/torch_profiler.*.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    gathers = [e for e in events if e.get("cat") == "kernel"
               and "sorted_window_gather_kernel" in e.get("name", "")]
    assert len(gathers) == launches
    names = [i["name"] for i in tr.instants()
             if i["name"].startswith("torch_profiler")]
    assert names == ["torch_profiler_start", "torch_profiler_stop"]
