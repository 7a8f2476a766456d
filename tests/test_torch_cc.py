"""The gelly_torch streaming-CC slice vs gelly_tpu's raw device fold (CPU).

Same seeded Zipf stream into both packages, with ``RAW_DEDUP_MIN_CHUNK``
lowered in both so small chunks take the sort-dedup fold. gelly_tpu runs
``fold_backend="pallas"`` (interpret mode) on a one-device mesh; the port
runs ``fold_backend="kernel"`` (the kernel's plain version on CPU).
Tolerance: every emitted window's labels equal, dtype included, and the
same number of emissions.
"""

import ast
import importlib
import os

import jax
import numpy as np
import pytest
import torch

import gelly_torch
from gelly_torch import convert
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import EdgeStream as TEdgeStream
from gelly_torch.core.stream import StreamContext as TContext
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.library import connected_components as tcc
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.parallel.mesh import make_mesh

jcc = importlib.import_module("gelly_tpu.library.connected_components")

N = 1 << 12
BACKENDS = {"kernel": "pallas", "plain": "xla"}


def _zipf_stream(seed=13, e=2 * 1024 + 300):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.3, e) % N).astype(np.int32)
    dst = (rng.zipf(1.3, e) % N).astype(np.int32)
    return src, dst


@pytest.fixture
def dedup_at_256(monkeypatch):
    monkeypatch.setattr(jcc, "RAW_DEDUP_MIN_CHUNK", 256)
    monkeypatch.setattr(tcc, "RAW_DEDUP_MIN_CHUNK", 256)


def _jax_emissions(src, dst, backend, chunk_size):
    stream = j_stream(JSource(src, dst, chunk_size=chunk_size,
                              table=JIdentity(N)), N)
    agg = jcc.connected_components(N, merge="gather", ingest_combine=False,
                                   fold_backend=BACKENDS[backend])
    return [np.asarray(x) for x in
            stream.aggregate(agg, merge_every=4, mesh=make_mesh(1))]


def _torch_emissions(src, dst, backend, chunk_size):
    stream = t_stream(TSource(src, dst, chunk_size=chunk_size,
                              table=TIdentity(N)), N, device="cpu")
    agg = tcc.connected_components(N, merge="gather", ingest_combine=False,
                                   fold_backend=backend)
    assert agg.fold_backend == backend
    out = []
    for x in stream.aggregate(agg, merge_every=4):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        out.append(x.numpy())
    return out


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("chunk_size", [256, 200])
def test_cc_windows_match_gelly_tpu(dedup_at_256, backend, chunk_size):
    # 256-edge chunks take the dedup fold, 200-edge chunks the generic
    # union_edges fold; 2348 edges give a final partial window.
    src, dst = _zipf_stream()
    want = _jax_emissions(src, dst, backend, chunk_size)
    got = _torch_emissions(src, dst, backend, chunk_size)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert np.array_equal(g, w)
    # And the oracle: canonical min-slot labels, -1 for unseen slots.
    lab = tcc.cc_labels_numpy(src, dst, None, N)
    assert np.array_equal(got[-1], lab)


def test_cc_from_one_midstream_summary(dedup_at_256):
    # Fold a prefix in gelly_tpu, carry the forest over with convert.py,
    # then fold the rest in both packages from the same state.
    src, dst = _zipf_stream(seed=21)
    jchunks = list(JSource(src, dst, chunk_size=256, table=JIdentity(N)))
    tchunks = list(TSource(src, dst, chunk_size=256, table=TIdentity(N)))
    jagg = jcc.connected_components(N, merge="gather", ingest_combine=False,
                                    fold_backend="pallas")
    tagg = tcc.connected_components(N, merge="gather", ingest_combine=False,
                                    fold_backend="kernel")
    jfold = jax.jit(jagg.fold)
    js = jagg.init()
    for c in jchunks[:4]:
        js = jfold(js, c)
    ts = convert.cc_summary_from_numpy(np.asarray(js.parent),
                                       np.asarray(js.seen), device="cpu")
    back = convert.cc_summary_to_numpy(ts)
    assert np.array_equal(back[0], np.asarray(js.parent))
    assert np.array_equal(back[1], np.asarray(js.seen))
    for jc, tc in zip(jchunks[4:], tchunks[4:]):
        js = jfold(js, jc)
        ts = tagg.fold(ts, tc)
        np.testing.assert_array_equal(ts.parent.numpy(), np.asarray(js.parent))
        np.testing.assert_array_equal(ts.seen.numpy(), np.asarray(js.seen))
        labels = tagg.transform(ts).numpy()
        assert labels.dtype == np.int32
        assert np.array_equal(labels, np.asarray(jagg.transform(js)))
    with pytest.raises(TypeError):
        convert.cc_summary_from_numpy(np.zeros(4, np.int64),
                                      np.zeros(4, bool), device="cpu")


def test_plan_knobs_match_and_refuse():
    assert tcc.connected_components(N, ingest_combine=False).fold_backend \
        == "plain"
    with pytest.raises(ValueError, match="kernel"):
        tcc.connected_components(1000, ingest_combine=False,
                                 fold_backend="kernel")
    with pytest.raises(ValueError, match="fold_backend"):
        tcc.connected_components(N, ingest_combine=False, fold_backend="xla")
    # The default builds the codec plan gelly_tpu builds (dense below
    # 2^20 slots); the raw plan refuses the compact codec as JAX does.
    assert tcc.connected_components(N).host_compress is not None
    with pytest.raises(ValueError, match="ingest_combine"):
        tcc.connected_components(N, ingest_combine=False, codec="compact")
    # The pane ring and event-time windows are ported: the knobs build and
    # run; TTL decay off the compact plan refuses as JAX does.
    assert tcc.connected_components(N, windowed=2).windowed_panes == 2
    with pytest.raises(ValueError, match="compact"):
        tcc.connected_components(N, windowed=2, ttl_panes=2)
    src, dst = _zipf_stream()
    stream = t_stream(TSource(src, dst, chunk_size=256, table=TIdentity(N)),
                      N, device="cpu")
    agg = tcc.connected_components(N, ingest_combine=False)
    first = next(iter(stream.aggregate(agg, window_ms=10)))
    assert first.dtype == torch.int32 and first.shape == (N,)
    with pytest.raises(TypeError):
        stream.aggregate(agg, bogus_knob=1)


def test_labels_to_components_decodes_raw_ids():
    from gelly_torch.core.io import chunks_from_edges

    edges = [(10, 20), (20, 30), (40, 50), (60, 60)]
    src = chunks_from_edges(edges, chunk_size=4)
    stream = t_stream(src, 16, device="cpu")
    labels = stream.aggregate(
        tcc.connected_components(16, ingest_combine=False)).result()
    assert tcc.labels_to_components(labels, stream.ctx) == [
        [10, 20, 30], [40, 50], [60]]


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    src, dst = _zipf_stream()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEdgeStream(lambda: iter(()), TContext(TIdentity(N), N))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_stream(TSource(src, dst, table=TIdentity(N)), N)
    for agg in (tcc.connected_components(N),
                tcc.connected_components(1 << 20),
                tcc.connected_components(N, codec="compact")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            agg.init()


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_gelly_tpu():
    root = os.path.dirname(gelly_torch.__file__)
    files = [os.path.join(d, f) for d, _, fs in os.walk(root)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(os.path.dirname(root), "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gelly_tpu"), (path, mod)
