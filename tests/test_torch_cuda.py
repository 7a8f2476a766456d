"""gelly_torch on the card: each CUDA kernel vs its plain version, and the
CC and window-triangle paths on CUDA vs the same paths on the CPU.

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
