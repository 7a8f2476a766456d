"""gelly_torch kernels vs gelly_tpu's Pallas kernels (CPU).

The port's ``sorted_window_gather`` runs its plain PyTorch version on CPU
tensors; the JAX side runs the Pallas kernel in interpret mode, as
``tests/test_pallas_fold.py`` does. Tolerance: exact equality of the i32
outputs, ``-1`` (window-miss) lanes included.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch.ops import _build
from gelly_torch.ops import kernels as tk
from gelly_tpu.ops import pallas_kernels as pk

N = 1 << 12


def _jax_gather(table, idx, **kw):
    return np.asarray(pk.sorted_window_gather(
        jnp.asarray(table), jnp.asarray(idx), interpret=True, **kw))


def _torch_gather(table, idx, **kw):
    out = tk.sorted_window_gather(
        torch.from_numpy(table), torch.from_numpy(idx), **kw)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy()


def _cases():
    # The three cases of tests/test_pallas_fold.py.
    rng = np.random.default_rng(0)
    t0 = rng.integers(0, N, N).astype(np.int32)
    i0 = np.sort(rng.integers(0, N, 2000)).astype(np.int32)
    rng = np.random.default_rng(1)
    t1 = rng.integers(0, N, N).astype(np.int32)
    i1 = np.sort(np.concatenate([
        np.zeros(600, np.int32), np.full(900, 7, np.int32),
        np.full(3, N - 1, np.int32),
    ]))
    rng = np.random.default_rng(2)
    t2 = rng.integers(0, N, N).astype(np.int32)
    i2 = np.concatenate([
        np.sort(rng.integers(N // 2, N, 512)),
        np.sort(rng.integers(0, N // 2, 512)),
    ]).astype(np.int32)
    return {
        "sorted-uniform": (t0, i0, {"tile": 512}),
        "hot-duplicates-bounds": (t1, i1, {"tile": 512}),
        "piecewise-seam": (t2, i2, {"tile": 256, "window_rows": 4}),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_plain_gather_bit_identical_to_pallas(case):
    table, idx, kw = _cases()[case]
    want = _jax_gather(table, idx, **kw)
    got = _torch_gather(table, idx, **kw)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    hit = got >= 0
    assert np.array_equal(got[hit], table[idx][hit])
    if case == "piecewise-seam":
        assert not hit.all()  # the seam must be flagged, not fabricated


def test_gather_seam_misses_match_default_tile():
    # Default tile on a longer piecewise-sorted run (several tiles, one
    # seam), the layout union_edges_dedup hands the kernel.
    rng = np.random.default_rng(5)
    table = rng.integers(0, N, N).astype(np.int32)
    idx = np.concatenate([
        np.sort(rng.integers(0, N, 3000)),
        np.full(1200, N - 1),
    ]).astype(np.int32)
    assert np.array_equal(_torch_gather(table, idx, window_rows=2),
                          _jax_gather(table, idx, window_rows=2))


def test_gather_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        tk.sorted_window_gather(torch.zeros(1000, dtype=torch.int32),
                                torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        pk.sorted_window_gather(jnp.zeros(1000, jnp.int32),
                                jnp.zeros(8, jnp.int32))
    with pytest.raises(TypeError):
        tk.sorted_window_gather(torch.zeros(N, dtype=torch.int64),
                                torch.zeros(8, dtype=torch.int32))
    for n in (1000, (1 << 24) + 128, 1 << 12, 1 << 24, 256, 128, 0):
        assert tk.gatherable(n) == pk.gatherable(n), n
    assert tk.sorted_window_gather(
        torch.zeros(N, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32)).shape == (0,)


def test_blocked_gather_exact():
    rng = np.random.default_rng(3)
    table = rng.integers(0, N, N).astype(np.int32)
    idx = rng.integers(0, N, 1500).astype(np.int32)
    got = tk.blocked_gather(torch.from_numpy(table), torch.from_numpy(idx),
                            tile=512).numpy()
    assert np.array_equal(got, table[idx])
    assert np.array_equal(
        got, np.asarray(pk.blocked_gather(jnp.asarray(table),
                                          jnp.asarray(idx), tile=512)))
    # Small windows force misses, which the repair makes exact.
    got_w = tk.blocked_gather(torch.from_numpy(table),
                              torch.from_numpy(idx), window_rows=2).numpy()
    assert np.array_equal(got_w, table[idx])
    # Unblockable table: plain gather.
    t2 = rng.integers(0, 100, 100).astype(np.int32)
    i2 = rng.integers(0, 100, 64).astype(np.int32)
    assert np.array_equal(
        tk.blocked_gather(torch.from_numpy(t2), torch.from_numpy(i2)).numpy(),
        t2[i2])
    # Values beyond 2^24: the value guard falls back to the exact gather.
    t3 = (rng.integers(0, 1 << 30, N) | 1).astype(np.int32)
    assert np.array_equal(
        tk.blocked_gather(torch.from_numpy(t3), torch.from_numpy(idx),
                          tile=512).numpy(),
        t3[idx])


def test_kernel_wrapper_counts_no_cpu_launch():
    before = tk.sorted_window_gather.launches
    tk.sorted_window_gather(torch.arange(N, dtype=torch.int32),
                            torch.arange(64, dtype=torch.int32))
    assert tk.sorted_window_gather.launches == before


def test_negative_index_divergence_is_a_miss():
    # Outside both kernels' contract (indices in [0, n)), and the one lane
    # set where the packages differ (ROADMAP.md queue 3): the Pallas kernel
    # truncates -5 // 128 to row 0 and returns a fabricated 0, the port
    # returns the -1 miss marker, so a caller never takes it for a value.
    table = np.arange(N, dtype=np.int32) + 7
    idx = np.array([-200, -5, 0, 3], np.int32)
    assert _torch_gather(table, idx).tolist() == [-1, -1, 7, 10]
    assert _jax_gather(table, idx).tolist() == [-1, 0, 7, 10]


def test_build_freshness_follows_source_and_shared_headers(tmp_path,
                                                           monkeypatch):
    # No nvcc needed: only modification times are compared.
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))

    def touch(path, t):
        path.write_text("")
        os.utime(path, (t, t))

    touch(csrc / "k.cu", 100)
    assert not _build._fresh("k")  # no library yet
    touch(build / "libk.so", 200)
    assert _build._fresh("k")
    touch(csrc / "hopper.cuh", 300)  # a shared header changed
    assert not _build._fresh("k")
    touch(build / "libk.so", 400)
    assert _build._fresh("k")
    touch(csrc / "k.cu", 500)
    assert not _build._fresh("k")
    touch(csrc / "other.cu", 600)  # another library's source
    touch(build / "libk.so", 550)
    assert _build._fresh("k")
