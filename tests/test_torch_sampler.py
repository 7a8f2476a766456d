"""gelly_torch's Threefry PRNG and sampled triangle estimator vs gelly_tpu
(CPU).

The PRNG functions are held to ``jax.random`` (x64 on, as ``gelly_tpu``
turns it on) on the bits; the estimator's ``SamplerState`` to
``gelly_tpu``'s after every chunk, padding lanes and self-loops included,
from seeded numpy streams. Tolerance: exact equality of every key, draw
and state field; ``sampler_estimate`` within ``rtol=1e-6`` (an f32 sum
whose order differs between the packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_tpu  # noqa: F401  (turns x64 on)
import gelly_tpu.library.triangles as jtri
from gelly_torch import convert
from gelly_torch.core.chunk import make_chunk as t_chunk
from gelly_torch.core.stream import edge_stream_from_edges as t_edges
from gelly_torch.library import sampled_triangle_count as t_sampled
from gelly_torch.library import triangles as ttri
from gelly_torch.ops import kernels, threefry
from gelly_tpu.core.chunk import make_chunk as j_chunk
from gelly_tpu.core.stream import edge_stream_from_edges as j_edges
from gelly_tpu.library import sampled_triangle_count as j_sampled

SEEDS = [0, 1, 7, 0xDEADBEEF, 2 ** 40 + 5, 2 ** 63 - 1]


def _keys(seed, n):
    return (jax.random.split(jax.random.PRNGKey(seed), n),
            threefry.split(threefry.prng_key(seed), n))


def _u32(x):
    return np.asarray(x).astype(np.int64)


# --------------------------------------------------------------------- #
# the PRNG


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_equals_jax(seed):
    want = _u32(jax.random.PRNGKey(seed))
    got = threefry.prng_key(seed)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    if seed == 0xDEADBEEF:
        assert want.tolist() == [0, 3735928559]


@pytest.mark.parametrize("seed,n", [(0, 1), (3, 2), (0xDEADBEEF, 7),
                                    (11, 64)])
def test_split_equals_jax(seed, n):
    jk, tk_ = _keys(seed, n)
    assert np.array_equal(tk_.numpy(), _u32(jk))
    again = jax.vmap(lambda k: jax.random.split(k, 3))(jk)
    assert np.array_equal(threefry.split(tk_, 3).numpy(), _u32(again))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_threefry2x32_equals_jax(seed):
    from jax._src import prng

    rng = np.random.default_rng(seed % 1000)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, 10, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
    a, b = threefry.threefry2x32(
        torch.tensor(int(k[0])), torch.tensor(int(k[1])),
        torch.from_numpy(x[:5].astype(np.int64)),
        torch.from_numpy(x[5:].astype(np.int64)))
    assert np.array_equal(torch.cat([a, b]).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_random_bits_equal_jax(seed):
    jk, tk_ = _keys(seed, 33)
    b32 = jax.vmap(lambda k: jax.random.bits(k, dtype=jnp.uint32))(jk)
    assert np.array_equal(threefry.random_bits(tk_, 32).numpy(), _u32(b32))
    b64 = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, dtype=jnp.uint64))(jk))
    hi, lo = threefry.random_bits(tk_, 64)
    got = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy(
    ).astype(np.uint64)
    assert np.array_equal(got, b64)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uniform_f64_equals_jax(seed):
    jk, tk_ = _keys(seed, 257)
    want = np.asarray(jax.vmap(jax.random.uniform)(jk))
    assert want.dtype == np.float64
    got = threefry.uniform(tk_)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("maxval", [1, 2, 3, 7, 100, 65535, 65536, 65537,
                                    1 << 20, 12345678, 2 ** 31 - 1])
def test_randint_equals_jax(maxval):
    jk, tk_ = _keys(maxval, 129)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (), 0, jnp.int32(maxval), jnp.int32))(jk))
    got = threefry.randint(tk_, torch.full((129,), maxval, dtype=torch.int32))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# --------------------------------------------------------------------- #
# the reservoir step


def _state_equal(tstate, jstate):
    for name, a, b in zip(ttri.SamplerState._fields, tstate, jstate):
        b = np.asarray(b)
        if name == "keys":
            assert b.dtype == np.uint32 and a.dtype == torch.int64
            b = b.astype(np.int64)
        else:
            assert a.numpy().dtype == b.dtype, name
        assert np.array_equal(a.numpy(), b), name


def _lanes(n_v, n_e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_v, n_e).astype(np.int32)
    dst = rng.integers(0, n_v, n_e).astype(np.int32)
    src[::11] = dst[::11]  # self-loops
    return src, dst


def test_fresh_sampler_equals_jax():
    _state_equal(ttri._fresh_sampler(64, 0xDEADBEEF),
                 jtri._fresh_sampler(64, 0xDEADBEEF))


@pytest.mark.parametrize("S,n_v,size,cap,seed", [
    (32, 12, 40, 64, 1),   # padding lanes: 24 a chunk
    (64, 30, 64, 64, 2),
    (16, 6, 25, 25, 3),    # dense: many closed wedges
    (128, 200, 100, 128, 4),
])
def test_sampler_state_after_every_chunk_equals_jax(S, n_v, size, cap, seed):
    src, dst = _lanes(n_v, 300, seed)
    jstate = jtri._fresh_sampler(S, seed)
    tstate = ttri._fresh_sampler(S, seed)
    for lo in range(0, 300, size):
        s, d = src[lo:lo + size], dst[lo:lo + size]
        jstate = jtri._sampler_step(jstate, j_chunk(s, d, capacity=cap),
                                    jnp.int32(n_v))
        tstate = ttri._sampler_step(
            tstate, t_chunk(s, d, capacity=cap, device="cpu"), n_v)
        _state_equal(tstate, jstate)
        np.testing.assert_allclose(
            ttri.sampler_estimate(tstate), jtri.sampler_estimate(jstate),
            rtol=1e-6)
        np.testing.assert_allclose(
            ttri.sampler_estimate(tstate, n_v),
            jtri.sampler_estimate(jstate, n_v), rtol=1e-6)
    assert int(tstate.edge_count) == int((src != dst).sum())
    if n_v <= 12:
        assert bool((tstate.src_found & tstate.trg_found).any())


def test_padding_and_self_loops_advance_every_key():
    # A chunk of only padding and self-loops moves the keys and nothing
    # else, as in JAX.
    s = np.array([3, 4, 5], np.int32)
    jstate = jtri._sampler_step(jtri._fresh_sampler(8, 5),
                                j_chunk(s, s, capacity=6), jnp.int32(9))
    tstate = ttri._sampler_step(ttri._fresh_sampler(8, 5),
                                t_chunk(s, s, capacity=6, device="cpu"), 9)
    _state_equal(tstate, jstate)
    fresh = ttri._fresh_sampler(8, 5)
    assert int(tstate.edge_count) == 0
    assert torch.equal(tstate.src, fresh.src)
    assert not torch.equal(tstate.keys, fresh.keys)


def test_kernel_wrapper_runs_the_plain_version_on_the_cpu():
    src, dst = _lanes(20, 64, 6)
    state = tuple(ttri._fresh_sampler(16, 3))
    args = (torch.from_numpy(src), torch.from_numpy(dst),
            torch.ones(64, dtype=torch.bool))
    before = kernels.sampler_step.launches
    a = kernels.sampler_step(state, *args, 20)
    b = kernels.sampler_step_plain(state, *args, 20)
    assert kernels.sampler_step.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="want"):
        kernels.sampler_step(state, args[0].long(), *args[1:], 20)


@pytest.mark.parametrize("num_vertices", [None, 10])
def test_sampled_triangle_count_stream_equals_jax(num_vertices):
    import itertools

    edges = list(itertools.combinations(range(10), 2)) * 2
    edges += [(3, 3), (4, 4)]
    kw = dict(vertex_capacity=1024, chunk_size=16)
    want = list(j_sampled(j_edges(edges, **kw), 128, num_vertices, seed=7))
    got = list(t_sampled(t_edges(edges, device="cpu", **kw), 128,
                         num_vertices, seed=7))
    assert len(got) == len(want) == -(-len(edges) // 16)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert want[-1] > 0


def test_live_vertex_count_equals_fixed():
    # The reference's test: on a stream whose vertices all appear in its
    # first chunk, the default (live count) equals num_vertices fixed.
    import itertools

    edges = list(itertools.combinations(range(10), 2))
    kw = dict(vertex_capacity=1024, chunk_size=64, device="cpu")
    auto = list(t_sampled(t_edges(edges, **kw), 256, seed=7))
    fixed = list(t_sampled(t_edges(edges, **kw), 256, num_vertices=10,
                           seed=7))
    assert auto == fixed


def test_mesh_is_not_ported():
    # The mesh path is ported (tests/test_torch_sharded_library.py); an
    # instance count the shards do not divide raises as gelly_tpu's does.
    from gelly_torch.parallel.mesh import make_mesh as t_make_mesh

    t = t_edges([(0, 1)], vertex_capacity=8, device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        t_sampled(t, 8, mesh=t_make_mesh(3, devices=["cpu"] * 3))


@pytest.mark.parametrize("split", [1, 3])
def test_resume_from_jax_state(split):
    src, dst = _lanes(16, 320, 8)
    jstate = jtri._fresh_sampler(32, 11)
    chunks = [(src[lo:lo + 64], dst[lo:lo + 64]) for lo in range(0, 320, 64)]
    for s, d in chunks[:split]:
        jstate = jtri._sampler_step(jstate, j_chunk(s, d), jnp.int32(16))
    tstate = convert.sampler_state_from_numpy(
        *(np.asarray(x) for x in jstate), device="cpu")
    back = convert.sampler_state_to_numpy(tstate)
    assert back[7].dtype == np.uint32
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, jstate))
    for s, d in chunks[split:]:
        jstate = jtri._sampler_step(jstate, j_chunk(s, d), jnp.int32(16))
        tstate = ttri._sampler_step(tstate, t_chunk(s, d, device="cpu"), 16)
    _state_equal(tstate, jstate)
