"""gelly_torch's edge-list reading vs gelly_tpu's (CPU).

Mirrors ``tests/test_utils.py::test_native_parser_matches_python``: the
port builds ``native/edgelist_parser.cc`` with g++ into its own build
directory, and ``utils/native.parse_edge_list_file`` equals the numpy
parser and ``gelly_tpu``'s native parser on the same files (comments,
tabs, blank lines, negative and 64-bit ids, a value column). Then
``core/io.read_edge_list`` takes the native parser first, falls back to
the numpy parser when it raises, as ``gelly_tpu``'s does, and feeds a
file stream. Inputs are seeded with numpy; tolerance: none.
"""

import numpy as np
import pytest

from gelly_torch.core import io as tio
from gelly_torch.utils import native as tnative
from gelly_tpu.core import io as jio

TEXT = ("% header\n1 2\n3\t4 9.5\n# comment\n  5 6\n\n-7 8\n"
        "9000000000 9000000001\n")


def _jax_parse(path, want_vals=False):
    from _torch_native import load_jax_native

    load_jax_native("edgelist_parser")
    from gelly_tpu.utils.native import parse_edge_list_file

    return parse_edge_list_file(path, want_vals=want_vals)


def test_native_parser_matches_python(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text(TEXT)
    assert tnative.available("edgelist_parser")
    ns, nd = tnative.parse_edge_list_file(str(p))
    ps, pd, _ = tio.parse_edge_list_text(p.read_text())
    np.testing.assert_array_equal(ns, ps)
    np.testing.assert_array_equal(nd, pd)
    ns2, nd2, nv = tnative.parse_edge_list_file(str(p), want_vals=True)
    assert nv[1] == 9.5 and nv[0] == 1.0
    for mine, theirs in zip((ns, nd, ns2, nd2, nv),
                            (*_jax_parse(str(p)),
                             *_jax_parse(str(p), want_vals=True))):
        assert mine.dtype == theirs.dtype
        assert mine.tobytes() == theirs.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_native_parser_equals_both_packages_on_seeded_files(tmp_path, seed):
    rng = np.random.default_rng(seed)
    n = 5000
    src = rng.integers(-(1 << 40), 1 << 40, n)
    dst = rng.integers(0, 1 << 20, n)
    val = rng.random(n)
    lines = []
    for i in range(n):
        if i % 17 == 0:
            lines.append("% a comment")
        if i % 29 == 0:
            lines.append("garbage line")
        sep = "\t" if i % 3 else " "
        tail = f"{sep}{val[i]!r}" if i % 2 else ""
        lines.append(f"{src[i]}{sep}{dst[i]}{tail}")
    p = tmp_path / "edges.txt"
    p.write_text("\n".join(lines) + "\n")
    got = tnative.parse_edge_list_file(str(p), want_vals=True)
    want = tio.parse_edge_list_text(p.read_text(), num_value_cols=1)
    theirs = _jax_parse(str(p), want_vals=True)
    for a, b, c in zip(got, want, theirs):
        assert a.dtype == b.dtype == c.dtype
        assert a.tobytes() == b.tobytes() == c.tobytes()
    np.testing.assert_array_equal(got[0], src)


def test_read_edge_list_tries_native_then_falls_back(tmp_path, monkeypatch):
    p = tmp_path / "edges.txt"
    p.write_text(TEXT)
    calls = []
    real = tnative.parse_edge_list_file

    def spy(path, want_vals=False):
        calls.append(want_vals)
        return real(path, want_vals=want_vals)

    monkeypatch.setattr(tnative, "parse_edge_list_file", spy)
    for kw in ({}, {"num_value_cols": 1}):
        got = tio.read_edge_list(str(p), **kw)
        want = jio.read_edge_list(str(p), **kw)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.tobytes() == b.tobytes()
    assert calls == [False, True]
    # use_native=False and a delimiter both take the numpy parser.
    tio.read_edge_list(str(p), use_native=False)
    tio.read_edge_list(str(p), delimiter=" ")
    assert calls == [False, True]

    def broken(path, want_vals=False):
        calls.append("raised")
        raise MemoryError("native parser failed")

    monkeypatch.setattr(tnative, "parse_edge_list_file", broken)
    got = tio.read_edge_list(str(p))
    assert calls[-1] == "raised"
    np.testing.assert_array_equal(got[0], [1, 3, 5, -7, 9000000000])


def test_file_stream_reads_through_the_native_parser(tmp_path):
    from gelly_torch import edge_stream_from_file

    p = tmp_path / "edges.txt"
    p.write_text("1 2\n2 3\n3 1\n")
    s = edge_stream_from_file(str(p), vertex_capacity=16, chunk_size=2,
                              device="cpu")
    assert sorted((a, b) for a, b, _ in s.collect_edges()) == [
        (1, 2), (2, 3), (3, 1)]
