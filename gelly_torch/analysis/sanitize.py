"""Sanitizer lane: run the port's native host codecs under ASan / UBSan.

``GELLY_NATIVE_SANITIZE=asan|ubsan`` makes ``gelly_torch/utils/native.py``
build instrumented libraries (``gelly_torch/_build/lib<stem>.<mode>.so``,
a directory git ignores). Loading one into a plain CPython requires the
sanitizer runtime ahead of everything else, so this module prepares an
``LD_PRELOAD`` environment (runtime discovered via ``g++
-print-file-name``) and drives a smoke workload in a subprocess:

1. every native entry point — chunk combiner (dense, sparse, indexed),
   parity and degree codecs, compact session, unit builder, edge-list
   parser, matching and spanner folds — through ``utils/native.py``
   loaded by file path;
2. every host codec fold of the port's plans on the CPU
   (``device="cpu"``): CC dense, sparse and compact, bipartiteness dense
   and sparse, degrees dense and sparse, the spanner's host codec, the
   host matching and the file parser, each held equal to the same run on
   the numpy codecs.

Run it with ``python -m gelly_torch.analysis --sanitize asan|ubsan|both``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

_MODES = ("asan", "ubsan")
# Candidate runtime sonames per mode, most specific first (names differ
# across gcc majors; -print-file-name resolves whichever exists).
_RUNTIMES = {
    "asan": ("libasan.so", "libasan.so.8", "libasan.so.6", "libasan.so.5"),
    "ubsan": ("libubsan.so", "libubsan.so.1", "libubsan.so.0"),
}


def find_runtime(mode: str) -> str | None:
    """Absolute path of the sanitizer runtime library, or None."""
    if shutil.which("g++") is None:
        return None
    for name in _RUNTIMES[mode]:
        try:
            out = subprocess.run(
                ["g++", f"-print-file-name={name}"],
                capture_output=True, text=True, check=True,
            ).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            return None
        # An unresolved name is echoed back bare; a hit is a real path.
        if out and out != name and os.path.exists(out):
            return os.path.realpath(out)
    return None


def sanitizer_available(mode: str) -> bool:
    return find_runtime(mode) is not None


def sanitized_env(mode: str, base: dict | None = None) -> dict:
    """Environment for a subprocess that exercises sanitized natives."""
    if mode not in _MODES:
        raise ValueError(f"unknown sanitize mode {mode!r}")
    rt = find_runtime(mode)
    if rt is None:
        raise RuntimeError(f"no {mode} runtime found (g++ missing or "
                           "toolchain built without sanitizers)")
    env = dict(os.environ if base is None else base)
    env["GELLY_NATIVE_SANITIZE"] = mode
    prior = env.get("LD_PRELOAD")
    env["LD_PRELOAD"] = rt if not prior else f"{rt}:{prior}"
    if mode == "asan":
        # CPython itself is uninstrumented: leak checking would drown the
        # report in interpreter allocations. Errors still abort non-zero.
        env.setdefault("ASAN_OPTIONS", "detect_leaks=0")
    else:
        env.setdefault("UBSAN_OPTIONS", "halt_on_error=1:print_stacktrace=1")
    return env


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_smoke(mode: str, timeout: float = 600.0):
    """Run the native smoke workload under ``mode`` in a subprocess.

    Returns the completed process (``returncode == 0`` means every fold
    ran clean under the sanitizer).
    """
    cmd = [sys.executable, os.path.abspath(__file__), "--smoke"]
    env = sanitized_env(mode)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    return subprocess.run(
        cmd, env=env, capture_output=True, text=True, timeout=timeout,
    )


# ------------------------------------------------------------------ #
# the smoke driver (runs inside the sanitized subprocess)

def _load_native_module():
    """Load gelly_torch/utils/native.py by file path, apart from the
    package (part 1 of the smoke)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "utils", "native.py")
    spec = importlib.util.spec_from_file_location(
        "_gelly_native_smoke", os.path.abspath(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke(native=None) -> list[str]:
    """Exercise every native component; returns failure descriptions.

    Covers the code paths the combiners/folds take in production:
    masked and unmasked edges, sparse codecs, session assign/lookup/
    rebuild including the rollback error paths, the streaming unit
    builder, the parser's comment/weight grammar, and the matching and
    spanner chunk folds.
    """
    import numpy as np

    nat = native if native is not None else _load_native_module()
    failures: list[str] = []

    def check(name, cond):
        if not cond:
            failures.append(name)

    # --- edge-list parser ------------------------------------------- #
    with tempfile.NamedTemporaryFile(
            "w", suffix=".txt", delete=False) as f:
        f.write("# comment\n1 2 1.5\n% also comment\n2 3\n bad line\n3 1 .25\n")
        path = f.name
    try:
        s, d, v = nat.parse_edge_list_file(path, want_vals=True)
        check("parser.src", s.tolist() == [1, 2, 3])
        check("parser.dst", d.tolist() == [2, 3, 1])
        check("parser.val", v.tolist() == [1.5, 1.0, 0.25])
    finally:
        os.unlink(path)

    # --- chunk combiner --------------------------------------------- #
    src = np.array([0, 2, 1, 3], np.int32)
    dst = np.array([1, 3, 2, 4], np.int32)
    labels = nat.cc_chunk_combine(src, dst, None, 6)
    check("cc.labels", labels.tolist() == [0, 0, 0, 0, 0, -1])
    valid = np.array([1, 1, 0, 1], np.uint8)
    labels = nat.cc_chunk_combine(src, dst, valid, 6)
    check("cc.masked", labels.tolist() == [0, 0, 2, 2, 2, -1])

    tri_s = np.array([0, 1, 2], np.int32)
    tri_d = np.array([1, 2, 0], np.int32)
    _, parity, conflict = nat.parity_chunk_combine(tri_s, tri_d, None, 3)
    check("parity.odd_cycle", conflict)
    check("parity.parity", parity[0] == 0)

    deltas = nat.degree_chunk_deltas(src, dst, None, None, 6)
    check("degree.dense", deltas.tolist() == [1, 2, 2, 2, 1, 0])

    if nat.sparse_codecs_available():
        vs, rs = nat.cc_chunk_combine_sparse(src, dst, None, 6)
        check("cc.sparse", sorted(vs.tolist()) == [0, 1, 2, 3, 4]
              and set(rs.tolist()) == {0})
        vs, rs, ps, cf = nat.parity_chunk_combine_sparse(
            tri_s, tri_d, None, 3)
        check("parity.sparse", cf and len(vs) == 3)
        vs, ds = nat.degree_chunk_deltas_sparse(src, dst, None, None, 6)
        check("degree.sparse", dict(zip(vs.tolist(), ds.tolist()))
              == {0: 1, 1: 2, 2: 2, 3: 2, 4: 1})
    if nat.sparse_idx_available():
        vs, rs, ri = nat.cc_chunk_combine_sparse_idx(src, dst, None, 6)
        check("cc.sparse_idx",
              all(vs[ri[j]] == rs[j] for j in range(len(vs))))

    # --- compact session -------------------------------------------- #
    if nat.compact_session_available():
        sess = nat.NativeCompactSession(8)
        cids, new_ids, base = sess.assign(np.array([30, 10, 30, 20], np.int32))
        check("session.assign", cids.tolist() == [0, 1, 0, 2]
              and new_ids.tolist() == [30, 10, 20] and base == 0)
        out, bad = sess.lookup(np.array([10, 99], np.int32))
        check("session.lookup", out.tolist() == [1, -1] and bad == 1)
        _, _, base = sess.assign(np.arange(100, 110, dtype=np.int32))
        check("session.overflow", base == -1)
        check("session.overflow_rollback", sess.assigned == 3)
        try:
            sess.assign(np.array([-1], np.int32))
            check("session.negative_raises", False)
        except ValueError:
            pass
        # force growth past the initial table size
        big = nat.NativeCompactSession(5000)
        ids = np.arange(4000, dtype=np.int32)
        cids, _, _ = big.assign(ids)
        check("session.grow", cids.tolist() == list(range(4000)))
        vo = np.full(8, -1, np.int32)
        vo[:3] = [7, 8, 9]
        sess.reset()
        sess.rebuild(vo)
        check("session.rebuild", sess.lookup(
            np.array([8], np.int32))[0].tolist() == [1])
        try:
            sess.rebuild(np.full(9, -1, np.int32))
            check("session.rebuild_overflow_raises", False)
        except ValueError:
            pass

    # --- unit builder ----------------------------------------------- #
    if nat.unit_segments_available():
        b = nat.UnitForestBuilder(8, block=2)
        b.add(src, dst, None)
        b.add(np.array([5], np.int32), np.array([6], np.int32), None)
        members, lengths = b.finish()
        check("unit.counts", len(members) == 7 and sorted(lengths.tolist())
              == [2, 5])
        mv, ml = nat.cc_unit_forest_segments(src, dst, None, 8)
        check("unit.oneshot", len(mv) == 5 and ml.tolist() == [5])

    # --- matching fold ---------------------------------------------- #
    n_v = 5
    partner = np.full(n_v, -1, np.int32)
    weight = np.zeros(n_v, np.float64)
    ev = nat.matching_chunk_fold(
        np.array([0, 2, 0], np.int32), np.array([1, 3, 2], np.int32),
        np.array([1.0, 5.0, 100.0], np.float64), None, n_v,
        partner, weight, want_events=True)
    check("matching.partner", partner.tolist() == [2, -1, 0, -1, -1])
    check("matching.events", ev is not None and len(ev[0]) >= 2)

    # --- spanner fold ------------------------------------------------ #
    n_v, k, max_degree = 4, 2, 4
    nbr = np.zeros((n_v, max_degree), np.int32)
    deg = np.zeros(n_v, np.int32)
    stamp = np.zeros(n_v, np.int32)
    meta = np.zeros(3, np.int64)
    out_s = np.zeros(16, np.int32)
    out_d = np.zeros(16, np.int32)
    nat.spanner_chunk_fold(
        np.array([0, 1, 0], np.int32), np.array([1, 2, 1], np.int32),
        None, n_v, k, max_degree, nbr, deg, stamp, meta, out_s, out_d)
    check("spanner.accepted", meta[1] == 2)  # duplicate (0,1) gated

    return failures


def _plan_results(edges, weighted):
    """Every host codec fold of the port's plans over ``edges`` on the
    CPU: name -> host numpy result."""
    import numpy as np

    from gelly_torch import edge_stream_from_edges
    from gelly_torch.core.device import to_numpy
    from gelly_torch.library.bipartiteness import bipartiteness_check
    from gelly_torch.library.connected_components import (
        connected_components,
        connected_components_compact,
    )
    from gelly_torch.library.degrees import degree_aggregate
    from gelly_torch.library.matching import weighted_matching
    from gelly_torch.library.spanner import spanner

    n = 64

    def stream(data=edges):
        return edge_stream_from_edges(data, vertex_capacity=n,
                                      chunk_size=32, device="cpu")

    def run(agg, data=edges):
        res = stream(data).aggregate(agg, merge_every=2).result()
        leaves = res if isinstance(res, tuple) else (res,)
        return [to_numpy(x) for x in leaves]

    out = {}
    for codec in ("dense", "sparse"):
        out[f"cc.{codec}"] = run(connected_components(n, codec=codec))
        # An odd cycle leaves the parities unspecified: hold the codecs
        # to each other on a bipartite graph (odd endpoint sums).
        out[f"bipartiteness.{codec}"] = run(
            bipartiteness_check(n, codec=codec),
            [(a, b) for a, b in edges if (a + b) % 2])
        out[f"degrees.{codec}"] = run(degree_aggregate(n, codec=codec))
    out["cc.compact"] = run(connected_components_compact(n))
    out["spanner.codec"] = run(spanner(n, 3, ingest_combine=True,
                                       payload_cap=32))
    wm = weighted_matching(stream(weighted))
    out["matching.host"] = [np.asarray(
        sorted((e.src, e.dst, e.weight) for e in wm.events()), float)]
    return out


def plan_smoke() -> list[str]:
    """Part 2: each host codec fold on the native codecs against the same
    plan on the numpy codecs (every native stem disabled)."""
    import numpy as np

    from gelly_torch import edge_stream_from_file
    from gelly_torch.utils import native

    rng = np.random.default_rng(7)
    pairs = rng.integers(0, 48, size=(200, 2))
    edges = [(int(a), int(b)) for a, b in pairs if a != b]
    weighted = [(a, b, float(1 + (a * 7 + b) % 13)) for a, b in edges]
    failures: list[str] = []
    stems = ("chunk_combiner", "spanner", "matching", "edgelist_parser")
    missing = [st for st in stems if not native.available(st)]
    if missing:
        return [f"plan.native_unavailable:{','.join(missing)}"]
    got = _plan_results(edges, weighted)
    with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                     delete=False) as f:
        f.writelines(f"{a} {b}\n" for a, b in edges)
        path = f.name
    try:
        parsed = edge_stream_from_file(
            path, vertex_capacity=64, device="cpu").collect_edges()
        for st in stems:
            native.disable(st, "sanitizer smoke: numpy reference")
        try:
            want = _plan_results(edges, weighted)
            want_parsed = edge_stream_from_file(
                path, vertex_capacity=64, device="cpu").collect_edges()
        finally:
            for st in stems:
                native.reenable(st)
    finally:
        os.unlink(path)
    if parsed != want_parsed or len(parsed) != len(edges):
        failures.append("plan.parser")
    for name, leaves in got.items():
        ref = want[name]
        if len(leaves) != len(ref) or not all(
                a.shape == b.shape and np.array_equal(a, b)
                for a, b in zip(leaves, ref)):
            failures.append(f"plan.{name}")
    return failures


def main(argv) -> int:
    if "--smoke" not in argv:
        print("usage: sanitize.py --smoke  (run under sanitized env)",
              file=sys.stderr)
        return 2
    failures = smoke() + plan_smoke()
    if failures:
        print("SMOKE FAILURES: " + ", ".join(failures), file=sys.stderr)
        return 1
    print("native sanitizer smoke: all folds and host codecs clean "
          f"(mode={os.environ.get('GELLY_NATIVE_SANITIZE', 'off') or 'off'})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
