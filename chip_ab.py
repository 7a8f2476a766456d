#!/usr/bin/env python3
"""Time gelly_torch's raw CC path and window-triangle path, or its
bipartiteness plans, on one CUDA card for several checkouts, each in its
own process, in the order given.

    python3 chip_ab.py [--cc-only | --bip-only] [--reps=R] OLD_TREE . . OLD_TREE

A checkout is a directory holding a ``gelly_torch`` package (the repo root,
or an older commit unpacked with ``git archive``). For each one, in turn,
a child process builds that checkout's kernels, runs each path once to
warm up and then ``--reps`` times (default 3), and prints one JSON line
with every wall:

- the raw CC path of ``chip_smoke.py`` phase 4: ``2^26`` Zipf edges over
  ``2^24`` slots in ``2^22``-edge chunks, ``merge_every=4``, with
  ``fold_backend="kernel"`` and ``"plain"``;
- the triangle path of phase 6: ``2^24`` Zipf edges over ``2^15`` slots,
  EVENT time, 4 windows, ``window_triangle_counts_batched(batch=4)``
  (skipped with ``--cc-only``);
- with ``--bip-only``, instead of both: the bipartiteness check of
  ``chip_smoke.py`` phase E2, the CC stream made bipartite (``src & ~1``,
  ``dst | 1``) over ``2^24`` slots in ``2^22``-edge chunks,
  ``merge_every=4``, ``fold_batch=4``, through the sparse codec, the
  dense codec and the raw fold.

The streams (seed 17) are made once and shared through ``.npy`` files
under ``.scratch/ab/`` beside this script. Alternating the order (old,
new, new, old) lets machine drift show as a difference between the two
runs of one checkout. Needs a card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N_VERTICES = 1 << 24
N_EDGES = 1 << 26
CHUNK = 1 << 22
MERGE_EVERY = 4
TRI_N = 1 << 15
TRI_EDGES = 1 << 24
TRI_WINDOW_MS = 1 << 22
TRI_WINDOW_CAPACITY = 1 << 23
TRI_CHUNK = 1 << 20
TRI_BATCH = 4
SEED = 17

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".scratch", "ab")


def synth_edges(num_edges: int, num_vertices: int, seed: int):
    """Zipf endpoints over a permuted id space (bench.py:synth_edges)."""
    rng = np.random.default_rng(seed)
    src = rng.zipf(1.3, size=num_edges) % num_vertices
    dst = rng.zipf(1.3, size=num_edges) % num_vertices
    perm = rng.permutation(num_vertices)
    return perm[src].astype(np.int32), perm[dst].astype(np.int32)


def streams():
    """The two streams, made once and cached as .npy files."""
    os.makedirs(CACHE, exist_ok=True)
    out = {}
    for name, (e, n) in {"cc": (N_EDGES, N_VERTICES),
                         "tri": (TRI_EDGES, TRI_N)}.items():
        paths = [os.path.join(CACHE, f"{name}_{s}.npy") for s in "sd"]
        if not all(os.path.exists(p) for p in paths):
            for p, a in zip(paths, synth_edges(e, n, SEED)):
                np.save(p, a)
        out[name] = tuple(np.load(p) for p in paths)
    return out


def child(tree: str, cc_only: bool, bip_only: bool, reps: int) -> dict:
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    import gelly_torch
    from gelly_torch.core.io import EdgeChunkSource, TimeCharacteristic
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.core.vertices import IdentityVertexTable
    from gelly_torch.library import bipartiteness as bp
    from gelly_torch.library import connected_components as cc
    from gelly_torch.library import triangles as tri
    from gelly_torch.ops import _build

    if not os.path.abspath(gelly_torch.__file__).startswith(
            os.path.abspath(tree) + os.sep):
        raise SystemExit(f"chip_ab: gelly_torch did not load from {tree}")
    _build.build_all()
    data = streams()
    src, dst = data["cc"]
    tsrc, tdst = data["tri"]
    tts = np.arange(TRI_EDGES, dtype=np.int64)

    def cc_wall(backend: str) -> float:
        stream = edge_stream_from_source(
            EdgeChunkSource(src, dst, chunk_size=CHUNK,
                            table=IdentityVertexTable(N_VERTICES)),
            N_VERTICES)
        agg = cc.connected_components(N_VERTICES, merge="gather",
                                      ingest_combine=False,
                                      fold_backend=backend)
        torch.cuda.synchronize()
        t = time.perf_counter()
        list(stream.aggregate(agg, merge_every=MERGE_EVERY))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def tri_wall() -> float:
        stream = edge_stream_from_source(
            EdgeChunkSource(tsrc, tdst, timestamps=tts, chunk_size=TRI_CHUNK,
                            table=IdentityVertexTable(TRI_N),
                            time=TimeCharacteristic.EVENT), TRI_N)
        t = time.perf_counter()
        counts = [c for _, c in tri.window_triangle_counts_batched(
            stream, TRI_WINDOW_MS, window_capacity=TRI_WINDOW_CAPACITY,
            method="auto", batch=TRI_BATCH)]
        torch.stack(counts).cpu()
        return time.perf_counter() - t

    bsrc, bdst = (src & ~1, dst | 1) if bip_only else (None, None)

    def bip_wall(**plan) -> float:
        stream = edge_stream_from_source(
            EdgeChunkSource(bsrc, bdst, chunk_size=CHUNK,
                            table=IdentityVertexTable(N_VERTICES)),
            N_VERTICES)
        agg = bp.bipartiteness_check(N_VERTICES, **plan)
        torch.cuda.synchronize()
        t = time.perf_counter()
        list(stream.aggregate(agg, merge_every=MERGE_EVERY,
                              fold_batch=MERGE_EVERY))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    out = {"tree": tree}
    if bip_only:
        paths = [("bip_sparse_s", lambda: bip_wall()),
                 ("bip_dense_s", lambda: bip_wall(codec="dense")),
                 ("bip_raw_s", lambda: bip_wall(ingest_combine=False))]
    else:
        paths = [("cc_kernel_s", lambda: cc_wall("kernel")),
                 ("cc_plain_s", lambda: cc_wall("plain"))]
    if not (cc_only or bip_only):
        paths.append(("tri_s", tri_wall))
    for name, fn in paths:
        fn()  # warm-up
        out[name] = [fn() for _ in range(reps)]
    return out


def main() -> int:
    args = sys.argv[1:]
    opts = [a for a in args if a.startswith("--") and a != "--child"]
    args = [a for a in args if a not in opts]
    cc_only = "--cc-only" in opts
    bip_only = "--bip-only" in opts
    reps = int(next((a.split("=", 1)[1] for a in opts
                     if a.startswith("--reps=")), 3))
    if len(args) >= 2 and args[0] == "--child":
        print(json.dumps(child(args[1], cc_only, bip_only, reps)))
        return 0
    trees = args
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    streams()
    for tree in trees:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree]
            + opts,
            capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
