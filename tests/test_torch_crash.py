"""kill -9 crash recovery of gelly_torch's durable paths (CPU).

The parent runs this file as a child process three times per mode: once
uninterrupted, once throttled and killed with SIGKILL as soon as two
checkpoints are on disk, and once more over the same checkpoints, which
resumes from the newest valid one. The resumed child's final forest must be
bit-identical to the uninterrupted child's. Two modes:

- ``resilient`` — ``ResilientRunner`` folding the raw CC plan chunk by
  chunk into a rotated checkpoint directory (as ``tests/_crash_child.py``
  does for ``gelly_tpu``);
- ``aggregation`` — ``run_aggregation`` with ``checkpoint_path`` over the
  compact CC plan (segments wire, id session rebuilt on resume).

Child: ``python tests/test_torch_crash.py <mode> <ckpt_dir> <out.npz>
[unit_sleep_s]``, with the repository root on ``PYTHONPATH``. Imports
only torch, numpy, pytest and gelly_torch.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from gelly_torch.engine.checkpoint import (
    CheckpointCorruptError,
    load_checkpoint,
    read_checkpoint_header,
    save_checkpoint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_V = 256
CHUNK = 32
N_EDGES = 64 * CHUNK
MERGE_EVERY = 4
FOLD_BATCH = 2


def _source():
    from gelly_torch.core.io import EdgeChunkSource
    from gelly_torch.core.vertices import IdentityVertexTable

    rng = np.random.default_rng(7)
    src = (rng.zipf(1.3, N_EDGES) % N_V).astype(np.int32)
    dst = (rng.zipf(1.3, N_EDGES) % N_V).astype(np.int32)
    return EdgeChunkSource(src, dst, chunk_size=CHUNK,
                           table=IdentityVertexTable(N_V))


def _slow(fn, sleep_s):
    if not sleep_s:
        return fn

    def slowed(*args):
        time.sleep(sleep_s)
        return fn(*args)

    return slowed


def child(mode: str, ckpt_dir: str, out: str, sleep_s: float) -> None:
    from gelly_torch.core.stream import edge_stream_from_source
    from gelly_torch.engine.resilience import ResilienceConfig, ResilientRunner
    from gelly_torch.library.connected_components import connected_components

    stream = edge_stream_from_source(_source(), N_V, device="cpu")
    if mode == "resilient":
        agg = connected_components(N_V, merge="gather", ingest_combine=False)
        fold = _slow(agg.fold, sleep_s)
        runner = ResilientRunner(
            lambda s, c: (fold(s, c), None), stream,
            lambda: agg.init("cpu"), checkpoint_dir=ckpt_dir,
            flatten_state=agg.flatten,
            config=ResilienceConfig(checkpoint_every_chunks=4,
                                    watchdog_timeout=None))
        final = runner.run()
        save_checkpoint(out, {"summary": final}, position=runner.position)
        return
    agg = connected_components(N_V, merge="gather", codec="compact",
                               compact_capacity=N_V)
    agg.fold_compressed = _slow(agg.fold_compressed, sleep_s)
    path = os.path.join(ckpt_dir, "ck.npz")
    res = stream.aggregate(agg, merge_every=MERGE_EVERY,
                           fold_batch=FOLD_BATCH, checkpoint_path=path,
                           resume=os.path.exists(path))
    labels = None
    for labels in res:
        pass
    summary, position, _ = load_checkpoint(path, like=agg.init("cpu"))
    save_checkpoint(out, {"labels": labels, "summary": summary},
                    position=position,
                    meta={"resumed_at": res.stats["resumed_at"]})


# ---------------------------------------------------------------------- #
# the test (parent side)

def _spawn(mode, ckpt_dir, out, sleep_s):
    os.makedirs(ckpt_dir, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(ckpt_dir),
         str(out), str(sleep_s)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )


def _wait(p, timeout=300):
    try:
        _, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise
    assert p.returncode == 0, err.decode()[-2000:]


def _checkpoints_on_disk(mode, ckpt_dir) -> int:
    if mode == "resilient":
        return len([f for f in os.listdir(ckpt_dir)
                    if f.startswith("ckpt-") and f.endswith(".npz")])
    path = os.path.join(ckpt_dir, "ck.npz")
    try:
        return read_checkpoint_header(path)["meta"]["windows"]
    except (FileNotFoundError, CheckpointCorruptError):
        return 0


@pytest.mark.faults
@pytest.mark.parametrize("mode", ["resilient", "aggregation"])
def test_kill9_recovery_bit_identical(tmp_path, mode):
    ckpt = tmp_path / "ckpt"
    out_resumed = tmp_path / "resumed.npz"
    out_clean = tmp_path / "clean.npz"
    _wait(_spawn(mode, tmp_path / "ckpt_clean", out_clean, 0.0))

    # Run 1: throttled so checkpoints land mid-stream; SIGKILL once two
    # are on disk (the newest might be mid-write).
    p = _spawn(mode, ckpt, out_resumed, 0.05)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        if p.poll() is not None:
            pytest.fail(f"child exited early (rc={p.returncode}) before "
                        f"the kill: {p.stderr.read().decode()[-2000:]}")
        if _checkpoints_on_disk(mode, ckpt) >= 2:
            break
        time.sleep(0.01)
    else:
        pytest.fail("no checkpoints appeared before the deadline")
    os.kill(p.pid, signal.SIGKILL)
    assert p.wait(timeout=60) == -signal.SIGKILL
    p.stderr.close()
    assert not out_resumed.exists()  # truly died mid-stream

    # Run 2: the same command resumes from the newest valid checkpoint.
    _wait(_spawn(mode, ckpt, out_resumed, 0.0))
    resumed, pos_r, meta_r = load_checkpoint(str(out_resumed))
    clean, pos_c, meta_c = load_checkpoint(str(out_clean))
    total = N_EDGES // CHUNK
    assert pos_r == pos_c == total
    if mode == "aggregation":
        assert meta_c["resumed_at"] is None
        assert 2 * MERGE_EVERY <= meta_r["resumed_at"] < total
    assert len(resumed) == len(clean)
    for a, b in zip(resumed, clean):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


if __name__ == "__main__":
    _mode, _dir, _out = sys.argv[1:4]
    child(_mode, _dir, _out, float(sys.argv[4]) if len(sys.argv) > 4 else 0.0)
