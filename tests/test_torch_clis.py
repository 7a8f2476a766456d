"""The port's example CLIs (``gelly_torch/examples/``) on the CPU.

Mirrors ``tests/test_clis.py`` with ``--device=cpu``, then holds every
CLI's stdout to its ``gelly_tpu`` script's on the same input (the
built-in data and a seeded edge file), line for line apart from the
``# `` and ``Runtime:`` lines, and drives the paths a user runs beside
the defaults: ``--serve``/``--connect`` over loopback (raw, and
compressed and stacked), ``--shards=2`` and ``--checkpoint-dir`` with a
resume after an injected crash, each held to the components of
``gelly_tpu``'s script on the same file, and the refusal of
``--device=cuda`` without a card.
"""

import importlib
import io
import os
import subprocess
import sys
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "gelly_torch", "examples")
JAX_DIR = os.path.join(REPO, "examples")

# Derived from the directory so a new example cannot ship without a test.
ALL_EXAMPLES = sorted(
    f[:-3]
    for f in os.listdir(PORT_DIR)
    if f.endswith(".py") and f not in ("_util.py", "__init__.py")
)
CPU = "--device=cpu"


def run_main(name, args=(), device=CPU):
    mod = importlib.import_module(f"gelly_torch.examples.{name}")
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main(list(args) + ([device] if device else []))
    return buf.getvalue()


def run_jax_main(name, args=()):
    if JAX_DIR not in sys.path:
        sys.path.insert(0, JAX_DIR)
    mod = importlib.import_module(name)
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main(list(args))
    return buf.getvalue()


def _held(out):
    """The lines two runs must agree on."""
    return [ln for ln in out.splitlines()
            if not ln.startswith(("# ", "Runtime:"))]


def _components(out):
    return [ln for ln in out.splitlines() if not ln.startswith("#")]


# --------------------------------------------------------------------- #
# tests/test_clis.py on the port

def test_port_examples_match_the_jax_examples():
    jax = sorted(f[:-3] for f in os.listdir(JAX_DIR)
                 if f.endswith(".py") and f != "_util.py")
    assert ALL_EXAMPLES == jax


@pytest.mark.parametrize("name", ALL_EXAMPLES)
def test_example_main_runs_on_default_data(name):
    out = run_main(name)
    assert out.strip(), f"{name} produced no output"


def test_window_triangles_golden():
    # WindowTrianglesITCase golden: "(2,399) (3,799) (2,1199)".
    out = run_main("window_triangles")
    assert "(2,399)" in out and "(3,799)" in out and "(2,1199)" in out


def test_degree_distribution_golden():
    out = run_main("degree_distribution")
    assert "(1,2)" in out


def test_connected_components_components():
    out = run_main("connected_components")
    assert out.startswith("1: [1, 3, 5")
    assert "\n2: [2, 4, 6" in out
    assert out.count("\n") == 2  # two component lines, one trailing \n


def test_matching_total_weight():
    out = run_main("centralized_weighted_matching")
    assert "total weight:" in out


def test_connected_components_fused_queries():
    out = run_main("connected_components",
                   ["--queries=cc,degrees,bipartiteness"])
    assert "cc 1: [1, 3, 5" in out
    assert "cc 2: [2, 4, 6" in out
    assert "degrees top:" in out
    assert "bipartiteness: ok" in out
    with pytest.raises(SystemExit, match="single-query"):
        run_main("connected_components",
                 ["--queries=cc", "--checkpoint-dir=/tmp/x"])
    with pytest.raises(SystemExit, match="unknown --queries"):
        run_main("connected_components", ["--queries=nope"])


def test_connected_components_stats_flag_validation():
    with pytest.raises(SystemExit, match="pair it with --serve"):
        run_main("connected_components", ["--stats"])
    from gelly_torch import obs

    assert not obs.recording()  # the refusal never flipped the switch


# --------------------------------------------------------------------- #
# parity with gelly_tpu's scripts

def _edge_files(tmp_path):
    rng = np.random.default_rng(16)
    s = rng.integers(0, 48, 300)
    d = rng.integers(0, 48, 300)
    keep = s != d
    s, d = s[keep], d[keep]
    plain = tmp_path / "edges.txt"
    plain.write_text("".join(f"{a} {b}\n" for a, b in zip(s, d)))
    weighted = tmp_path / "weighted.txt"
    w = rng.integers(1, 100, s.shape[0]) / 4.0
    weighted.write_text("".join(
        f"{a} {b} {x}\n" for a, b, x in zip(s, d, w)))
    timed = tmp_path / "timed.txt"
    ts = np.sort(rng.integers(0, 1000, s.shape[0]))
    timed.write_text("".join(
        f"{a} {b} {t}.0\n" for a, b, t in zip(s, d, ts)))
    events = tmp_path / "events.txt"
    rows, live = [], []
    for a, b in zip(s[:120], d[:120]):
        if live and rng.random() < 0.3:
            x, y = live.pop(int(rng.integers(0, len(live))))
            rows.append(f"{x} {y} -")
        rows.append(f"{a} {b} +")
        live.append((a, b))
    events.write_text("\n".join(rows) + "\n")
    return str(plain), str(weighted), str(timed), str(events)


def _file_args(name, files):
    plain, weighted, timed, events = files
    return {
        "bipartiteness_check": [plain, "2"],
        "broadcast_triangle_count": [plain, "200", "48"],
        "centralized_weighted_matching": [weighted],
        "connected_components": [plain, "2"],
        "degree_aggregate": [plain, "both"],
        "degree_distribution": [events],
        "exact_triangle_count": [plain],
        "incidence_sampling_triangle_count": [plain, "200", "48"],
        "iterative_connected_components": [plain],
        "spanner_example": [plain, "2", "3"],
        "window_triangles": [timed, "100"],
    }[name]


@pytest.fixture
def one_jax_device(monkeypatch):
    """gelly_tpu's default mesh spans every device (8 virtual CPU devices
    here, see conftest.py): a JAX script then folds 8 shards, and the
    spanner's per-shard local spanners keep more edges. The port runs on
    one device, so the JAX script is held to it on a one-device mesh."""
    from gelly_tpu.parallel import mesh as mesh_lib

    make_mesh = mesh_lib.make_mesh

    def one(num_shards=None, devices=None):
        if num_shards is None and devices is None:
            num_shards = 1
        return make_mesh(num_shards, devices)

    monkeypatch.setattr(mesh_lib, "make_mesh", one)


@pytest.mark.parametrize("name", ALL_EXAMPLES)
def test_stdout_equals_the_jax_script(name, tmp_path, one_jax_device):
    want = _held(run_jax_main(name))
    assert want and _held(run_main(name)) == want
    args = _file_args(name, _edge_files(tmp_path))
    want = _held(run_jax_main(name, args))
    assert want and _held(run_main(name, args)) == want


# --------------------------------------------------------------------- #
# the other paths

def test_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in ALL_EXAMPLES:
        with pytest.raises(RuntimeError, match="CUDA device"):
            run_main(name, device="--device=cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_main(name, device=None)  # the default is the card


def test_split_device_resolves_only_when_asked():
    from gelly_torch.examples._util import split_device

    args = ["a", "--device=cpu", "b", "--device=cuda"]
    assert split_device(args, resolve=False) == ("cuda", ["a", "b"])
    assert split_device(["--device=cpu", "a"]) == (torch.device("cpu"),
                                                   ["a"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            split_device(args)


def test_shards_equal_the_plain_run(tmp_path, one_jax_device):
    plain, *_ = _edge_files(tmp_path)
    want = _components(run_jax_main("connected_components", [plain, "2"]))
    assert want
    assert _components(run_main("connected_components",
                                [plain, "2", "--shards=2"])) == want
    fused = run_main("connected_components",
                     [plain, "2", "--shards=2",
                      "--queries=cc,degrees,bipartiteness"])
    assert [ln[3:] for ln in fused.splitlines() if ln.startswith("cc ")] \
        == want


def test_checkpoint_dir_resumes_after_a_crash(tmp_path, one_jax_device):
    from gelly_torch.engine import faults

    path = _big_file(tmp_path)
    want = _components(run_jax_main("connected_components", [path]))
    assert want
    ckpt = str(tmp_path / "ckpt")
    # A checkpoint every 2 chunks: a permanent (never retried) fault on
    # the fourth chunk's fold kills the run after the first checkpoint.
    args = [path, "2", f"--checkpoint-dir={ckpt}"]
    plan = faults.FaultPlan([faults.Fault("step", at=3, retryable=False)])
    with faults.install(plan), pytest.raises(faults.FaultInjected):
        run_main("connected_components", args)
    assert os.listdir(ckpt)
    counter = faults.FaultPlan([])
    with faults.install(counter):
        out = run_main("connected_components", args)
    assert _components(out) == want
    assert "# resumed from " in out
    assert counter.calls("step") < 6  # the resumed run skipped a prefix


def _big_file(tmp_path):
    """Six of the CLI's 4096-edge file chunks."""
    rng = np.random.default_rng(5)
    s = rng.integers(0, 20000, 6 * 4096)
    d = rng.integers(0, 20000, 6 * 4096)
    p = tmp_path / "big.txt"
    p.write_text("".join(f"{a} {b}\n" for a, b in zip(s, d)))
    return str(p)


class _PortWatch(io.StringIO):
    """Captured stdout that sets ``ready`` once the ``--serve`` line,
    printed after the server listens, names its port."""

    def __init__(self):
        super().__init__()
        self.ready = threading.Event()

    def write(self, text):
        n = super().write(text)
        if "server on port " in self.getvalue():
            self.ready.set()
        return n

    def port(self):
        return int(self.getvalue().split("server on port ", 1)[1]
                   .split(";", 1)[0])


def _serve_and_connect(serve_args, connect_args):
    """``--serve=0`` in process on a thread, ``--connect`` in a child
    process; returns (server stdout, client stdout)."""
    from gelly_torch.examples.connected_components import main

    watch = _PortWatch()
    box = {}

    def serve():
        try:
            with redirect_stdout(watch):
                main(["--serve=0", CPU] + serve_args)
        except BaseException as e:  # surfaced below
            box["err"] = e
            watch.ready.set()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    assert watch.ready.wait(60)
    if "err" in box:
        raise box["err"]
    env = dict(os.environ, PYTHONPATH=REPO)
    code = ("import sys, torch\n"
            "from gelly_torch.examples.connected_components import main\n"
            "main(sys.argv[1:])\n"
            "print('# cuda initialized:', torch.cuda.is_initialized())\n")
    child = subprocess.run(
        [sys.executable, "-c", code, f"--connect=127.0.0.1:{watch.port()}"]
        + connect_args, capture_output=True, text=True, timeout=120,
        env=env, cwd=REPO)
    t.join(120)
    assert child.returncode == 0, child.stderr
    assert not t.is_alive()
    if "err" in box:
        raise box["err"]
    return watch.getvalue(), child.stdout


@pytest.mark.parametrize("mode", ["raw", "compressed_stacked"])
def test_serve_and_connect_over_loopback(tmp_path, mode, one_jax_device):
    plain, *_ = _edge_files(tmp_path)
    want = _components(run_jax_main("connected_components", [plain]))
    assert want
    extra = [] if mode == "raw" else ["--compressed"]
    client = [plain] + extra + ([] if mode == "raw" else ["--stack=4"])
    server, cli = _serve_and_connect(extra, client)
    assert _components(server) == want
    assert "server acked" in cli
    assert "# cuda initialized: False" in cli
