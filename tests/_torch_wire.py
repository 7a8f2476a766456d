"""Both packages' ingest surfaces side by side, for the port's wire tests.

``pkg("tpu")`` / ``pkg("torch")`` give one namespace per package (the
modules a wire test touches, a one-shard CPU mesh, the stream keyword that
keeps a port stream on the CPU). A wire scenario runs once for each
(server package, client package) pair in :data:`PAIRS` and once on
``gelly_tpu`` alone (:func:`reference`, cached per scenario and arguments);
:func:`same` then holds the records equal, arrays by dtype, shape and
bytes. :func:`buses` scopes the bus of every package a pair touches and
sums their counters, since each package publishes on its own bus.
"""

import contextlib
import functools
import importlib
import threading
import time
import types

import numpy as np

PAIRS = [("torch", "torch"), ("tpu", "torch"), ("torch", "tpu")]
PAIR_IDS = ["torch-torch", "tpu-server-torch-client",
            "torch-server-tpu-client"]


@functools.lru_cache(maxsize=None)
def pkg(name: str) -> types.SimpleNamespace:
    root = "gelly_" + name

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    ns = types.SimpleNamespace(name=name, root=root)
    ns.top = importlib.import_module(root)
    ns.wire = mod("ingest.wire")
    ns.server = mod("ingest.server")
    ns.client = mod("ingest.client")
    ns.readers = mod("ingest.readers")
    ns.obs = mod("obs")
    ns.bus = mod("obs.bus")
    ns.slo = mod("obs.slo")
    ns.status = mod("obs.status")
    ns.faults = mod("engine.faults")
    ns.aggregation = mod("engine.aggregation")
    ns.checkpoint = mod("engine.checkpoint")
    ns.tenants = mod("engine.tenants")
    ns.cc = mod("library.connected_components")
    ns.chunk = mod("core.chunk")
    ns.vertices = mod("core.vertices")
    ns.mesh_mod = mod("parallel.mesh")
    ns.run_aggregation = ns.aggregation.run_aggregation
    ns.IngestServer = ns.server.IngestServer
    ns.IngestClient = ns.client.IngestClient
    ns.TenantRouter = ns.server.TenantRouter
    ns.edge_payload = ns.client.edge_payload
    ns.IngestError = ns.client.IngestError
    # Where a port entry point would default to the card.
    ns.kw = {"device": "cpu"} if name == "torch" else {}
    return ns


def mesh1(P):
    if P.name == "torch":
        return P.mesh_mod.make_mesh(1, devices=["cpu"])
    return P.mesh_mod.make_mesh(1)


def engine(P, **kw):
    return P.tenants.MultiTenantEngine(**P.kw, **kw)


def host_chunk(P, src, dst, capacity):
    """A host chunk of identity ids (``device=False`` in ``gelly_tpu``,
    ``None`` in the port)."""
    s = np.asarray(src, np.int64)
    d = np.asarray(dst, np.int64)
    return P.chunk.make_chunk(
        s.astype(np.int32), d.astype(np.int32), raw_src=s, raw_dst=d,
        capacity=capacity, device=None if P.name == "torch" else False)


def arr(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def text(exc: BaseException) -> str:
    """An error's text with the package name normalized."""
    return f"{type(exc).__name__}: {exc}".replace("gelly_tpu", "gelly_X") \
        .replace("gelly_torch", "gelly_X")


def error_of(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the text is the record
        return text(e)
    return None


def same(want, got, label="") -> None:
    """Deep equality: arrays (tensors) by dtype, shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict), label
        assert sorted(want, key=str) == sorted(got, key=str), (
            label, sorted(want, key=str), sorted(got, key=str))
        for k in want:
            same(want[k], got[k], f"{label}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), label
        assert len(want) == len(got), (label, len(want), len(got))
        for i, (a, b) in enumerate(zip(want, got)):
            same(a, b, f"{label}[{i}]")
    elif isinstance(want, np.ndarray) or hasattr(want, "detach"):
        a, b = arr(want), arr(got)
        assert a.dtype == b.dtype, (label, a.dtype, b.dtype)
        assert a.shape == b.shape, (label, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), label
    else:
        assert want == got, (label, want, got)


_REF: dict = {}


def reference(scenario, *args):
    """``scenario("tpu", "tpu", *args)``, computed once a test process."""
    key = (scenario.__name__,) + tuple(map(repr, args))
    if key not in _REF:
        _REF[key] = scenario("tpu", "tpu", *args)
    return _REF[key]


def check_pair(scenario, server: str, client: str, *args) -> None:
    same(reference(scenario, *args), scenario(server, client, *args),
         f"{scenario.__name__}[{server}-{client}]")


class Buses:
    def __init__(self, buses):
        self.buses = buses

    def counters(self) -> dict:
        out: dict = {}
        for b in self.buses:
            for k, v in b.snapshot()["counters"].items():
                out[k] = out.get(k, 0) + v
        return out

    def counter(self, name, default=0):
        return self.counters().get(name, default)


@contextlib.contextmanager
def buses(*names):
    """Scope the bus of each distinct package; yields :class:`Buses`
    (summed counters) in the order the names first appear."""
    with contextlib.ExitStack() as st:
        seen = []
        for n in names:
            if n not in seen:
                seen.append(n)
        yield Buses([st.enter_context(pkg(n).bus.scope()) for n in seen])


def wait(pred, timeout=20.0, step=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def drain(server, out, delay=0.0):
    def run():
        for seq, payload in server.payloads():
            out.append((seq, payload))
            if delay:
                time.sleep(delay)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def drain_frames(server, out):
    def run():
        for item in server.frames():
            out.append(item)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def payload_record(p: dict) -> dict:
    return {k: arr(v) for k, v in p.items()}
