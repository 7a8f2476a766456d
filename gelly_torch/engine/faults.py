"""Deterministic fault injection for the resilient streaming runtime.

Counterpart of ``gelly_tpu/engine/faults.py`` (a copy: the port imports
nothing of ``gelly_tpu``). A :class:`FaultPlan` is a seeded schedule of
faults at named **boundaries**, the places the resilient runner
(``engine/resilience.py``), the aggregation engine
(``engine/aggregation.py``) and the native bindings (``utils/native.py``)
call :func:`inject`:

- ``"native"``            — entry of a ctypes call into a native library
- ``"codec"``             — a codec worker staging a unit (host compress)
- ``"ingest"``            — the ingest subsystem (not ported yet)
- ``"h2d"``               — host→device staging of a chunk or unit
- ``"step"``              — the fold ``step(state, chunk)`` dispatch
- ``"source"``            — the chunk source / prefetch worker
- ``"collective"``        — the cross-device window merge (not ported yet)
- ``"barrier"``           — multi-host coordination (not ported yet)
- ``"checkpoint_write"``  — before a checkpoint file write
- ``"checkpoint_read"``   — before a checkpoint file read
- ``"checkpoint_corrupt"``— after a checkpoint write, with the file path
                            (``kind="corrupt"`` truncates the file there
                            to simulate a torn write)

All eleven names are kept so that a plan reads the same in both packages.
Faults fire by per-boundary call index, so a plan is reproducible
run-to-run regardless of thread interleaving at other boundaries; the only
randomness is the seeded ``rate`` mode. :func:`inject` is a module-global
``None`` check when no plan is installed. ``FaultPlan.fired`` is the
record of what fired; each fault is also published on the ``obs`` bus as
a ``faults.injected`` event (an instant on an installed tracer) before it
takes effect.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
import time
from typing import Callable, Iterator, Sequence

BOUNDARIES = (
    "native",
    "codec",
    "ingest",
    "h2d",
    "step",
    "source",
    "collective",
    "barrier",
    "checkpoint_write",
    "checkpoint_read",
    "checkpoint_corrupt",
)

KINDS = ("raise", "hang", "corrupt")


class FaultInjected(RuntimeError):
    """Raised by a ``kind="raise"`` fault. ``retryable`` feeds the runner's
    error classification (a non-retryable injected fault models a permanent
    error, e.g. corrupt input data)."""

    def __init__(self, boundary: str, index: int, retryable: bool = True):
        super().__init__(
            f"injected fault at boundary '{boundary}' (call #{index})"
        )
        self.boundary = boundary
        self.index = index
        self.retryable = retryable


@dataclasses.dataclass
class Fault:
    """One scheduled fault.

    ``at`` — the per-boundary call index (0-based) at which to start firing;
    ``count`` consecutive calls fire. ``rate`` instead fires each call with
    that probability from the plan's seeded RNG (mutually exclusive with
    ``at``). ``exc`` overrides the raised exception (instance or zero-arg
    factory). ``kind="hang"`` sleeps ``hang_seconds`` (bounded, so an
    un-watchdogged test cannot wedge forever); ``kind="corrupt"`` truncates
    the file at the injection point's ``path`` to half its size — a torn
    write — and only fires at path-carrying boundaries.
    """

    boundary: str
    at: int | None = None
    kind: str = "raise"
    count: int = 1
    rate: float | None = None
    exc: BaseException | Callable[[], BaseException] | None = None
    hang_seconds: float = 30.0
    retryable: bool = True

    def __post_init__(self):
        if self.boundary not in BOUNDARIES:
            raise ValueError(
                f"unknown boundary {self.boundary!r}; expected one of "
                f"{BOUNDARIES}"
            )
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; expected {KINDS}")
        if (self.at is None) == (self.rate is None):
            raise ValueError("exactly one of at / rate must be set")


class FaultPlan:
    """A seeded, thread-safe schedule of :class:`Fault`s.

    Install with :func:`install` (context manager); every :func:`inject`
    call inside the block consults the plan. ``fired`` records
    ``(boundary, index, kind)`` tuples for test assertions.
    """

    def __init__(self, faults: Sequence[Fault], seed: int = 0):
        self.faults = list(faults)
        self._rng = random.Random(seed)
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self.fired: list[tuple[str, int, str]] = []

    def _match(self, boundary: str, index: int) -> Fault | None:
        for f in self.faults:
            if f.boundary != boundary:
                continue
            if f.at is not None:
                if f.at <= index < f.at + f.count:
                    return f
            elif self._rng.random() < f.rate:
                return f
        return None

    def fire(self, boundary: str, path: str | None = None) -> None:
        with self._lock:
            index = self._counts.get(boundary, 0)
            self._counts[boundary] = index + 1
            f = self._match(boundary, index)
            if f is not None:
                self.fired.append((boundary, index, f.kind))
        if f is None:
            return
        # Published BEFORE the fault takes effect (outside the plan lock):
        # a hang or kill-adjacent raise still leaves the injection visible
        # on the obs bus — and, with a tracer installed, as an instant
        # event on the exported timeline (one per injected fault).
        from ..obs import bus as obs_bus

        obs_bus.get_bus().emit(
            "faults.injected", boundary=boundary, index=index, kind=f.kind,
        )
        if f.kind == "hang":
            time.sleep(f.hang_seconds)
            return
        if f.kind == "corrupt":
            if path is None:
                raise ValueError(
                    f"corrupt fault at boundary '{boundary}' needs a file "
                    "path; use a checkpoint_corrupt-style boundary"
                )
            _tear_file(path)
            return
        if f.exc is not None:
            raise f.exc() if callable(f.exc) else f.exc
        raise FaultInjected(boundary, index, retryable=f.retryable)

    def calls(self, boundary: str) -> int:
        with self._lock:
            return self._counts.get(boundary, 0)


def _tear_file(path: str) -> None:
    """Truncate ``path`` to half its size — a torn/partial write."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


# ---------------------------------------------------------------------- #
# active-plan registry

_ACTIVE: FaultPlan | None = None
_ACTIVE_LOCK = threading.Lock()


def inject(boundary: str, path: str | None = None) -> None:
    """Fault hook — a no-op unless a plan is installed."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(boundary, path=path)


@contextlib.contextmanager
def install(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Activate ``plan`` for the dynamic extent of the block.

    Also hooks the native bindings (``utils/native.py``) so ctypes entry
    points fire the ``"native"`` boundary without utils importing engine.
    Plans do not nest — a second install inside an active one raises.
    """
    global _ACTIVE
    from ..utils import native

    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already installed")
        _ACTIVE = plan
        native._fault_hook = lambda stem: plan.fire("native")
    try:
        yield plan
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None
            native._fault_hook = None
