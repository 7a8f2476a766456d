"""Resilient streaming runner: checkpointed folds, retry, crash recovery.

Counterpart of ``gelly_tpu/engine/resilience.py`` for one process. The
reference delegates these responsibilities to Flink (``ListCheckpointed``
snapshot/restore, task restarts); this module owns them for the
``step(state, chunk) -> (state, emission)`` fold contract:

- **Checkpointing woven into the loop** (:class:`CheckpointManager`):
  every N chunks and/or T seconds the state is pulled to the host and
  written on a background thread as ``ckpt-<position>.npz`` (the v2 CRC
  format of ``engine/checkpoint.py``), keep-last-K rotation. A torn or
  corrupt newest file is detected at load and the previous one used.
- **Exactly-once resume** (:meth:`ResilientRunner.run`): on restart the
  newest *valid* checkpoint is loaded onto the device of ``init_state``,
  the chunk source is fast-forwarded to the recorded position
  (``chunks_from``/``iter_from`` seek when the source supports it, an
  islice skip otherwise), and the fold continues — a resumed run ends in
  a bit-identical state to an uninterrupted run. Emissions for chunks
  folded before the crash are not replayed (state is exactly-once; the
  emission side-channel is at-most-once across a crash).
- **Bounded retry with exponential backoff + jitter** (:class:`RetryPolicy`)
  and a **watchdog timeout** (:class:`Watchdog`) around the fragile
  boundaries: native ctypes calls (classified by ``utils/native.py``),
  staging / step dispatch, and checkpoint I/O. A hung call raises
  :class:`WatchdogTimeout` on the fold thread (the stuck daemon worker is
  abandoned) and is retried like any transient error; a hung or
  retry-exhausted CHECKPOINT write degrades instead — the fold continues
  with durability reduced, aborting only after
  ``max_checkpoint_failures`` consecutive misses (the end-of-stream
  checkpoint always surfaces its error).
- **Graceful degradation**: when a native library keeps erroring mid-stream
  the runner disables it process-wide (``native.disable``) and switches to
  the caller-supplied ``fallback_step`` (the numpy path), re-attempting the
  same chunk — the failed attempt left no state behind.

What the watchdog can see: CUDA launches are asynchronous, so a guarded
call returns once its work is queued on the device, and the watchdog
bounds host-side hangs only (a hung ctypes call, a stalled copy into
pinned memory, a wedged fsync). It does not synchronise with the device
per step. Each guarded call runs on a fresh daemon thread, whose current
CUDA stream is the device's default stream: work on a side stream must
name that stream itself.

Every decision — retries, watchdog timeouts, degradations, source
restarts, checkpoint misses and rotation refusals — lands on the
process-wide ``obs`` event bus (``gelly_torch.obs.get_bus()``) as a
counter and an event, and completed checkpoint writes as
``resilience.checkpoints`` / ``checkpoint_bytes`` /
``checkpoint_write_s`` (with the ``checkpoint_write_ms`` histogram when
recording); an installed ``obs.SpanTracer`` shows each event as an
instant. ``ResilientRunner.stats`` keeps the same counts beside the bus.
With a tracer or recording on, the runner's chunk positions ride the
``bus.watermarks`` ledger (stamped as read, retired at each fold and
each checkpoint).

- **Coordinated multi-host checkpoints** (``coordinator=``, an
  ``engine/coordination.Coordinator``): at cadence the hosts agree on a
  barrier position, each folds its own partition to it and publishes its
  shard through a two-phase commit; resume goes through
  ``Coordinator.recover`` (with ``adopt_state=`` the degraded re-join
  adopts a lost host's shards, and ``reshard_source=`` re-routes its
  chunks).
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Iterator

from ..obs import bus as obs_bus
from ..utils import native as native_mod
from ..utils.prefetch import restartable_prefetch
from . import faults as faults_mod
from .checkpoint import (
    CheckpointCorruptError,
    load_checkpoint,
    read_checkpoint_header,
    save_checkpoint,
    to_host,
    tree_map,
)
from .coordination import CoordinationError

logger = logging.getLogger("gelly_torch.resilience")


class StreamFault(RuntimeError):
    """Base class for runner-level failures (always actionable text)."""


class RetriesExhausted(StreamFault):
    """A fragile boundary failed every attempt of its retry budget."""

    def __init__(self, boundary: str, attempts: int, last: BaseException):
        super().__init__(
            f"boundary '{boundary}' failed after {attempts} attempts; "
            f"last error: {type(last).__name__}: {last}"
        )
        self.boundary = boundary
        self.attempts = attempts


class WatchdogTimeout(TimeoutError):
    """A guarded call exceeded the watchdog timeout (treated as transient)."""

    def __init__(self, boundary: str, timeout: float):
        super().__init__(
            f"boundary '{boundary}' exceeded the {timeout:.3g}s watchdog "
            "timeout (hung native call / host transfer?)"
        )
        self.boundary = boundary


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter: attempt k (0-based retry) sleeps
    ``min(base * multiplier**k, max_delay) * (1 + jitter * U[0,1))``.

    ``max_attempts`` counts total tries (first call + retries). Jitter uses
    the runner's seeded RNG, so schedules are reproducible in tests.
    """

    max_attempts: int = 4
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 5.0
    jitter: float = 0.5

    def delay(self, retry_index: int, rng: random.Random) -> float:
        d = min(self.base_delay * self.multiplier ** retry_index,
                self.max_delay)
        return d * (1.0 + self.jitter * rng.random())


def default_retryable(exc: BaseException) -> bool:
    """Is this error worth retrying? Transient: watchdog timeouts, I/O and
    allocation failures, connection drops, retryable injected faults, and
    anything ``utils/native.py`` classifies as transient. Data-dependent
    errors (ValueError slot range, TypeError) are permanent — retrying
    replays the same failure."""
    if isinstance(exc, WatchdogTimeout):
        return True
    if isinstance(exc, faults_mod.FaultInjected):
        return exc.retryable
    if isinstance(exc, FileNotFoundError):
        return False
    return native_mod.classify_error(exc) == "transient"


class Counters(dict):
    """The runner's counters: a dict whose :meth:`bump` is atomic, since
    the checkpoint writer thread and the fold thread both count."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._lock = threading.Lock()

    def bump(self, key: str, by=1) -> None:
        with self._lock:
            self[key] = self.get(key, 0) + by

    def set(self, key: str, value) -> None:
        """Store ``value`` under the lock :meth:`bump` takes."""
        with self._lock:
            self[key] = value


class Watchdog:
    """Run a call with a wall-clock bound, on a disposable daemon thread.

    A hung ctypes call cannot be cancelled from Python; on timeout the
    worker thread is abandoned (daemon — it cannot block interpreter exit)
    and :class:`WatchdogTimeout` raises on the caller. ``timeout=None``
    disables the guard (zero threading overhead). Each fire adds one to
    ``stats["watchdog_timeouts"]``."""

    def __init__(self, timeout: float | None,
                 stats: Counters | None = None):
        self.timeout = timeout
        self.stats = stats if stats is not None else Counters()

    def call(self, fn: Callable[[], Any], boundary: str):
        if not self.timeout:
            return fn()
        box: list = []
        done = threading.Event()

        def run():
            try:
                box.append(("ok", fn()))
            except BaseException as e:  # re-raised on the caller thread
                box.append(("err", e))
            finally:
                done.set()

        t = threading.Thread(
            target=run, daemon=True, name=f"gelly-watchdog-{boundary}"
        )
        t.start()
        if not done.wait(self.timeout):
            self.stats.bump("watchdog_timeouts")
            # Observable, not just raised: tests read the fire count off
            # the bus; an installed tracer gets the instant.
            obs_bus.get_bus().emit(
                "resilience.watchdog_timeouts", boundary=boundary,
                timeout_s=self.timeout,
            )
            raise WatchdogTimeout(boundary, self.timeout)
        kind, payload = box[0]
        if kind == "err":
            raise payload
        return payload


class CheckpointManager:
    """Rotated ``<prefix>-<position>.npz`` files with async writes.

    ``save`` pulls the state to the host *synchronously* (the state at
    that position, not whatever the device holds when the writer thread
    gets scheduled) and hands the file write to a single background worker
    with at most one write in flight — backpressure, not an unbounded
    queue. Write errors surface at the next ``save``/``flush`` and are
    retried inside the worker under ``retry``. ``load_latest`` walks the
    rotation newest-first, skipping torn/corrupt files.

    ``stats`` counts completed writes (``checkpoint_writes``), their bytes
    on disk (``checkpoint_bytes``), the last write's seconds
    (``checkpoint_write_s``), write retries (``retries``) and rotations
    held back because the newest file failed validation
    (``rotation_skipped``).
    """

    def __init__(self, directory: str, keep: int = 3,
                 retry: RetryPolicy | None = None,
                 async_write: bool = True, seed: int = 0,
                 write_timeout: float | None = None,
                 prefix: str = "ckpt", stats: Counters | None = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        # ``prefix`` namespaces a rotation inside a shared directory. The
        # trailing "-" separator keeps prefixes prefix-free ("t7-*" never
        # matches t77's files) only if the prefix itself has no "-".
        if not prefix or "-" in prefix or any(
            sep and sep in prefix for sep in (os.sep, os.altsep)
        ):
            raise ValueError(
                f"prefix must be a non-empty file-name fragment "
                f"without '-' (the rotation separator), got {prefix!r}"
            )
        self.prefix = prefix
        self.directory = directory
        self.keep = keep
        self.retry = retry or RetryPolicy()
        # A hung write surfaces as WatchdogTimeout at the next flush
        # instead of blocking the fold loop forever. None = wait.
        self.write_timeout = write_timeout
        self._rng = random.Random(seed)
        self.stats = stats if stats is not None else Counters()
        for key in ("checkpoint_writes", "checkpoint_bytes",
                    "rotation_skipped", "retries"):
            self.stats.setdefault(key, 0)
        self.stats.setdefault("checkpoint_write_s", 0.0)
        os.makedirs(directory, exist_ok=True)
        # A SIGKILL mid-write leaves save_checkpoint's tmp behind; it can
        # never be the newest valid checkpoint (the rename never
        # happened), so reap it at takeover — only THIS rotation's: other
        # rotations sharing the directory may have writes in flight.
        for stale in glob.glob(os.path.join(
            glob.escape(directory), glob.escape(self.prefix)
            + "-*.npz.tmp"
        )):
            try:
                os.unlink(stale)
            except OSError:
                pass
        self._async = async_write
        # Single-flight async write: (daemon thread, error box).
        self._pending: tuple | None = None
        # Consecutive failed/timed-out writes, reset by any write that
        # completes. Bumped from the writer thread AND from flush() on the
        # fold thread, so the read-modify-write takes the lock.
        self.consecutive_failures = 0
        self._fail_lock = threading.Lock()

    def path_for(self, position: int) -> str:
        return os.path.join(
            self.directory, f"{self.prefix}-{position:012d}.npz"
        )

    def list(self) -> list[str]:
        """This rotation's checkpoint paths, oldest → newest."""
        return sorted(glob.glob(os.path.join(
            glob.escape(self.directory), glob.escape(self.prefix)
            + "-*.npz"
        )))

    def save(self, state, position: int, meta: dict | None = None) -> None:
        host = tree_map(to_host, state)
        if not self._async:
            self._write(host, position, meta)
            return
        self.flush()
        box: list = []

        def writer():
            try:
                self._write(host, position, meta)
            except BaseException as e:  # surfaced at the next flush
                box.append(e)

        t = threading.Thread(target=writer, daemon=True, name="gelly-ckpt")
        t.start()
        self._pending = (t, box)

    def _write(self, host, position: int, meta: dict | None) -> None:
        try:
            self._write_inner(host, position, meta)
        except BaseException:
            with self._fail_lock:
                self.consecutive_failures += 1
            raise
        with self._fail_lock:
            self.consecutive_failures = 0

    def _write_inner(self, host, position: int, meta: dict | None) -> None:
        path = self.path_for(position)
        attempt = 0
        t0 = time.perf_counter()
        while True:
            try:
                faults_mod.inject("checkpoint_write", path=path)
                # Vetted exception to the daemon-durability rule: this
                # write is atomic (tmp + fsync + rename) and _rotate
                # validates the newest file before pruning its fallbacks,
                # so a daemon killed mid-write can only lose the newest
                # snapshot — never leave zero valid checkpoints.
                header = save_checkpoint(  # graphlint: disable=RC006
                    path, host, position=position, meta=meta
                )
                break
            except BaseException as e:
                attempt += 1
                if not default_retryable(e):
                    raise  # permanent (data) error: never a retry problem
                if attempt >= self.retry.max_attempts:
                    raise RetriesExhausted(
                        "checkpoint_write", attempt, e
                    ) from e
                self.stats.bump("retries")
                # The port counts the writer's own retries as retries,
                # in stats and on the bus alike.
                obs_bus.get_bus().emit(
                    "resilience.retries", boundary="checkpoint_write",
                    attempt=attempt,
                    error=f"{type(e).__name__}: {e}"[:200],
                )
                time.sleep(self.retry.delay(attempt - 1, self._rng))
        self.stats.bump("checkpoint_writes")
        self.stats.bump("checkpoint_bytes", os.path.getsize(path))
        self.stats.set("checkpoint_write_s", time.perf_counter() - t0)
        # Durability currency on the bus: bytes written and write latency
        # are what the checkpoint cadence trades against fold throughput.
        obs_bus.publish_checkpoint(obs_bus.get_bus(), "resilience", path,
                                   t0=t0)
        # Torn-write simulation point: fires AFTER the file is durable so a
        # corrupt fault produces exactly the artifact load must survive.
        faults_mod.inject("checkpoint_corrupt", path=path)
        self._rotate(expected_crcs=header["crc32"])

    def _rotate(self, expected_crcs: list | None = None) -> None:
        files = self.list()
        if len(files) <= self.keep:
            return
        # Validate the just-written newest file BEFORE pruning its
        # fallbacks: a torn final write must never leave the rotation
        # with zero valid checkpoints. A header-only read cross-checked
        # against the CRCs computed during the write; with no expected
        # list, the full CRC read-back.
        try:
            if expected_crcs is not None:
                header = read_checkpoint_header(files[-1])
                if header.get("crc32") != expected_crcs:
                    raise CheckpointCorruptError(
                        f"checkpoint {files[-1]}: on-disk header CRCs "
                        "differ from the just-written ones — torn or "
                        "clobbered write"
                    )
            else:
                load_checkpoint(files[-1])
        except (CheckpointCorruptError, OSError) as e:
            self.stats.bump("rotation_skipped")
            obs_bus.get_bus().emit(
                "resilience.rotation_skipped", path=files[-1],
                error=f"{type(e).__name__}: {e}"[:200],
            )
            logger.error(
                "newest checkpoint %s failed post-write validation (%s); "
                "keeping the previous rotation files as fallback",
                files[-1], e,
            )
            return
        for old in files[:-self.keep]:
            try:
                os.unlink(old)
            except OSError:
                pass

    def flush(self) -> None:
        """Wait for the in-flight write; re-raises its error, if any. A
        write still running after ``write_timeout`` raises
        :class:`WatchdogTimeout` — the daemon writer is abandoned."""
        if self._pending is not None:
            (t, box), self._pending = self._pending, None
            t.join(self.write_timeout)
            if t.is_alive():
                # Neither completed nor failed yet — count the miss here
                # (_write's own accounting runs whenever it finishes).
                with self._fail_lock:
                    self.consecutive_failures += 1
                raise WatchdogTimeout("checkpoint_write", self.write_timeout)
            if box:
                raise box[0]

    def close(self) -> None:
        self.flush()

    def load_latest(self, like=None):
        """Newest valid checkpoint as ``(state, position, meta, path)``, or
        ``None`` when the rotation holds none. Corrupt/torn files are
        logged and skipped — the previous checkpoint in the rotation wins.
        Tensor leaves come back on the device of ``like``'s leaves."""
        for path in reversed(self.list()):
            try:
                faults_mod.inject("checkpoint_read", path=path)
                state, position, meta = load_checkpoint(path, like=like)
                return state, position, meta, path
            except (CheckpointCorruptError, OSError,
                    faults_mod.FaultInjected) as e:
                logger.warning(
                    "checkpoint %s unusable (%s); trying previous", path, e
                )
        return None


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs of :class:`ResilientRunner` (all have production defaults)."""

    checkpoint_every_chunks: int = 64
    checkpoint_every_seconds: float | None = None
    keep_checkpoints: int = 3
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    # None disables the watchdog. Applied per guarded call (stage / step /
    # checkpoint), not to the whole run.
    watchdog_timeout: float | None = 60.0
    # Switch to fallback_step (and native.disable the stem, when known)
    # after this many CONSECUTIVE step failures classified as native.
    degrade_after: int = 2
    # Prefetch lookahead for the chunk source; 0 = synchronous pulls.
    prefetch_depth: int = 2
    # Source-iterator restarts allowed before the error is fatal.
    max_source_restarts: int = 3
    # Mid-stream checkpoint failures tolerated before the run aborts: the
    # fold keeps going with degraded durability, logged per miss. The
    # forced end-of-stream checkpoint is never tolerated.
    max_checkpoint_failures: int = 3
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic


def _make_seekable(chunks) -> Callable[[int], Iterator]:
    """Normalize a chunk source to ``make_iter(position)``.

    Accepts an ``EdgeStream`` (``chunks_from``), a source with ``iter_from``
    (``core/io.EdgeChunkSource``), a callable ``position -> iterator``, or a
    plain re-iterable (islice skip — correct, just O(position) on restart).
    A single-shot iterator is accepted for one pass but any restart/re-open
    raises :class:`StreamFault` instead of silently re-reading an exhausted
    stream."""
    if callable(chunks) and not hasattr(chunks, "__iter__"):
        return chunks
    if hasattr(chunks, "chunks_from"):
        return chunks.chunks_from
    if hasattr(chunks, "iter_from"):
        return chunks.iter_from
    if iter(chunks) is chunks:
        opened = [False]

        def make_once(position: int) -> Iterator:
            if opened[0]:
                raise StreamFault(
                    "chunk source is a single-shot iterator and was already "
                    "consumed; source restart/resume needs a seekable or "
                    "re-iterable source (EdgeStream, EdgeChunkSource, a "
                    "callable position -> iterator, or a list)"
                )
            opened[0] = True
            return itertools.islice(chunks, position, None)

        return make_once

    def make_iter(position: int) -> Iterator:
        return itertools.islice(iter(chunks), position, None)

    return make_iter


class ResilientRunner:
    """Drive ``step(state, chunk) -> (state, emission)`` to completion,
    surviving transient failures and process death.

    ``chunks`` — an ``EdgeStream``, ``EdgeChunkSource``, callable
    ``position -> iterator``, or plain iterable. ``init_state`` — the
    initial state tree or a zero-arg factory (also the resume template: a
    resumed state comes back on the device of its tensors).
    ``stage(chunk) -> chunk`` — optional H2D/pre-processing hook, guarded
    as the ``"h2d"`` boundary. ``fallback_step`` — the numpy-path step the
    runner degrades to when native keeps failing.

    ``flatten_state`` — optional ``state -> state`` run at checkpoint
    cadence before each snapshot: the periodic path flatten that keeps
    union-find chase depth bounded on long streams. The returned state
    REPLACES the live fold state (labels must be identical — e.g.
    ``ops/unionfind.pointer_jump`` on the parent leaf).

    ``coordinator`` — an ``engine/coordination.Coordinator`` switches the
    runner to COORDINATED checkpoints on a multi-host mesh: at cadence
    the hosts run a checkpoint barrier (``agree_position`` — all agree
    on the max last-retired-chunk position), each folds its own
    partition up to the agreed position, and publishes its shard via
    the two-phase commit (prepared markers + leader-written manifest).
    Resume goes through ``Coordinator.recover``: manifest validation,
    CRC-checked own-shard load, and — with ``adopt_state`` (a
    ``combine(state, orphan_state) -> state``) — the degraded-capacity
    takeover of a permanently lost host's shards; ``reshard_source``
    (``(old_count, new_count) -> None``) then re-routes the lost hosts'
    chunks. Mutually exclusive with ``checkpoint_dir`` (the coordinator
    owns its store). Coordination failures (dead peer, commit timeout,
    barrier skew) are FATAL, never silently tolerated — a desynced mesh
    must surface; the watchdog still bounds hung protocol calls. The
    runner closes the coordinator when the run ends.

    ``run()`` returns the final state; ``emissions()`` yields
    ``(position, emission)`` for every non-None emission as it happens.
    ``stats`` counts chunks, retries (the checkpoint writer's included),
    checkpoints (initiated, written, missed, bytes), source restarts,
    watchdog timeouts and degradations, and records ``resumed_from`` (the
    checkpoint path, or the coordinator's manifest) and ``resume_load_s``.
    """

    def __init__(
        self,
        step: Callable[[Any, Any], tuple[Any, Any]],
        chunks,
        init_state,
        *,
        checkpoint_dir: str | None = None,
        resume: bool = True,
        config: ResilienceConfig | None = None,
        stage: Callable[[Any], Any] | None = None,
        fallback_step: Callable[[Any, Any], tuple[Any, Any]] | None = None,
        meta: dict | None = None,
        coordinator=None,
        flatten_state: Callable[[Any], Any] | None = None,
        adopt_state: Callable[[Any, Any], Any] | None = None,
        reshard_source: Callable[[int, int], Any] | None = None,
    ):
        self._step = step
        self._make_iter = _make_seekable(chunks)
        self._init_state = init_state
        self._resume = resume
        self.config = config or ResilienceConfig()
        self._stage = stage
        self._fallback_step = fallback_step
        self._meta = dict(meta or {})
        self._rng = random.Random(self.config.seed)
        self._native_failures = 0
        self._degraded = False
        self._flatten = flatten_state
        self.position = 0  # chunks folded into the current state
        self.stats = Counters(
            chunks=0, retries=0, checkpoints=0, checkpoint_failures=0,
            restarts=0, resumed_from=None, resume_load_s=None,
            degraded=False, degradations=0, watchdog_timeouts=0,
        )
        self._watchdog = Watchdog(self.config.watchdog_timeout, self.stats)
        self._adopt = adopt_state
        self._reshard_source = reshard_source
        self.coordinator = coordinator
        if coordinator is not None and checkpoint_dir is not None:
            raise ValueError(
                "pass checkpoint_dir OR coordinator, not both: the "
                "coordinator owns its shared store (path-per-host epoch "
                "layout), a local rotation dir would shadow it"
            )
        # Coordination calls get a LARGER watchdog budget than plain
        # boundaries: a barrier legitimately waits up to the protocol's
        # own barrier_timeout, whose error names the missing/dead hosts
        # — the generic WatchdogTimeout must only fire for a genuine
        # hang (an injected hang fault, a wedged fsync), never first, or
        # it masks the actionable diagnosis.
        self._barrier_watchdog = Watchdog(None, self.stats)
        if coordinator is not None:
            wt = self.config.watchdog_timeout
            self._barrier_watchdog = Watchdog(
                None if wt is None
                else wt + 2 * coordinator.config.barrier_timeout,
                self.stats,
            )
        self.manager = None
        if checkpoint_dir is not None:
            self.manager = CheckpointManager(
                checkpoint_dir,
                keep=self.config.keep_checkpoints,
                retry=self.config.retry,
                seed=self.config.seed,
                write_timeout=self.config.watchdog_timeout,
                stats=self.stats,
            )

    # ------------------------------------------------------------------ #
    # guarded calls

    def _guard(self, boundary: str, fn: Callable[[], Any]):
        """Retry ``fn`` under the watchdog with exponential backoff."""
        policy = self.config.retry
        attempt = 0

        def guarded():
            # Injection runs INSIDE the watchdog guard: a kind="hang" fault
            # must be caught by the timeout exactly like a real hung call.
            faults_mod.inject(boundary)
            return fn()

        while True:
            try:
                return self._watchdog.call(guarded, boundary)
            except BaseException as e:
                attempt += 1
                if boundary == "step" and self._maybe_degrade(e):
                    # Same chunk re-attempted on the fallback path; the
                    # failed attempt left no state behind (step is pure).
                    continue
                if not default_retryable(e):
                    raise
                if attempt >= policy.max_attempts:
                    raise RetriesExhausted(boundary, attempt, e) from e
                self.stats.bump("retries")
                obs_bus.get_bus().emit(
                    "resilience.retries", boundary=boundary,
                    attempt=attempt,
                    error=f"{type(e).__name__}: {e}"[:200],
                )
                delay = policy.delay(attempt - 1, self._rng)
                logger.warning(
                    "boundary '%s' attempt %d/%d failed (%s: %s); "
                    "retrying in %.3fs", boundary, attempt,
                    policy.max_attempts, type(e).__name__, e, delay,
                )
                self.config.sleep(delay)

    def _maybe_degrade(self, exc: BaseException) -> bool:
        """Degradation ladder: repeated native step errors switch the fold
        to the numpy fallback (and disable the native stem process-wide so
        codec probes stop choosing it). Returns True when the step was
        swapped and the chunk should be re-attempted immediately."""
        if self._degraded or self._fallback_step is None:
            return False
        if native_mod.classify_native(exc) is None:
            return False
        self._native_failures += 1
        if self._native_failures < self.config.degrade_after:
            return False
        stem = getattr(exc, "stem", None)
        if stem:
            native_mod.disable(stem, reason=f"degraded mid-stream: {exc}")
        logger.warning(
            "native step failed %d consecutive times (%s: %s); degrading "
            "to the numpy fallback fold", self._native_failures,
            type(exc).__name__, exc,
        )
        self._step = self._fallback_step
        self._degraded = True
        self.stats["degraded"] = True
        self.stats["degradations"] += 1
        obs_bus.get_bus().emit(
            "resilience.degradations", stem=stem or "",
            failures=self._native_failures,
            error=f"{type(exc).__name__}: {exc}"[:200],
        )
        return True

    # ------------------------------------------------------------------ #
    # the fold loop

    def _initial_state(self):
        state = (self._init_state()
                 if callable(self._init_state) else self._init_state)
        if self.coordinator is not None and self._resume:
            t0 = time.perf_counter()
            # The template's leaves fix each loaded tensor's device.
            found = self._barrier_watchdog.call(
                lambda: self.coordinator.recover(
                    like=state, adopt=self._adopt,
                    reshard=self._reshard_source,
                ),
                "barrier",
            )
            if found is not None:
                rec_state, self.position, meta = found
                if rec_state is not None:
                    # None = a NEW host joining a smaller committed
                    # group: fresh state, barrier-agreed position.
                    state = rec_state
                self._meta.update(
                    {k: v for k, v in meta.items() if k not in self._meta}
                )
                # The manifest IS the coordinated resume record (the
                # shard path varies per host and may be an adopted set).
                self.stats["resumed_from"] = (
                    self.coordinator.store.manifest_path
                )
                self.stats["resume_load_s"] = time.perf_counter() - t0
                logger.info(
                    "coordinated resume at chunk %d (epoch %s)",
                    self.position, self.coordinator.committed_epoch,
                )
        elif self.manager is not None and self._resume:
            t0 = time.perf_counter()
            # The template's leaves fix each loaded tensor's device, so a
            # resumed fold stays where init_state put it.
            found = self.manager.load_latest(like=state)
            if found is not None:
                state, self.position, meta, path = found
                self._meta.update(
                    {k: v for k, v in meta.items() if k not in self._meta}
                )
                self.stats["resumed_from"] = path
                self.stats["resume_load_s"] = time.perf_counter() - t0
                logger.info(
                    "resuming from %s at chunk %d", path, self.position
                )
        return state

    def emissions(self) -> Iterator[tuple[int, Any]]:
        """Run the fold; yield ``(position, emission)`` for each non-None
        emission. The final state is left in ``self.state``."""
        cfg = self.config
        state = self._initial_state()
        self.state = state
        start = self.position
        last_ckpt_pos = start
        last_ckpt_time = cfg.clock()
        # Serving-plane telemetry (the engine's zero-cost-when-disabled
        # guard): ingress stamps ride the runner's exactly-once positions.
        wm_bus = obs_bus.get_bus()
        wm = wm_bus.watermarks if obs_bus.telemetry_on() else None
        if wm is not None:
            wm.seed("stream", start)

        def should_restart(exc: BaseException) -> bool:
            ok = default_retryable(exc)
            if ok:
                self.stats["restarts"] += 1
                obs_bus.get_bus().emit(
                    "resilience.source_restarts", position=self.position,
                    error=f"{type(exc).__name__}: {exc}"[:200],
                )
                logger.warning(
                    "chunk source failed (%s: %s); restarting at chunk %d",
                    type(exc).__name__, exc, self.position,
                )
            return ok

        def source_iter(pos: int) -> Iterator:
            faults_mod.inject("source")
            return self._make_iter(pos)

        barrier: tuple[int, int] | None = None  # (epoch, agreed position)
        chunk_iter = restartable_prefetch(
            source_iter,
            depth=cfg.prefetch_depth,
            start=start,
            max_restarts=cfg.max_source_restarts,
            should_restart=should_restart,
            position=lambda: self.position,
        )
        try:
            for chunk in chunk_iter:
                if wm is not None:
                    wm.stamp("stream", self.position)
                if self._stage is not None:
                    chunk = self._guard(
                        "h2d", lambda c=chunk: self._stage(c)
                    )
                state, emission = self._guard(
                    "step", lambda s=state, c=chunk: self._step(s, c)
                )
                # The degrade ladder counts CONSECUTIVE native failures; a
                # chunk that eventually folded clean resets it.
                self._native_failures = 0
                self.state = state
                self.position += 1
                if wm is not None:
                    wm.retire_fold("stream", self.position, bus=wm_bus,
                                   prefix="resilience")
                self.stats["chunks"] = self.position - start
                if emission is not None:
                    yield self.position, emission
                due = (
                    self.position - last_ckpt_pos
                    >= cfg.checkpoint_every_chunks
                )
                if not due and cfg.checkpoint_every_seconds is not None:
                    due = (cfg.clock() - last_ckpt_time
                           >= cfg.checkpoint_every_seconds)
                if self.coordinator is not None:
                    self.coordinator.maybe_beat()
                    if barrier is None and due:
                        # Checkpoint barrier: agree on max(last-retired)
                        # across hosts; this host may still be behind the
                        # agreed position — keep folding until it retires
                        # it, THEN publish. Every host snapshots the same
                        # position.
                        barrier = self._barrier_watchdog.call(
                            lambda p=self.position:
                                self.coordinator.agree_position(p),
                            "barrier",
                        )
                    if barrier is not None and self.position >= barrier[1]:
                        state = self._checkpoint_coordinated(
                            state, *barrier
                        )
                        self.state = state
                        barrier = None
                        last_ckpt_pos = self.position
                        last_ckpt_time = cfg.clock()
                elif self.manager is not None and due:
                    state = self._checkpoint(state)
                    self.state = state
                    last_ckpt_pos = self.position
                    last_ckpt_time = cfg.clock()
            if self.coordinator is not None:
                if barrier is not None:
                    # The stream ended BELOW a pending barrier position:
                    # another host proposed more chunks than this
                    # partition holds. Peers are waiting for this host's
                    # shard at a position it can never reach — surface
                    # the skew instead of deadlocking them.
                    raise CoordinationError(
                        f"stream exhausted at chunk {self.position} but "
                        f"the checkpoint barrier agreed on {barrier[1]} "
                        "— coordinated partitions must have equal chunk "
                        "counts"
                    )
                if self.position > last_ckpt_pos:
                    epoch, agreed = self._barrier_watchdog.call(
                        lambda p=self.position:
                            self.coordinator.agree_position(p),
                        "barrier",
                    )
                    if agreed != self.position:
                        raise CoordinationError(
                            f"hosts disagree on the final position "
                            f"({agreed} vs {self.position}) — coordinated "
                            "partitions must have equal chunk counts"
                        )
                    state = self._checkpoint_coordinated(
                        state, epoch, agreed, final=True
                    )
                    self.state = state
            elif self.manager is not None:
                if self.position > last_ckpt_pos:
                    state = self._checkpoint(state, final=True)
                    self.state = state
                self.manager.close()
            elif wm is not None:
                # No durability point configured: end of stream is the
                # retirement point, so a completed run reads no backlog.
                wm.retire_durable("stream", self.position, bus=wm_bus,
                                  prefix="resilience")
        except BaseException:
            # Leave the newest durable checkpoint in place for the next
            # incarnation; just stop the writer cleanly.
            if self.manager is not None:
                try:
                    self.manager.close()
                except BaseException:
                    logger.exception("checkpoint writer shutdown failed")
            raise
        finally:
            # The runner owns the coordinator's lifecycle for the run:
            # closing stops the lease beat thread (peers see this host
            # depart within lease_ttl) and drops the observability
            # registration — one Coordinator per incarnation.
            if self.coordinator is not None:
                try:
                    self.coordinator.close()
                except BaseException:
                    logger.exception("coordinator shutdown failed")

    def _checkpoint(self, state, final: bool = False):
        """Cadenced snapshot. A failed MID-STREAM checkpoint (hung write,
        exhausted write retries) degrades durability but must not kill an
        otherwise healthy fold — tolerated up to ``max_checkpoint_failures``
        consecutive misses; the end-of-stream checkpoint always raises.
        Returns the (possibly flattened) state the fold continues with."""
        state = self._flattened(state)
        try:
            self.manager.save(
                state, self.position,
                meta={**self._meta, "wall_time": time.time()},
            )
        except (WatchdogTimeout, RetriesExhausted):
            self.stats["checkpoint_failures"] += 1
            consecutive = self.manager.consecutive_failures
            obs_bus.get_bus().emit(
                "resilience.checkpoint_misses", position=self.position,
                consecutive=consecutive, final=final,
            )
            if final or consecutive >= self.config.max_checkpoint_failures:
                raise
            logger.error(
                "checkpoint at position %d failed (%d consecutive miss(es),"
                " tolerating up to %d); durability degraded, fold continues",
                self.position, consecutive,
                self.config.max_checkpoint_failures,
            )
            return state
        self.stats["checkpoints"] += 1
        self._retire_durable()
        return state

    def _flattened(self, state):
        """Apply the cadenced path flatten (when configured) — the
        returned state replaces the live fold state, so chase depth
        stays bounded across the whole stream, not just in snapshots."""
        if self._flatten is None:
            return state
        return self._flatten(state)

    def _checkpoint_coordinated(self, state, epoch: int, agreed: int,
                                final: bool = False):
        """Publish this host's shard at the barrier-agreed position via
        the coordinator's two-phase commit. Unlike the local path,
        failures here are FATAL: a host that silently skips a
        coordinated epoch desyncs the whole group (peers block on its
        prepared marker), so the error must surface and take the
        incarnation down — recovery restarts from the previous
        committed epoch."""
        if self.position != agreed:
            raise CoordinationError(
                f"coordinated checkpoint at position {self.position} but "
                f"the barrier agreed on {agreed} — driver bug"
            )
        state = self._flattened(state)
        host = tree_map(to_host, state)
        self._barrier_watchdog.call(
            lambda: self.coordinator.publish(
                epoch, host, self.position,
                meta={**self._meta, "wall_time": time.time()},
            ),
            "barrier",
        )
        self.stats["checkpoints"] += 1
        # Same durability point as the local path: a committed barrier
        # epoch retires this host's ledger up to the agreed position.
        self._retire_durable()
        return state

    def _retire_durable(self) -> None:
        """Durability point: the e2e ledger retires every position the
        just-published snapshot covers (an async write is in flight; the
        bus's completed-write counters stay the durability authority)."""
        if not obs_bus.telemetry_on():
            return
        b = obs_bus.get_bus()
        b.watermarks.retire_durable("stream", self.position, bus=b,
                                    prefix="resilience")
        b.gauge("engine.backlog_age_s",
                round(b.watermarks.backlog_age("stream"), 6))

    def run(self):
        """Drain the stream; return the final state tree."""
        for _ in self.emissions():
            pass
        return self.state


def resilient_fold(step, chunks, init_state, **kw):
    """Functional shorthand: run :class:`ResilientRunner` to completion and
    return the final state."""
    return ResilientRunner(step, chunks, init_state, **kw).run()
