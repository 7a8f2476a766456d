"""Coordinated multi-host recovery: checkpoint barriers, leader-elected
rotation, and degraded-capacity re-join.

Counterpart of ``gelly_tpu/engine/coordination.py`` (a copy: the port
imports nothing of ``gelly_tpu``; only the logger name differs, and the
shard files go through the port's ``engine/checkpoint``, whose v2 format
both packages read). The Flink reference delegates all of this to its
runtime substrate (PAPER.md L0: ``ListCheckpointed`` + coordinated
snapshots — the JobManager injects barriers, TaskManagers snapshot at the
barrier, and a checkpoint coordinator commits the global snapshot). The
resilient runner (``engine/resilience.py``) checkpoints a single process;
on a mesh across processes (``parallel/mesh.initialize_multihost``) each
host would snapshot at an uncoordinated chunk position and a single host
loss would kill the whole stream. This module re-owns the coordinator:

- **Checkpoint barrier** (:meth:`Coordinator.agree_position`): every
  host posts an *intent* carrying its last-retired-chunk position; the
  barrier resolves to ``max`` over all proposals (deterministic — every
  host computes it from the same intent set), and each host keeps
  folding its own partition until it retires the agreed position. All
  hosts therefore snapshot the SAME position, riding the existing
  position-header/CRC v2 checkpoint format unchanged.
- **Two-phase commit publish** (:meth:`Coordinator.publish`): each host
  writes its shard checkpoint into the epoch's ``host-<k>/`` directory
  (fsync'd tmp + atomic rename), then an atomic *prepared* marker; only
  when every host's marker is present does the leader atomically write
  ``MANIFEST.json`` naming the committed epoch. A host that dies
  mid-write leaves no prepared marker, the epoch never commits, and
  recovery reads the previous manifest — a mixed-epoch store is
  unreachable by construction and *rejected* if hand-assembled
  (:class:`MixedEpochError`).
- **Shared checkpoint store** (:class:`CheckpointStore`): a local/NFS
  directory today — ``epoch-<E>/host-<k>/ckpt-<pos>.npz`` per shard,
  one leader-written manifest, lease files under ``members/``. The
  layout is the API; a bucket-backed store slots in behind the same
  methods.
- **Leader election + rotation**: the lowest *live* process_index leads
  (liveness = lease files heartbeaten at ``lease_ttl/3`` cadence). A
  follower waiting for a commit that observes the leader's lease expire
  takes over the commit itself when it becomes the lowest live host —
  an epoch whose every shard is prepared always commits. Leadership
  changes are published on the obs event bus
  (``coordination.leader_elected``), so loss is observable and tested.
- **Restart-time re-join + the degradation rung**
  (:meth:`Coordinator.recover`): a restarted or replacement host
  validates the manifest, loads its shard leaves (CRC-checked), and
  re-enters the fold loop at the barrier-agreed position. On PERMANENT
  host loss the survivors re-shard the forest: the per-leaf checkpoint
  layout is host-agnostic, so each survivor adopts the orphan shards
  assigned to it (``old_host % new_count``) by folding them into its
  own state with the caller-supplied ``adopt`` combine — the stream
  continues at reduced capacity with a published
  ``coordination.degradations`` event instead of aborting. (Re-routing
  the lost host's *future* chunks is the ingest layer's job — the
  sharded-source-reader ROADMAP item; state adoption is owned here.)

Scope: coordination is restart-time (all hosts of an incarnation start
together, as under any pod launcher); barriers assume every host
retires the same chunk cadence over equal-length partitions — unequal
final positions are a loud :class:`CoordinationError`, never a silent
skew. Every wait is bounded (``barrier_timeout``) and fails fast when a
missing host's lease has expired. The ``"barrier"`` fault boundary
(``engine/faults.py``) fires inside :meth:`agree_position`,
:meth:`publish` and after the manifest write (path-carrying, so
``kind="corrupt"`` models a torn manifest), letting seeded FaultPlans
drive every failure path deterministically.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import tempfile
import threading
import time
from typing import Any, Callable

from ..obs import bus as obs_bus
from . import faults as faults_mod
from .checkpoint import _fsync_dir, load_checkpoint, save_checkpoint

logger = logging.getLogger("gelly_torch.coordination")

MANIFEST_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"

_EPOCH_RE = re.compile(r"^epoch-(\d{8})$")
_HOST_RE = re.compile(r"^host-(\d+)$")


class CoordinationError(RuntimeError):
    """A coordination-protocol failure (always actionable text): a
    barrier that cannot complete, a dead peer, a commit that cannot
    happen. Never retried silently — a desynced mesh must surface."""


class ManifestCorruptError(CoordinationError):
    """MANIFEST.json is unreadable or fails schema validation. The
    manifest is written atomically, so a torn manifest means disk fault
    or tampering — rejected loudly, never guessed around."""


class MixedEpochError(CoordinationError):
    """The committed epoch's store is internally inconsistent: a shard
    is missing, or a shard/prepared position disagrees with the
    manifest. Unreachable via the 2PC protocol; a hand-assembled or
    bit-rotted store is rejected instead of resuming half an epoch."""


@dataclasses.dataclass(frozen=True)
class HostIdentity:
    """This process's slot in the coordinated group.

    Defaults come from the live process group
    (:func:`detect_host_identity`); tests pass explicit identities so
    multiple in-process "hosts" can share one store.
    """

    process_index: int
    process_count: int
    coordinator_address: str | None = None

    def __post_init__(self):
        if self.process_count < 1:
            raise ValueError(
                f"process_count must be >= 1, got {self.process_count}"
            )
        if not (0 <= self.process_index < self.process_count):
            raise ValueError(
                f"process_index {self.process_index} out of range for "
                f"process_count {self.process_count}"
            )


def detect_host_identity() -> HostIdentity:
    """Identity from the live mesh state (``parallel/mesh.host_info``):
    single-process runs come back as ``HostIdentity(0, 1)``."""
    from ..parallel import mesh as mesh_lib

    info = mesh_lib.host_info()
    return HostIdentity(
        process_index=info["process_index"],
        process_count=info["process_count"],
        coordinator_address=info.get("coordinator_address"),
    )


# ---------------------------------------------------------------------- #
# atomic small-file helpers (same durability stance as engine/checkpoint)


def write_json_atomic(path: str, obj: dict) -> None:
    """tmp + fsync + rename: readers see the old content or the new,
    never a torn JSON."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(d)


def _read_json(path: str) -> dict | None:
    """A JSON file's dict, or None when absent. Unparsable content
    returns None with a warning — rendezvous readers poll, so garbage
    (a fault-injected tear) surfaces as a bounded timeout, not a
    mis-agreement."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError) as e:
        logger.warning("unreadable coordination file %s: %s", path, e)
        return None
    return obj if isinstance(obj, dict) else None


# ---------------------------------------------------------------------- #
# the shared store


class CheckpointStore:
    """Path-per-host shared checkpoint store with a committed-epoch
    manifest.

    Layout under ``root``::

        MANIFEST.json                     # leader-written commit record
        epoch-<E>/intent-host-<k>.json    # barrier proposals
        epoch-<E>/host-<k>/ckpt-<pos>.npz # one shard per host per epoch
        epoch-<E>/prepared-host-<k>.json  # 2PC votes
        members/host-<k>.json             # lease heartbeats

    Every write is atomic (fsync'd tmp + rename); shard files are the
    unchanged v2 position-header/CRC format from ``engine/checkpoint``.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        os.makedirs(self.members_dir, exist_ok=True)

    # ------------------------------------------------------------ paths

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_NAME)

    @property
    def members_dir(self) -> str:
        return os.path.join(self.root, "members")

    def epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.root, f"epoch-{epoch:08d}")

    def host_dir(self, epoch: int, host: int) -> str:
        return os.path.join(self.epoch_dir(epoch), f"host-{host}")

    def shard_path(self, epoch: int, host: int, position: int) -> str:
        return os.path.join(
            self.host_dir(epoch, host), f"ckpt-{position:012d}.npz"
        )

    def _intent_path(self, epoch: int, host: int) -> str:
        return os.path.join(
            self.epoch_dir(epoch), f"intent-host-{host}.json"
        )

    def _prepared_path(self, epoch: int, host: int) -> str:
        return os.path.join(
            self.epoch_dir(epoch), f"prepared-host-{host}.json"
        )

    def list_epochs(self) -> list[int]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for n in names:
            m = _EPOCH_RE.match(n)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    # ---------------------------------------------------------- barrier

    def write_intent(self, epoch: int, host: int, position: int,
                     run_id: str | None = None) -> str:
        path = self._intent_path(epoch, host)
        write_json_atomic(path, {
            "host": host, "position": int(position), "epoch": epoch,
            "run_id": run_id,
        })
        return path

    def _read_host_records(self, epoch: int, prefix: str,
                           run_id: str | None,
                           process_count: int | None) -> dict[int, int]:
        """``{host: position}`` for every readable record of ``prefix``.
        ``run_id`` filters out records stamped by a DIFFERENT
        incarnation (a crashed run's leftovers in a re-attempted epoch
        dir); ``process_count`` drops records from host indices outside
        the CURRENT group (a permanently lost host's leftovers after a
        degraded re-join). None accepts everything (tests / manual
        surgery)."""
        out: dict[int, int] = {}
        d = self.epoch_dir(epoch)
        try:
            names = os.listdir(d)
        except OSError:
            return out
        for n in names:
            if not n.startswith(prefix):
                continue
            obj = _read_json(os.path.join(d, n))
            if obj is None or not isinstance(obj.get("position"), int):
                continue
            host = obj.get("host")
            if not isinstance(host, int) or isinstance(host, bool):
                # Parseable but malformed (bit-rot / hand edit): skip
                # like any unreadable record — garbage surfaces as a
                # bounded timeout, never an unhandled KeyError.
                continue
            if (run_id is not None and obj.get("run_id") is not None
                    and obj["run_id"] != run_id):
                continue
            if process_count is not None and not 0 <= host < process_count:
                continue
            out[host] = int(obj["position"])
        return out

    def read_intents(self, epoch: int, run_id: str | None = None,
                     process_count: int | None = None) -> dict[int, int]:
        """``{host: proposed_position}`` for every readable intent."""
        return self._read_host_records(
            epoch, "intent-host-", run_id, process_count
        )

    def clear_host_records(self, epoch: int, host: int) -> None:
        """Remove ONE host's rendezvous records (intent + vote) from an
        epoch dir — restart-time scrubbing of a crashed incarnation's
        leftovers. Own-records-only by contract: a peer's fresh record
        can never be this host's, so the scrub cannot race a faster
        peer's restart. Shard files stay (their content at a position
        is deterministic; re-attempts overwrite them atomically)."""
        for path in (self._intent_path(epoch, host),
                     self._prepared_path(epoch, host)):
            try:
                os.unlink(path)
            except OSError:
                pass

    # -------------------------------------------------------------- 2PC

    def write_shard(self, epoch: int, host: int, state,
                    position: int, meta: dict | None = None) -> str:
        path = self.shard_path(epoch, host, position)
        save_checkpoint(path, state, position=position, meta=meta)
        return path

    def write_prepared(self, epoch: int, host: int, position: int,
                       run_id: str | None = None) -> str:
        path = self._prepared_path(epoch, host)
        write_json_atomic(path, {
            "host": host, "position": int(position), "epoch": epoch,
            "run_id": run_id, "wall_time": time.time(),
        })
        return path

    def read_prepared(self, epoch: int, run_id: str | None = None,
                      process_count: int | None = None) -> dict[int, int]:
        """``{host: prepared_position}`` — the 2PC vote set."""
        return self._read_host_records(
            epoch, "prepared-host-", run_id, process_count
        )

    def commit(self, epoch: int, position: int, process_count: int,
               meta: dict | None = None) -> dict:
        """Atomically publish the manifest — THE commit point. Readers
        see the previous committed epoch or this one, never between.
        Returns the manifest dict that was written."""
        man = {
            "version": MANIFEST_VERSION,
            "epoch": epoch,
            "position": int(position),
            "process_count": process_count,
            "hosts": list(range(process_count)),
            "wall_time": time.time(),
            "meta": meta or {},
        }
        write_json_atomic(self.manifest_path, man)
        return man

    # --------------------------------------------------------- manifest

    def read_manifest(self) -> dict | None:
        """The committed manifest, or None when nothing ever committed.
        A present-but-unreadable or schema-invalid manifest raises
        :class:`ManifestCorruptError` — the commit record is written
        atomically, so garbage is a store fault, not a race."""
        try:
            with open(self.manifest_path) as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            raise ManifestCorruptError(
                f"manifest {self.manifest_path} unreadable: {e}"
            ) from e
        try:
            man = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ManifestCorruptError(
                f"manifest {self.manifest_path} is torn/unparsable "
                f"({e}) — it is written atomically, so this is disk "
                "corruption, not an in-flight write"
            ) from e
        self.validate_manifest(man)
        return man

    def validate_manifest(self, man: Any) -> None:
        if not isinstance(man, dict):
            raise ManifestCorruptError(
                f"manifest {self.manifest_path}: expected an object, got "
                f"{type(man).__name__}"
            )
        version = man.get("version")
        if not isinstance(version, int) or version > MANIFEST_VERSION:
            raise ManifestCorruptError(
                f"manifest {self.manifest_path}: version {version!r} "
                f"(this build reads up to {MANIFEST_VERSION})"
            )
        for key, typ in (("epoch", int), ("position", int),
                         ("process_count", int), ("hosts", list),
                         ("wall_time", (int, float))):
            v = man.get(key)
            if not isinstance(v, typ) or isinstance(v, bool):
                raise ManifestCorruptError(
                    f"manifest {self.manifest_path}: field {key!r} is "
                    f"{v!r}; expected "
                    f"{typ.__name__ if isinstance(typ, type) else 'number'}"
                )
        if man["epoch"] < 0 or man["position"] < 0:
            raise ManifestCorruptError(
                f"manifest {self.manifest_path}: negative epoch/position"
            )
        if sorted(man["hosts"]) != list(range(man["process_count"])):
            raise ManifestCorruptError(
                f"manifest {self.manifest_path}: hosts {man['hosts']} do "
                f"not cover process_count {man['process_count']}"
            )

    def validate_epoch(self, man: dict) -> None:
        """Reject a mixed-epoch store: the committed epoch must hold a
        shard file at the manifest position for EVERY host it names.

        Validation targets the SHARDS, not the prepared markers: shards
        are fsync-durable before any vote is written and their content
        at a given position is deterministic, so they remain the truth
        even when a later crashed re-attempt of the same epoch
        overwrote the vote files — validating votes here could wedge a
        store whose shards are perfectly consistent. Votes are a
        commit-protocol artifact; once the manifest exists, they have
        served their purpose. (Per-shard position headers and CRCs are
        checked at load by ``load_shard``.)"""
        epoch, position = man["epoch"], man["position"]
        for host in man["hosts"]:
            shard = self.shard_path(epoch, host, position)
            if not os.path.exists(shard):
                raise MixedEpochError(
                    f"committed epoch {epoch}: host {host}'s shard at "
                    f"position {position} ({shard}) is missing — the "
                    "store mixes epochs (partial copy or manual "
                    "surgery?); refusing to resume from it"
                )

    def load_shard(self, epoch: int, host: int, position: int, like=None):
        """CRC-validated shard load → ``(state, position, meta)``."""
        return load_checkpoint(
            self.shard_path(epoch, host, position), like=like
        )

    def prune(self, committed: int, keep: int) -> None:
        """Leader-only epoch rotation: keep the committed epoch plus the
        ``keep - 1`` epochs directly below it (fallback forensics —
        older dirs include uncommitted leftovers from crashed
        incarnations, which can never commit since epoch numbers are
        monotone and never reused). Epochs ABOVE the committed one are
        never touched: one may be mid-write."""
        import shutil

        for e in self.list_epochs():
            if e < committed - (keep - 1):
                try:
                    # Vetted EO004 exception: the newest-artifact
                    # validation happened at the COMMIT point, not here
                    # — ``committed`` is the manifest epoch published by
                    # CheckpointStore.commit after the all-votes-in
                    # guard (the PI001 gate) and shard presence is
                    # re-verified by validate_manifest on every resume.
                    # Only epochs strictly below committed-(keep-1) are
                    # deleted; the committed epoch and everything above
                    # it (one may be mid-write) are never touched, so a
                    # torn in-flight epoch can never orphan the
                    # rotation.
                    shutil.rmtree(  # graphlint: disable=EO004
                        self.epoch_dir(e))
                except OSError:
                    pass


# ---------------------------------------------------------------------- #
# leases


class LeaseBoard:
    """Lease-file liveness: each host heartbeats
    ``members/host-<k>.json`` at ``ttl/3`` cadence; a host whose lease
    is older than ``ttl`` is expired. Wall-clock based — the hosts of a
    store share a machine or a fleet with sane NTP; the ttl is seconds,
    not milliseconds."""

    def __init__(self, store: CheckpointStore, host: int, ttl: float,
                 clock: Callable[[], float] = time.time):
        if ttl <= 0:
            raise ValueError(f"lease ttl must be > 0, got {ttl}")
        self.store = store
        self.host = host
        self.ttl = ttl
        self._clock = clock
        self._last_beat = 0.0
        # beat() is called from BOTH the background lease thread and the
        # protocol paths (maybe_beat per chunk, forced beats at barrier
        # entry): the rate-limit check-then-set and the beats counter
        # are a lost-update read-modify-write without this lock
        # (racecheck RC001/RC002).
        self._beat_lock = threading.Lock()
        # Incarnation boundary for expiry: only a lease beaten AT OR
        # AFTER this board existed counts as "seen alive"; an older
        # file is a previous incarnation's leftover and reads as
        # not-joined-yet (which waits, bounded), never as death — else
        # a restart whose peers construct a beat slower would
        # false-abort its first barrier on stale files.
        self.born = clock()
        self.beats = 0

    def _path(self, host: int) -> str:
        return os.path.join(self.store.members_dir, f"host-{host}.json")

    def beat(self, force: bool = False) -> bool:
        """Refresh this host's lease (rate-limited to ttl/3); returns
        True when a write actually happened."""
        now = self._clock()
        with self._beat_lock:
            if not force and now - self._last_beat < self.ttl / 3.0:
                return False
            self._last_beat = now
            self.beats += 1
            beats = self.beats
        # The fsync'd file write stays OUTSIDE the lock: serializing the
        # beat thread against a barrier's forced beat on a slow (NFS)
        # store would make liveness wait on disk latency (the same
        # discipline racecheck RC004 enforces). Concurrent force-beats
        # both write — write_json_atomic is rename-atomic, last wins.
        write_json_atomic(self._path(self.host), {
            "host": self.host, "wall_time": now, "ttl": self.ttl,
            "beats": beats,
        })
        return True

    def wall(self, host: int) -> float | None:
        obj = _read_json(self._path(host))
        if obj is None:
            return None
        w = obj.get("wall_time")
        return float(w) if isinstance(w, (int, float)) else None

    def expired(self, host: int) -> bool:
        """True only for a host seen alive DURING THIS INCARNATION
        (lease beaten at/after this board's construction) that then let
        its lease lapse. An absent file — or a stale leftover from a
        previous incarnation — is "not joined yet", which waits
        (bounded by the caller's timeout) rather than failing fast."""
        w = self.wall(host)
        return (w is not None and w >= self.born
                and self._clock() - w > self.ttl)

    def live(self) -> set[int]:
        """Hosts with a fresh lease."""
        out = set()
        try:
            names = os.listdir(self.store.members_dir)
        except OSError:
            return out
        now = self._clock()
        for n in names:
            m = _HOST_RE.match(n.removesuffix(".json"))
            if not m:
                continue
            obj = _read_json(os.path.join(self.store.members_dir, n))
            if obj is None:
                continue
            w = obj.get("wall_time")
            if isinstance(w, (int, float)) and now - w <= self.ttl:
                out.add(int(m.group(1)))
        return out


# ---------------------------------------------------------------------- #
# the coordinator


@dataclasses.dataclass(frozen=True)
class CoordinationConfig:
    """Knobs of :class:`Coordinator` (all have production defaults).

    ``lease_thread`` (default True) runs a daemon thread beating this
    host's lease every ``lease_ttl / 3`` for the coordinator's
    lifetime: the lease then means PROCESS liveness (a SIGKILLed host
    expires, a host stalled in a long shard write / kernel build does
    not), so peers never false-declare a slow-but-alive host dead.
    Protocol *progress* hangs are still bounded by
    ``barrier_timeout``. Tests that simulate silent death set it False
    (or ``close()`` the coordinator, which stops the thread).
    """

    lease_ttl: float = 5.0
    poll_s: float = 0.02
    barrier_timeout: float = 60.0
    keep_epochs: int = 3
    lease_thread: bool = True
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic


class Coordinator:
    """One host's handle on the coordinated-recovery protocol.

    Construct one per process over a shared ``root`` (all hosts must
    see the same directory). The resilient runner
    (``engine/resilience.ResilientRunner(coordinator=...)``) calls
    :meth:`agree_position` at checkpoint cadence, :meth:`publish` when
    the barrier position is retired, :meth:`recover` at start, and
    :meth:`maybe_beat` per chunk; all four are equally usable
    standalone.
    """

    def __init__(self, root: str, identity: HostIdentity | None = None,
                 config: CoordinationConfig | None = None):
        self.identity = identity or detect_host_identity()
        self.config = config or CoordinationConfig()
        self.store = CheckpointStore(root)
        self.board = LeaseBoard(
            self.store, self.identity.process_index,
            self.config.lease_ttl,
        )
        self._last_leader: int | None = None
        self._last_observe = float("-inf")
        self.committed_epoch: int | None = None
        self.committed_position: int | None = None
        man = self.store.read_manifest()
        self._reset_epochs(man)
        self.board.beat(force=True)
        self._observe_leader()
        self._beat_stop = threading.Event()
        if self.config.lease_thread:
            t = threading.Thread(
                target=self._beat_loop, daemon=True,
                name=f"gelly-lease-{self.identity.process_index}",
            )
            t.start()
        _register(self)

    def _reset_epochs(self, man: dict | None) -> None:
        """Derive epoch numbering from the COMMITTED state only:
        ``committed + 1``. Every host of an incarnation reads the same
        manifest, so the numbering agrees even when a fast host reaches
        its first barrier before a slow host finishes constructing
        (listing live epoch dirs here would race exactly there). A
        crashed incarnation's uncommitted epoch dir is therefore
        RE-ATTEMPTED in place — safe because every write into it is an
        atomic per-host overwrite, and stale files from a *different*
        incarnation are filtered by ``run_id`` (below)."""
        if man is not None:
            self.committed_epoch = man["epoch"]
            self.committed_position = man["position"]
        committed = man["epoch"] if man is not None else 0
        self._next_epoch = committed + 1
        # Shared incarnation tag: all hosts restart together
        # (restart-time coordination) and read the same manifest, so
        # they derive the same run_id; intents/votes left by a PREVIOUS
        # incarnation that started from a DIFFERENT committed epoch
        # carry a different tag and are ignored by the rendezvous
        # readers. Incarnations that crashed without advancing the
        # committed epoch share the tag — so additionally every host
        # SCRUBS ITS OWN records from epochs above the committed one
        # here (own files only: a peer's fresh record can never be
        # ours, so this cannot race a faster peer's restart), and the
        # rendezvous readers drop out-of-group host indices (a lost
        # host's leftovers after a degraded re-join). The residual
        # window — a host so fast it barriers before a slow peer's
        # scrub — can at worst skew one barrier into a LOUD
        # deadline-bounded abort (skewed votes are never committed);
        # by the next restart the scrub has run everywhere and the
        # attempt converges.
        wall = man["wall_time"] if man is not None else 0
        self._run_id = f"e{committed}-{wall}"
        for e in self.store.list_epochs():
            if e > committed:
                self.store.clear_host_records(e, self.process_index)

    def _beat_loop(self) -> None:
        while not self._beat_stop.wait(self.config.lease_ttl / 3.0):
            try:
                self.board.beat(force=True)
            except Exception:  # noqa: BLE001 — liveness must not crash
                logger.exception("lease beat failed")

    # ------------------------------------------------------- liveness

    @property
    def process_index(self) -> int:
        return self.identity.process_index

    def maybe_beat(self) -> None:
        """Per-chunk liveness hook: rate-limited lease refresh plus a
        leadership observation at ``lease_ttl / 3`` cadence. The
        observation has its OWN rate limiter — with the background
        lease thread on, ``beat()`` here almost never fires (the thread
        keeps the lease fresh), but leadership changes must still
        surface between barriers."""
        self.board.beat()
        now = self.config.clock()
        if now - self._last_observe >= self.config.lease_ttl / 3.0:
            self._last_observe = now
            self._observe_leader()

    def _observe_leader(self) -> int | None:
        live = self.board.live()
        live.add(self.process_index)  # own lease is fresh by definition
        leader = min(live)
        if leader != self._last_leader:
            obs_bus.get_bus().emit(
                "coordination.leader_elected",
                leader=leader, previous=self._last_leader,
                host=self.process_index,
                live=sorted(live),
            )
            logger.info(
                "host %d observes leader %s (was %s; live=%s)",
                self.process_index, leader, self._last_leader,
                sorted(live),
            )
            self._last_leader = leader
        return leader

    @property
    def is_leader(self) -> bool:
        return self._last_leader == self.process_index

    # -------------------------------------------------------- barrier

    def agree_position(self, position: int) -> tuple[int, int]:
        """Checkpoint barrier: post this host's last-retired position,
        wait for every host's proposal, return ``(epoch, agreed)`` with
        ``agreed = max(proposals) >= position``. Each host then folds
        to ``agreed`` and calls :meth:`publish`."""
        epoch = self._next_epoch
        self._next_epoch += 1
        n = self.identity.process_count
        # Entering the barrier proves liveness — force a beat so a long
        # host-side stall right before (first-call kernel builds, a
        # slow fold) can't read as death to a peer's expiry check.
        self.board.beat(force=True)
        path = self.store.write_intent(
            epoch, self.process_index, position, run_id=self._run_id
        )
        faults_mod.inject("barrier", path=path)
        intents = self._wait(
            lambda: self.store.read_intents(
                epoch, run_id=self._run_id, process_count=n
            ),
            lambda got: len(got) >= n,
            what=f"barrier epoch {epoch}: intents",
        )
        agreed = max(intents.values())
        # t_wall: wall-clock stamp for the multi-host trace stitcher —
        # per-host rings use monotonic clocks with unrelated epochs, so
        # stitch_traces aligns on this instant (matched by `epoch`) and
        # t_wall is the recorded fallback evidence of the true skew.
        obs_bus.get_bus().emit(
            "coordination.barrier_agreed", epoch=epoch, position=agreed,
            host=self.process_index, proposals=len(intents),
            t_wall=round(time.time(), 6),
        )
        return epoch, agreed

    # ------------------------------------------------------------ 2PC

    def publish(self, epoch: int, state, position: int,
                meta: dict | None = None) -> dict:
        """Two-phase commit of this host's shard at the barrier-agreed
        position: write the shard (phase 1: prepared), then drive or
        await the manifest commit (phase 2). Returns the committed
        manifest. If the leader dies between the phases, the next
        lowest live host takes the commit over — rotation, not abort."""
        faults_mod.inject("barrier")
        # The shard write (host state → fsync'd file) can stall
        # past ttl on big summaries; prove liveness on entry.
        self.board.beat(force=True)
        self.store.write_shard(
            epoch, self.process_index, state, position, meta=meta
        )
        self.store.write_prepared(
            epoch, self.process_index, position, run_id=self._run_id
        )
        obs_bus.get_bus().emit(
            "coordination.prepared", epoch=epoch, position=position,
            host=self.process_index,
        )
        man = self._drive_commit(epoch, position)
        self.committed_epoch = man["epoch"]
        self.committed_position = man["position"]
        return man

    def _drive_commit(self, epoch: int, position: int) -> dict:
        cfg = self.config
        deadline = cfg.clock() + cfg.barrier_timeout
        leader = self._last_leader
        next_liveness = cfg.clock()  # first iteration observes at once
        while True:
            man = self.store.read_manifest()
            if man is not None and man["epoch"] >= epoch:
                if man["epoch"] == epoch and man["position"] != position:
                    raise CoordinationError(
                        f"epoch {epoch} committed at position "
                        f"{man['position']} but this host prepared "
                        f"{position} — barrier skew"
                    )
                return man
            now = cfg.clock()
            if now >= next_liveness:
                # Leadership/expiry move at lease granularity; see _wait.
                next_liveness = now + cfg.lease_ttl / 3.0
                leader = self._observe_leader()
                self.board.beat()
            if leader == self.process_index:
                committed = self._leader_commit(epoch, position)
                if committed is not None:
                    return committed
            if now > deadline:
                raise CoordinationError(
                    f"epoch {epoch}: no commit within "
                    f"{cfg.barrier_timeout:.3g}s (leader {leader}, "
                    f"live {sorted(self.board.live())})"
                )
            cfg.sleep(cfg.poll_s)

    def _leader_commit(self, epoch: int, position: int) -> dict | None:
        """Leader side of phase 2 (non-blocking — the deadline lives in
        ``_drive_commit``'s loop): once every host's prepared marker is
        present, write the manifest atomically and prune old epochs.
        Returns None while votes are still (live-host) pending; raises
        when a missing host is provably dead — the epoch aborts with no
        manifest, so recovery uses the previous committed epoch."""
        n = self.identity.process_count
        prepared = self.store.read_prepared(
            epoch, run_id=self._run_id, process_count=n
        )
        # A vote at the wrong position is treated as PENDING, never
        # committed: it is either a crashed incarnation's leftover that
        # its live host will overwrite in a moment (converges), or a
        # genuine barrier-skew bug — then the commit deadline in
        # _drive_commit expires and the epoch aborts loudly. Raising
        # here instantly would turn the benign leftover race into an
        # abort on every re-attempt.
        skew = {h: p for h, p in prepared.items() if p != position}
        if skew:
            logger.warning(
                "epoch %d: prepared positions %s disagree with the "
                "barrier position %d; waiting for overwrite (stale "
                "leftover?) under the commit deadline", epoch, skew,
                position,
            )
        missing = (set(range(n)) - prepared.keys()) | skew.keys()
        if missing:
            dead = sorted(
                h for h in missing - skew.keys()
                if self.board.expired(h)
            )
            if dead:
                raise CoordinationError(
                    f"epoch {epoch} cannot commit: host(s) {dead} died "
                    "before preparing their shard — aborting the epoch "
                    "(no manifest written; recovery uses epoch "
                    f"{self.committed_epoch})"
                )
            return None
        man = self.store.commit(
            epoch, position, n,
            meta={"committed_by": self.process_index},
        )
        # Path-carrying injection point AFTER the atomic write: a
        # kind="corrupt" fault here models the torn manifest recovery
        # must reject.
        faults_mod.inject("barrier", path=self.store.manifest_path)
        obs_bus.get_bus().emit(
            "coordination.committed", epoch=epoch, position=position,
            host=self.process_index,
        )
        self.store.prune(epoch, self.config.keep_epochs)
        return man

    # -------------------------------------------------------- recover

    def recover(self, like=None, adopt: Callable | None = None,
                reshard: Callable | None = None):
        """Restart-time re-join. Returns ``None`` (fresh store) or
        ``(state, position, meta)``:

        - committed ``process_count`` == ours: validate the epoch
          (:class:`MixedEpochError` on inconsistency), load OUR shard
          (CRC-checked against ``like``), publish a
          ``coordination.rejoins`` event.
        - committed ``process_count`` > ours and ``adopt`` given:
          the degradation rung — this survivor additionally loads every
          orphan shard assigned to it (``old_host % new_count``) and
          folds each into its state with ``adopt(state, shard_state)``;
          publishes ``coordination.degradations``. ``reshard`` — the
          ingest-side re-shard hook (``gelly_tpu.ingest.
          ShardRoutingTable.reroute`` fits it) — is then called with
          ``(old_count, new_count)`` so the lost hosts' future chunks
          follow their adopted state to the same survivors.
        - committed ``process_count`` > ours without ``adopt``: loud
          :class:`CoordinationError` — silently dropping shards would
          lose folded edges.
        - committed ``process_count`` < ours (the group GREW): hosts
          below the old count load their shard; new hosts return
          ``(None, position, meta)`` — fresh state, barrier-agreed
          position.

        ``state`` can be ``None`` only in that last case.
        """
        man = self.store.read_manifest()
        self._reset_epochs(man)
        if man is None:
            return None
        self.store.validate_epoch(man)
        epoch, position = man["epoch"], man["position"]
        me, n = self.process_index, self.identity.process_count
        old_n = man["process_count"]
        bus = obs_bus.get_bus()
        if old_n > n and adopt is None:
            raise CoordinationError(
                f"manifest epoch {epoch} holds {old_n} host shards but "
                f"only {n} host(s) are re-joining and no adopt combine "
                "was supplied — refusing to silently drop "
                f"{old_n - n} shard(s) of folded state"
            )
        state = None
        adopted: list[int] = []
        if me < old_n:
            state, pos, meta = self.store.load_shard(
                epoch, me, position, like=like
            )
            if pos != position:
                raise MixedEpochError(
                    f"epoch {epoch}: own shard records position {pos} "
                    f"but the manifest commits {position}"
                )
        else:
            meta = dict(man.get("meta", {}))
        if old_n > n:
            # Degraded-capacity takeover: orphan host j -> survivor
            # j % n. The per-leaf layout is host-agnostic, so adopting
            # a shard is one combine per orphan.
            for j in range(old_n):
                if j < n or j % n != me:
                    continue
                s_j, pos_j, _ = self.store.load_shard(
                    epoch, j, position, like=like
                )
                if pos_j != position:
                    raise MixedEpochError(
                        f"epoch {epoch}: orphan shard {j} records "
                        f"position {pos_j} vs manifest {position}"
                    )
                state = s_j if state is None else adopt(state, s_j)
                adopted.append(j)
            bus.emit(
                "coordination.degradations",
                epoch=epoch, position=position,
                lost_hosts=old_n - n, process_count=n,
                previous_process_count=old_n,
                adopted=adopted, host=me,
                capacity_frac=round(n / old_n, 4),
            )
            logger.warning(
                "host %d re-joins DEGRADED: %d of %d hosts survive "
                "(adopted shards %s); stream continues at %.0f%% capacity",
                me, n, old_n, adopted, 100.0 * n / old_n,
            )
            if reshard is not None:
                # Ingest follows state: re-route the lost hosts' reader
                # shards to the survivors that adopted their forests
                # (same j % new_count rule on both sides).
                reshard(old_n, n)
        bus.emit(
            "coordination.rejoins", epoch=epoch, position=position,
            host=me, degraded=bool(adopted),
        )
        return state, position, meta

    # ----------------------------------------------------- rendezvous

    def _wait(self, read: Callable[[], dict], ready: Callable[[dict], bool],
              what: str) -> dict:
        """Bounded poll for a rendezvous set keyed by host index: fails
        FAST when a missing host's lease has provably expired (peer
        death), else at ``barrier_timeout``. Keeps this host's own
        lease fresh while it waits."""
        cfg = self.config
        deadline = cfg.clock() + cfg.barrier_timeout
        n = self.identity.process_count
        next_liveness = cfg.clock()  # first iteration checks immediately
        while True:
            got = read()
            if ready(got):
                return got
            missing = set(range(n)) - set(got)
            now = cfg.clock()
            if now >= next_liveness:
                # Expiry/leadership move at lease granularity — probing
                # the members dir every poll_s would be pure metadata
                # churn on a shared (NFS) store for identical answers.
                next_liveness = now + cfg.lease_ttl / 3.0
                dead = sorted(h for h in missing if self.board.expired(h))
                if dead:
                    raise CoordinationError(
                        f"{what}: host(s) {dead} lease-expired while "
                        f"{sorted(missing)} still missing — peer death"
                    )
                self.board.beat()
                self._observe_leader()
            if now > deadline:
                raise CoordinationError(
                    f"{what}: incomplete after "
                    f"{cfg.barrier_timeout:.3g}s (missing "
                    f"{sorted(missing)}, live {sorted(self.board.live())})"
                )
            cfg.sleep(cfg.poll_s)

    def close(self) -> None:
        """Stop the lease beat thread (this host's lease then expires
        within ``lease_ttl`` — peers treat it as departed) and drop the
        observability registration. Idempotent; a closed coordinator
        must not be reused — construct a fresh one per incarnation."""
        self._beat_stop.set()
        _unregister(self)


# ---------------------------------------------------------------------- #
# active-coordinator registry (observability: heartbeat/trace host lines)

_ACTIVE: Coordinator | None = None
_ACTIVE_LOCK = threading.Lock()


def _register(coord: Coordinator) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = coord


def _unregister(coord: Coordinator) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is coord:
            _ACTIVE = None


def active_coordinator() -> Coordinator | None:
    return _ACTIVE


def leader_flag() -> bool | None:
    """This process's last-observed leadership, or None when no
    coordinator is active — the heartbeat/trace host-identity field."""
    coord = _ACTIVE
    return coord.is_leader if coord is not None else None
