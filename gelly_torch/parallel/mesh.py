"""The device mesh of the port: a single controller over S shards.

Counterpart of ``gelly_tpu/parallel/mesh.py``. ``gelly_tpu`` runs each
mesh program as one ``shard_map`` over a ``jax.sharding.Mesh``; the port
drives the shards from one Python thread instead:

- a :class:`Mesh` is a list of ``torch.device`` objects, one a shard. A
  device may appear more than once: ``make_mesh(4, devices=[cuda:0] * 4)``
  runs four logical shards on one card, each holding its state at full
  width, and the same code puts shards on distinct cards;
- a *sharded* value (the counterpart of a ``P("shards")`` array) is a
  Python list of S per-shard values, shard ``i``'s on ``mesh.devices[i]``;
  a *replicated* value is one copy a shard;
- a ``shard_map`` body becomes a per-shard function (:func:`shard_map_fn`
  runs it once a shard), and a body that calls a collective partway
  through is split into bulk-synchronous phases around the collective
  (``parallel/collectives.py``, ``parallel/partition.py``), whose copies
  between shards are ``.to(device)`` to another card and ``clone()`` on
  the same one.

Across processes (the counterpart of ``initialize_multihost`` and a
``jax.distributed`` mesh): :func:`initialize_multihost` joins a
``torch.distributed`` process group over gloo, and :func:`make_mesh` then
builds ONE global shard axis over every process's devices. Process ``p``
holds shards ``p*d ... p*d + d - 1``, where ``d`` (the number of devices
it brings) is the same in every process. On such a mesh:

- ``mesh.devices[i]`` is shard ``i``'s device in the process that holds
  it and ``None`` elsewhere; ``mesh.processes[i]`` names the holder;
- a sharded value is still a list of S entries, with ``None`` at every
  shard another process holds: each process passes and gets back its own
  shards only (:func:`shard_map_fn`, :func:`device_put_sharded_leading`
  and :func:`device_put_replicated` touch local shards only);
- a copy between shards of two processes goes through the process group,
  staged through host memory (gloo moves CPU tensors);
  ``mesh.sent_bytes`` and ``mesh.received_bytes`` count what this process
  moved.

Every process takes part in each collective call, in the same order, as
in a ``shard_map`` program. The engine and the sharded library drive
every shard from one process, so they refuse a mesh that spans processes
(:func:`require_one_process`, ROADMAP.md item 8d).
"""

from __future__ import annotations

import datetime
from typing import Callable, Sequence

import numpy as np
import torch

from ..engine.checkpoint import tree_map

SHARD_AXIS = "shards"

# Recorded by initialize_multihost so observability (heartbeat lines,
# Chrome-trace otherData) can attribute a capture to its cluster. None on
# single-process runs.
_COORDINATOR_ADDRESS: str | None = None

# The process group's bound on every wait: a collective whose peer died
# raises after this long instead of hanging the run.
PROCESS_GROUP_TIMEOUT = datetime.timedelta(seconds=120)

_MULTIHOST_ITEM = ("ROADMAP.md queue 1 item 8d (the engine and the sharded "
                   "library over a mesh that spans processes)")


class Mesh:
    """A 1-D mesh of S shards: ``devices[i]`` holds shard ``i`` (``None``
    where another process holds it; ``processes[i]`` is the holder)."""

    def __init__(self, devices: Sequence, processes: Sequence | None = None,
                 process_index: int = 0):
        self.devices = tuple(None if d is None else torch.device(d)
                             for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (SHARD_AXIS,)
        self.processes = (tuple(int(p) for p in processes)
                          if processes is not None
                          else (process_index,) * len(self.devices))
        self.process_index = process_index
        self.process_count = len(set(self.processes))
        self.local_shards = tuple(i for i, p in enumerate(self.processes)
                                  if p == process_index)
        # Bytes this process moved through the process group.
        self.sent_bytes = 0
        self.received_bytes = 0

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: len(self.devices)}

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        where = (f", processes=[{', '.join(map(str, self.processes))}]"
                 if self.process_count > 1 else "")
        return (f"Mesh({SHARD_AXIS}={self.num_shards}, devices="
                f"[{', '.join(str(d) for d in self.devices)}]{where})")


def require_one_process(mesh, what: str) -> None:
    """Refuse a mesh that spans processes for ``what``, which drives every
    shard from this process."""
    if mesh is not None and mesh.process_count > 1:
        raise NotImplementedError(
            f"{what} on a mesh that spans processes is not ported yet: "
            f"{_MULTIHOST_ITEM}")


def _group_live() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Join a multi-process mesh: a ``torch.distributed`` process group
    over gloo, meeting at ``tcp://<coordinator_address>`` (process 0
    serves it). After it, :func:`make_mesh` builds one global shard axis
    across every process's devices — the analog of the reference's
    multi-TaskManager deployment (SURVEY.md §2.9). With no address the
    group reads ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
    ``WORLD_SIZE`` from the environment, as a launcher sets them. A failed
    join raises; every wait of the group is bounded by
    :data:`PROCESS_GROUP_TIMEOUT`."""
    import torch.distributed as dist

    kw = {"backend": "gloo", "timeout": PROCESS_GROUP_TIMEOUT,
          "init_method": (f"tcp://{coordinator_address}"
                          if coordinator_address is not None else "env://")}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(**kw)
    global _COORDINATOR_ADDRESS
    _COORDINATOR_ADDRESS = coordinator_address


def host_info() -> dict:
    """This process's mesh identity — the host fields heartbeat lines and
    Chrome-trace ``otherData`` carry: ``process_index`` /
    ``process_count`` of the live process group (0 / 1 with none) and the
    ``coordinator_address`` recorded by :func:`initialize_multihost`."""
    if _group_live():
        import torch.distributed as dist

        idx, cnt = dist.get_rank(), dist.get_world_size()
    else:
        idx, cnt = 0, 1
    return {"process_index": int(idx), "process_count": int(cnt),
            "coordinator_address": _COORDINATOR_ADDRESS}


def make_mesh(num_shards: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over ``num_shards`` devices (default: every visible
    card). ``devices`` may repeat a device to run logical shards on it.
    More shards than devices raises, as ``gelly_tpu``'s does; nothing
    falls back to the CPU.

    In a process group (:func:`initialize_multihost`) ``devices`` are this
    process's own, every process calls ``make_mesh`` together, and the
    mesh spans all of them: process ``p`` holds shards ``p*d ... p*d + d -
    1``. ``num_shards``, when given, must count every process's devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() places shards on the visible CUDA devices and "
                "this machine has none; pass devices=[...] (for example "
                "[torch.device('cpu')] * S) to build a mesh elsewhere"
            )
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if not _group_live():
        if num_shards is not None:
            if num_shards > len(devs):
                raise ValueError(
                    f"requested {num_shards} shards but only {len(devs)} "
                    "devices"
                )
            devs = devs[:num_shards]
        return Mesh(devs)
    import torch.distributed as dist

    me, n_proc = dist.get_rank(), dist.get_world_size()
    counts: list = [None] * n_proc
    dist.all_gather_object(counts, len(devs))
    if len(set(counts)) != 1:
        raise ValueError(
            "every process of a mesh must bring the same number of "
            f"devices; the processes bring {counts}"
        )
    d = counts[0]
    total = n_proc * d
    if num_shards is not None and num_shards != total:
        if num_shards > total:
            raise ValueError(
                f"requested {num_shards} shards but only {total} devices")
        raise ValueError(
            f"requested {num_shards} shards, but a mesh across {n_proc} "
            f"processes spans all {total} of their devices"
        )
    return Mesh([devs[k] if p == me else None
                 for p in range(n_proc) for k in range(d)],
                processes=[p for p in range(n_proc) for _ in range(d)],
                process_index=me)


def num_shards(mesh: Mesh) -> int:
    return mesh.num_shards


def shard_spec() -> str:
    """Marker of a value partitioned along the shard axis (a list of S)."""
    return SHARD_AXIS


def replicated_spec() -> None:
    """Marker of a replicated value (one copy a shard)."""
    return None


def shard_map_fn(mesh: Mesh, fn: Callable) -> Callable:
    """The per-shard runner: ``shard_map_fn(mesh, fn)(*sharded)`` calls
    ``fn(i, *args_i)`` for every shard ``i`` this process holds (each
    argument a list of S per-shard values) and returns the list of S
    results, ``None`` at shards another process holds."""
    def run(*sharded):
        for a in sharded:
            if len(a) != mesh.num_shards:
                raise ValueError(
                    f"sharded argument of {len(a)} shards on a "
                    f"{mesh.num_shards}-shard mesh")
        return [fn(i, *(a[i] for a in sharded))
                if mesh.devices[i] is not None else None
                for i in range(mesh.num_shards)]

    return run


def _to(x, device: torch.device):
    """A copy of one leaf on ``device`` (always a new tensor, so a shard
    never aliases another's state)."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return x


def tree_to(tree, device: torch.device):
    """Copy every leaf of a tuple / dict tree to ``device``."""
    return tree_map(lambda x: _to(x, device), tree)


def device_put_sharded_leading(mesh: Mesh, tree) -> list:
    """Place a tree whose leaves have leading dim S, sharded: shard ``i``
    gets every leaf's row ``i`` on its device (local shards only)."""
    return [tree_map(lambda x, i=i: _to(x[i], d), tree)
            if d is not None else None
            for i, d in enumerate(mesh.devices)]


def device_put_replicated(mesh: Mesh, tree) -> list:
    """One copy of ``tree`` on every local shard's device."""
    return [tree_to(tree, d) if d is not None else None
            for d in mesh.devices]
