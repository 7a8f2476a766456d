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
in a ``shard_map`` program. The engine (``run_aggregation(mesh=)``) and
the sharded library run as one global program in every process: each
process passes the same global stream and arguments, stages, copies and
folds only the shards it holds, and reads every global quantity through
one collective (:func:`all_gather_shards`, :func:`global_sum`,
:func:`global_max`, :func:`broadcast_tree`), so a replicated value (an
emission, a merged summary, a drop count) is the same in every process
and equals the single controller's. The tenant engine schedules its
rounds from wall clocks that differ between processes, so it still
refuses such a mesh (:func:`require_one_process`, ROADMAP.md item 8e).
"""

from __future__ import annotations

import datetime
from typing import Callable, Sequence

import numpy as np
import torch

from ..engine.checkpoint import tree_flatten, tree_map, tree_unflatten

SHARD_AXIS = "shards"

# Recorded by initialize_multihost so observability (heartbeat lines,
# Chrome-trace otherData) can attribute a capture to its cluster. None on
# single-process runs.
_COORDINATOR_ADDRESS: str | None = None

# The process group's bound on every wait: a collective whose peer died
# raises after this long instead of hanging the run.
PROCESS_GROUP_TIMEOUT = datetime.timedelta(seconds=120)

_MULTIHOST_ITEM = ("ROADMAP.md queue 1 item 8e (the tenant engine over a "
                   "mesh that spans processes: its rounds follow QoS "
                   "decisions made on each process's wall clock, and "
                   "need a round plan agreed across processes)")


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
    """Refuse a mesh that spans processes for ``what`` (the tenant
    engine, whose rounds are not one program across processes)."""
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


# ---------------------------------------------------------------------- #
# global reads on a mesh that spans processes: each is one collective,
# called by every process in the same order; on a one-process mesh they
# touch no process group.


def local_device(mesh: Mesh) -> torch.device:
    """The device of this process's first shard: where its replicated
    values live."""
    return mesh.devices[mesh.local_shards[0]]


def _leaf_meta(x):
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), x.dtype)
    return ("o", x)


def _pack_leaves(leaves: list) -> torch.Tensor:
    parts = [x.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
             for x in leaves if isinstance(x, torch.Tensor)]
    if not parts:
        return torch.zeros(0, dtype=torch.uint8)
    return torch.cat(parts)


def _unpack_leaves(buf: torch.Tensor, metas: list, device) -> list:
    out, off = [], 0
    for m in metas:
        if m[0] == "o":
            out.append(m[1])
            continue
        _, shape, dtype = m
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype).element_size()
        part = buf[off:off + n].clone().view(dtype).reshape(shape)
        out.append(part if device is None or torch.device(device).type ==
                   "cpu" else part.to(device))
        off += n
    return out


def all_gather_shards(mesh: Mesh, values: list, device=None) -> list:
    """Every shard's value (a tensor or a tree), in shard order, in every
    process: the ``all_gather`` of a ``P("shards")`` value. ``values`` is
    the list of S with ``None`` at other processes' shards; the result
    holds all S, on ``device`` (default: the CPU). One collective of the
    leaves' shapes and one of their bytes across processes."""
    if mesh.process_count == 1:
        return [tree_map(lambda x: _to(x, torch.device(device or "cpu")), v)
                for v in values]
    import torch.distributed as dist

    local = [(i, tree_flatten(values[i])) for i in mesh.local_shards]
    mine = [(i, spec, [_leaf_meta(x) for x in leaves])
            for i, (leaves, spec) in local]
    buf = torch.cat([_pack_leaves(leaves) for _, (leaves, _) in local])
    metas: list = [None] * mesh.process_count
    dist.all_gather_object(metas, (mine, int(buf.numel())))
    width = max(n for _, n in metas)
    send = torch.zeros(width, dtype=torch.uint8)
    send[:buf.numel()] = buf
    recv = [torch.empty(width, dtype=torch.uint8)
            for _ in range(mesh.process_count)]
    dist.all_gather(recv, send)
    mesh.sent_bytes += width * (mesh.process_count - 1)
    mesh.received_bytes += width * (mesh.process_count - 1)
    out: list = [None] * mesh.num_shards
    for p, (shards, _) in enumerate(metas):
        off = 0
        for i, spec, lm in shards:
            n = sum(int(np.prod(m[1], dtype=np.int64))
                    * torch.empty((), dtype=m[2]).element_size()
                    for m in lm if m[0] == "t")
            out[i] = tree_unflatten(spec, _unpack_leaves(
                recv[p][off:off + n], lm, device))
            off += n
    return out


def _reduce_processes(mesh: Mesh, value: int, op: str) -> int:
    if mesh.process_count == 1:
        return value
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM)
    return int(t[0])


def global_sum(mesh: Mesh, values: list) -> int:
    """The integer sum of one scalar a shard over every shard of every
    process (``None`` at other processes' shards): one host read of the
    local shards, then one ``all_reduce``."""
    local = sum(int(values[i]) for i in mesh.local_shards)
    return _reduce_processes(mesh, local, "sum")


def global_max(mesh: Mesh, values: list) -> int:
    """The integer max of one scalar a shard over every shard of every
    process (see :func:`global_sum`)."""
    local = max(int(values[i]) for i in mesh.local_shards)
    return _reduce_processes(mesh, local, "max")


def global_any(mesh: Mesh, flag: bool) -> bool:
    """Whether ``flag`` holds in any process."""
    return bool(_reduce_processes(mesh, int(bool(flag)), "max"))


def broadcast_tree(mesh: Mesh, tree, src_shard: int = 0, device=None):
    """The value ``tree`` of the process holding ``src_shard``, in every
    process, on ``device`` (default: this process's first shard's): a
    replicated value read from one shard (``gelly_tpu``'s ``P()`` output).
    The holder passes its value, the others anything (it is ignored); the
    holder keeps its own tree as it is."""
    if mesh.process_count == 1:
        return tree
    import torch.distributed as dist

    src = mesh.processes[src_shard]
    dev = device if device is not None else local_device(mesh)
    if mesh.process_index == src:
        leaves, spec = tree_flatten(tree)
        buf = _pack_leaves(leaves)
        head = [(spec, [_leaf_meta(x) for x in leaves], int(buf.numel()))]
    else:
        head = [None]
    dist.broadcast_object_list(head, src=src)
    spec, metas, n = head[0]
    if mesh.process_index != src:
        buf = torch.empty(n, dtype=torch.uint8)
    dist.broadcast(buf, src=src)
    if mesh.process_index == src:
        mesh.sent_bytes += n * (mesh.process_count - 1)
        return tree
    mesh.received_bytes += n
    return tree_unflatten(spec, _unpack_leaves(buf, metas, dev))


def barrier(mesh: Mesh) -> None:
    """Every process of the mesh waits for the others (none on a
    one-process mesh)."""
    if mesh.process_count > 1:
        import torch.distributed as dist

        dist.barrier()
