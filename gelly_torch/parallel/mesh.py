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

The multi-process form (``torch.distributed`` over NCCL, the counterpart
of ``initialize_multihost``) is ROADMAP.md item 8b.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..engine.checkpoint import tree_map

SHARD_AXIS = "shards"


class Mesh:
    """A 1-D mesh of S shards: ``devices[i]`` holds shard ``i``."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (SHARD_AXIS,)

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: len(self.devices)}

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({SHARD_AXIS}={self.num_shards}, devices="
                f"[{', '.join(str(d) for d in self.devices)}])")


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """The multi-process mesh (``torch.distributed`` over NCCL) is not
    ported yet."""
    raise NotImplementedError(
        "initialize_multihost is not ported yet: ROADMAP.md queue 1 item 8b "
        "(torch.distributed with NCCL across processes and hosts)"
    )


def host_info() -> dict:
    """This process's mesh identity: always single-process here."""
    return {"process_index": 0, "process_count": 1,
            "coordinator_address": None}


def make_mesh(num_shards: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over ``num_shards`` devices (default: every visible
    card). ``devices`` may repeat a device to run logical shards on it.
    More shards than devices raises, as ``gelly_tpu``'s does; nothing
    falls back to the CPU."""
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
    if num_shards is not None:
        if num_shards > len(devs):
            raise ValueError(
                f"requested {num_shards} shards but only {len(devs)} devices"
            )
        devs = devs[:num_shards]
    return Mesh(devs)


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
    ``fn(i, *args_i)`` for every shard ``i`` (each argument a list of S
    per-shard values) and returns the list of S results."""
    def run(*sharded):
        for a in sharded:
            if len(a) != mesh.num_shards:
                raise ValueError(
                    f"sharded argument of {len(a)} shards on a "
                    f"{mesh.num_shards}-shard mesh")
        return [fn(i, *(a[i] for a in sharded))
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
    gets every leaf's row ``i`` on its device."""
    return [tree_map(lambda x, i=i: _to(x[i], d), tree)
            for i, d in enumerate(mesh.devices)]


def device_put_replicated(mesh: Mesh, tree) -> list:
    """One copy of ``tree`` on every shard's device."""
    return [tree_to(tree, d) for d in mesh.devices]
