"""Iterative Connected Components — the feedback-loop pattern.

Counterpart of ``gelly_tpu/library/iterative_cc.py``
(``M/example/IterativeConnectedComponents.java:43-229``): a per-chunk
min-label-propagation fixpoint scatters each edge's minimum endpoint label
to both endpoints, then chases label pointers, until no label changes.
Each round reads the previous round's labels (Jacobi rounds, as
``gelly_tpu``'s ``while_loop``), and each round's exit test is one counted
:func:`~gelly_torch.ops.unionfind.host_sync`. Final labels: the minimum
slot of each component, ``-1`` where a slot was never seen.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..core.stream import Update
from ..ops import segments
from ..ops.unionfind import host_sync

_FIELDS = ("src", "dst", "valid")


def _propagate(labels: torch.Tensor, seen: torch.Tensor, chunk):
    """One chunk's fixpoint: ``(labels, seen)`` after it."""
    src, dst, ok = chunk.src, chunk.dst, chunk.valid
    seen = segments.mark_seen(seen, src, ok)
    seen = segments.mark_seen(seen, dst, ok)
    si, di = src.long(), dst.long()
    lab = labels
    while True:
        m = torch.minimum(lab[si], lab[di])
        lab2 = segments.masked_scatter_min(lab, src, m, ok)
        lab2 = segments.masked_scatter_min(lab2, dst, m, ok)
        # Label-pointer chase: lab[x] = y asserts x ~ y, so folding in
        # lab[lab] relabels members of components merged by EARLIER
        # chunks.
        lab2 = torch.minimum(lab2, lab2[lab2.long()])
        changed = host_sync((lab2 != lab).any())
        lab = lab2
        if not changed:
            return lab, seen


class IterativeCCStream:
    """Per-chunk (vertex, label) updates; labels improve monotonically as
    more edges arrive."""

    def __init__(self, stream):
        self.stream = stream

    def _fresh(self):
        n = self.stream.ctx.vertex_capacity
        dev = self.stream.ctx.device
        return (torch.arange(n, dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev))

    def __iter__(self) -> Iterator[Update]:
        labels, seen = self._fresh()
        for c in self.stream.device_chunks(_FIELDS):
            labels, seen = _propagate(labels, seen, c)
            ids = torch.cat([c.src, c.dst])
            ok = torch.cat([c.valid, c.valid])
            yield Update(ids, labels[ids.long()], ok)

    def final_labels(self) -> torch.Tensor:
        lab, seen = self._fresh()
        for c in self.stream.device_chunks(_FIELDS):
            lab, seen = _propagate(lab, seen, c)
        return torch.where(seen, lab, -1)
