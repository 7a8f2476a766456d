"""Shared tumbling-window event iterator.

Counterpart of ``gelly_tpu/core/windows.py``: one implementation of the
reference's tumbling time-window semantics (``timeWindow(timeMillis)`` /
``slice``; ascending-timestamp contract with allowedLateness=0), consumed
by the SnapshotStream buffer.

Yields events in stream order:

- ``("edges", window, masked_chunk, n_valid)`` — a chunk masked down to the
  edges of ``window`` (n_valid = host count of live edges in the mask);
- ``("close", window, None, 0)`` — emitted when a later window's first edge
  arrives (windows with no data never fire, Flink semantics) and once at
  end-of-stream for the final partial window.

Late edges (timestamp before the currently open window) are dropped and
counted in ``stats["late_edges"]``. The window logic runs on the host;
each chunk's mask is a ``torch.bool`` tensor on the chunk's device.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from .chunk import EdgeChunk
from .device import to_numpy


def tumbling_window_events(
    chunks: Iterable[EdgeChunk], window_ms: int, stats: dict | None = None,
    allowed_lateness: int = 0,
) -> Iterator[tuple]:
    """Window events of ``chunks`` (see the module docstring).

    ``allowed_lateness > 0`` (the reference's watermark-gated reorder
    buffer) is not ported yet and raises ``NotImplementedError``.
    """
    if allowed_lateness:
        raise NotImplementedError(
            "allowed_lateness > 0 (the watermark reorder buffer) is not "
            "ported to gelly_torch yet: ROADMAP queue 1 item 10"
        )
    if stats is None:
        stats = {}
    stats.setdefault("late_edges", 0)
    current = None
    dirty = False
    for c in chunks:
        ts = to_numpy(c.ts)
        ok = to_numpy(c.valid)
        if not ok.any():
            continue
        tw = ts // window_ms
        if current is not None:
            n_late = int((ok & (tw < current)).sum())
            if n_late:
                stats["late_edges"] += n_late
                ok = ok & (tw >= current)
        for w in np.unique(tw[ok]).tolist():
            if current is None:
                current = w
            if w > current:
                if dirty:
                    yield ("close", current, None, 0)
                    dirty = False
                current = w
            mask = ok & (tw == w)
            m = torch.from_numpy(mask).to(c.valid.device)
            yield ("edges", w, c.mask(m), int(mask.sum()))
            dirty = True
    if dirty:
        yield ("close", current, None, 0)
