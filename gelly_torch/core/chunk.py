"""Fixed-capacity COO edge chunks — the unit of streaming.

Counterpart of ``gelly_tpu/core/chunk.py``. The stream is a sequence of
:class:`EdgeChunk`: a fixed-capacity struct of tensors holding up to
``capacity`` edges, padded with an invalid mask, so every fold works on
whole batches instead of one edge at a time.

Each edge carries two id representations:

- ``raw_src`` / ``raw_dst``: the external vertex ids at their source integer
  width (up to 64-bit);
- ``src`` / ``dst``: dense ``i32`` slots assigned by a
  :class:`~gelly_torch.core.vertices.VertexTable` at ingest; all summary
  kernels index fixed-shape state tensors with these.

Sources build chunks on the host (CPU tensors that view the source's numpy
arrays where the dtype already fits); the engine moves each chunk to the
stream's device with :meth:`EdgeChunk.to` just before the fold.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device

# Event types, mirroring the reference's EventType enum.
EDGE_ADDITION = np.int8(0)
EDGE_DELETION = np.int8(1)


class EdgeChunk(NamedTuple):
    """A fixed-capacity batch of edges in structure-of-arrays COO layout.

    - ``src``, ``dst``: ``i32[C]`` dense vertex slots (padding entries are 0).
    - ``raw_src``, ``raw_dst``: external vertex ids at their source width.
    - ``val``: ``EV[C]`` or ``EV[C, k]`` edge values (default ``f32`` ones).
    - ``ts``: ``i64[C]`` timestamps (ms).
    - ``event``: ``i8[C]`` — 0 = addition, 1 = deletion.
    - ``valid``: ``bool[C]`` — mask of live edges; everything else is padding.
    """

    src: torch.Tensor
    dst: torch.Tensor
    raw_src: torch.Tensor
    raw_dst: torch.Tensor
    val: torch.Tensor
    ts: torch.Tensor
    event: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.src.shape[0]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def reverse(self) -> "EdgeChunk":
        """Swap src/dst (GraphStream.reverse)."""
        return self._replace(
            src=self.dst, dst=self.src, raw_src=self.raw_dst, raw_dst=self.raw_src
        )

    def undirected(self) -> "EdgeChunk":
        """Emit each edge in both directions (GraphStream.undirected).

        Doubles the chunk capacity: the result holds ``e`` followed by
        ``e.reverse()``.
        """
        return concat_chunks(self, self.reverse())

    def mask(self, keep) -> "EdgeChunk":
        """Return the chunk with ``valid &= keep`` (filter without moving data)."""
        return self._replace(valid=self.valid & keep)

    def is_host(self) -> bool:
        return self.src.device.type == "cpu"

    def to(self, device, non_blocking: bool = True) -> "EdgeChunk":
        """Copy every field to ``device``. Host fields bound for a CUDA
        device are pinned first, so the copies run asynchronously on the
        current stream (the caching host allocator keeps the pinned
        buffers alive until their copies finish)."""
        return self.to_fields(device, self._fields, non_blocking)

    def to_fields(self, device, fields, non_blocking: bool = True
                  ) -> "EdgeChunk":
        """:meth:`to` for the named ``fields`` only; the others stay where
        they are (a step copies only what it reads)."""
        dev = torch.device(device)
        pin = dev.type == "cuda"

        def move(t: torch.Tensor) -> torch.Tensor:
            if t.device == dev:
                return t
            if pin and t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(dev, non_blocking=non_blocking)

        return self._replace(**{f: move(getattr(self, f)) for f in fields})

    def to_numpy(self) -> "EdgeChunk":
        return EdgeChunk(*(f.detach().cpu().numpy() for f in self))

    def compact_edges(self, raw: bool = True):
        """Host-side: drop padding, return (src, dst, val) of the valid edges."""
        c = self.to_numpy()
        m = c.valid.astype(bool)
        if raw:
            return c.raw_src[m], c.raw_dst[m], c.val[m]
        return c.src[m], c.dst[m], c.val[m]


def _tensor(a: np.ndarray) -> torch.Tensor:
    # torch.from_numpy shares memory with the array; a read-only array
    # (e.g. a broadcast or a frozen buffer) is copied instead of aliased
    # writable.
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(np.ascontiguousarray(a))


def make_chunk(
    src,
    dst,
    raw_src=None,
    raw_dst=None,
    val=None,
    ts=None,
    event=None,
    capacity: int | None = None,
    val_dtype=np.float32,
    device: str | torch.device | None = "cuda",
) -> EdgeChunk:
    """Build a padded :class:`EdgeChunk` from host arrays.

    ``capacity`` defaults to ``len(src)``; when larger, the tail is padding
    with ``valid=False``. Padding slots use vertex 0 / value 0 and are never
    observed by kernels, which must respect ``valid``. ``raw_src``/``raw_dst``
    default to the slot values (identity densification).

    ``device=None`` keeps the fields as CPU tensors that share memory with
    the caller's arrays where no padding or dtype conversion is needed — the
    mode ingest sources use (the engine moves chunks to the stream's
    device). A device name moves the chunk there (the default, CUDA, raises
    on a machine without a card).

    No-mutation contract (as in ``gelly_tpu``): a host chunk may ALIAS the
    caller's arrays, so a source must not reuse or mutate its input buffers
    after yielding a chunk built from them.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    n = src.shape[0]
    if dst.shape[0] != n:
        raise ValueError(f"src/dst length mismatch: {n} vs {dst.shape[0]}")
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < number of edges {n}")

    def pad(a, dtype):
        dtype = np.dtype(dtype)
        a = np.asarray(a).astype(dtype, copy=False)
        if a.shape[0] == cap:
            return a
        out = np.zeros((cap,) + a.shape[1:], dtype=dtype)
        out[:n] = a
        return out

    raw_src = src if raw_src is None else np.asarray(raw_src)
    raw_dst = dst if raw_dst is None else np.asarray(raw_dst)

    def _int_width(a):
        return a.dtype if np.issubdtype(a.dtype, np.integer) else np.int64

    # Raw ids keep their source integer width; both fields share the
    # promoted width so a wider raw_dst never truncates.
    raw_dtype = np.promote_types(_int_width(raw_src), _int_width(raw_dst))
    if val is None:
        val = np.ones((n,), dtype=np.dtype(val_dtype))
    ts = np.arange(n, dtype=np.int64) if ts is None else ts
    event = np.zeros((n,), np.int8) if event is None else event
    valid = np.zeros((cap,), dtype=bool)
    valid[:n] = True
    chunk = EdgeChunk(
        src=_tensor(pad(src, np.int32)),
        dst=_tensor(pad(dst, np.int32)),
        raw_src=_tensor(pad(raw_src, raw_dtype)),
        raw_dst=_tensor(pad(raw_dst, raw_dtype)),
        val=_tensor(pad(val, np.dtype(val_dtype))),
        ts=_tensor(pad(ts, np.int64)),
        event=_tensor(pad(event, np.int8)),
        valid=torch.from_numpy(valid),
    )
    if device is None:
        return chunk
    return chunk.to(resolve_device(device))


def empty_chunk(capacity: int, val_dtype=torch.float32, val_shape=(),
                device: str | torch.device = "cuda") -> EdgeChunk:
    dev = resolve_device(device)

    def z(dtype, shape=()):
        return torch.zeros((capacity,) + tuple(shape), dtype=dtype, device=dev)

    return EdgeChunk(
        src=z(torch.int32),
        dst=z(torch.int32),
        raw_src=z(torch.int64),
        raw_dst=z(torch.int64),
        val=z(val_dtype, val_shape),
        ts=z(torch.int64),
        event=z(torch.int8),
        valid=z(torch.bool),
    )


def concat_chunks(a: EdgeChunk, b: EdgeChunk) -> EdgeChunk:
    """Concatenate along the edge axis (capacity = a.capacity +
    b.capacity). Both stay where they are when they share a device; a host
    chunk joins a device one on that device."""
    dev = a.src.device if not a.is_host() else b.src.device
    return EdgeChunk(*(torch.cat([x.to(dev), y.to(dev)])
                       for x, y in zip(a, b)))


def split_chunk_host(chunk: EdgeChunk, parts: int) -> list[EdgeChunk]:
    """Split a HOST chunk into ``parts`` contiguous slices along the edge
    axis, padding the tail with zero (invalid) lanes when the capacity is
    not divisible: the host-side form of ``parallel.partition.split_chunk``
    for staging paths that compress before the copy to the device (the
    mesh's event-time codec). Slices are views where no padding is
    needed."""
    n = chunk.src.shape[0]
    per = -(-max(n, parts) // parts)
    pad = per * parts - n

    def prep(a: torch.Tensor) -> torch.Tensor:
        a = a.cpu()
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        return a

    fields = [prep(f) for f in chunk]
    return [EdgeChunk(*(f[s * per:(s + 1) * per] for f in fields))
            for s in range(parts)]
