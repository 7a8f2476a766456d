"""Greedy ½-approximation weighted matching (centralized stage).

Counterpart of ``gelly_tpu/library/matching.py``
(``M/example/CentralizedWeightedMatching.java:36-113``): a new edge evicts
its colliding matched edges iff its weight exceeds twice their combined
weight. The matching lives in ``partner`` (``i32[N]``, -1 unmatched) and
``weight`` (stored at both endpoints). The default host path folds each
chunk in f64 (the reference's Java doubles) through the native
``matching_chunk_fold`` (``native/matching.cc``), with a Python loop as
the fallback; ``device=True`` keeps the state on the stream's device in
f32 and folds each chunk with the hand kernel ``csrc/matching_step.cu``
(its plain version on the CPU), bit for bit ``gelly_tpu``'s
``_matching_step``. The two precisions can disagree only where a
challenger's weight falls between the f32 and f64 roundings of the
doubled colliding weight.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..core.device import to_numpy
from ..ops import kernels


class MatchingState(NamedTuple):
    partner: object  # i32[N], -1 unmatched (numpy on the host path)
    weight: object  # f64[N] on the host path, f32[N] on the device path


class MatchingEvent(NamedTuple):
    """ADD/REMOVE event — the reference's observable output
    (M/util/MatchingEvent.java:24-42)."""

    type: str  # "ADD" | "REMOVE"
    src: int  # raw vertex ids
    dst: int
    weight: float


def _matching_step(state: MatchingState, chunk) -> MatchingState:
    """The device fold of one chunk (f32): the matching kernel on a CUDA
    state, its plain version on a CPU one. Returns a new state."""
    dev = state.partner.device
    c = chunk.to_fields(dev, ("src", "dst", "val", "valid"))
    w = c.val.to(torch.float32)
    return MatchingState(*kernels.matching_step(
        state.partner, state.weight, c.src.to(torch.int32).contiguous(),
        c.dst.to(torch.int32).contiguous(), w.contiguous(),
        c.valid.contiguous()))


_NATIVE = None  # test hook: False forces the Python fallback


def _native_ok() -> bool:
    if _NATIVE is not None:
        return _NATIVE
    from ..utils import native

    return native.available("matching")


def _matching_step_host(state: MatchingState, chunk,
                        events: list | None = None) -> MatchingState:
    """Host per-edge fold over the chunk's valid edges (f64), the default
    path: the native C++ fold when the toolchain is available, this
    Python loop otherwise. With ``events``, appends the chunk's ADD and
    REMOVE events (slot ids)."""
    partner = np.asarray(state.partner).copy()
    weight = np.asarray(state.weight).copy()
    src = to_numpy(chunk.src)
    dst = to_numpy(chunk.dst)
    val = to_numpy(chunk.val)
    valid = to_numpy(chunk.valid)
    if _native_ok():
        from ..utils.native import matching_chunk_fold

        out = matching_chunk_fold(
            src, dst, val, valid, partner.shape[0], partner, weight,
            want_events=events is not None,
        )
        if events is not None:
            types, a, b, w = out
            for t, x, y, wt in zip(
                types.tolist(), a.tolist(), b.tolist(), w.tolist()
            ):
                events.append(MatchingEvent(
                    "ADD" if t == 0 else "REMOVE", x, y, wt
                ))
        return MatchingState(partner, weight)
    m = valid.astype(bool)
    for u, v, w in zip(src[m].tolist(), dst[m].tolist(), val[m].tolist()):
        if u == v:
            continue
        pu, pv = int(partner[u]), int(partner[v])
        same = pu == v and pv == u  # colliding edge is (u, v) itself
        if same:
            coll_sum = weight[u]
        else:
            coll_sum = (weight[u] if pu >= 0 else 0.0) + (
                weight[v] if pv >= 0 else 0.0
            )
        if w > 2.0 * coll_sum:
            evict = ((u, pu),) if same else ((u, pu), (v, pv))
            for x, px in evict:
                if px >= 0:
                    if events is not None:
                        events.append(MatchingEvent(
                            "REMOVE", x, px, float(weight[x])
                        ))
                    partner[px] = -1
                    weight[px] = 0.0
                    partner[x] = -1
                    weight[x] = 0.0
            partner[u], partner[v] = v, u
            weight[u] = weight[v] = w
            if events is not None:
                events.append(MatchingEvent("ADD", u, v, float(w)))
    return MatchingState(partner, weight)


def _host_state(n: int) -> MatchingState:
    return MatchingState(partner=np.full((n,), -1, np.int32),
                         weight=np.zeros((n,), np.float64))


class WeightedMatchingStream:
    """Iterate for per-chunk states; ``final_matching`` returns the matched
    raw-id edge set and ``total_weight`` its weight."""

    def __init__(self, stream, device: bool = False):
        self.stream = stream
        self.device = device

    def __iter__(self) -> Iterator[MatchingState]:
        ctx = self.stream.ctx
        n = ctx.vertex_capacity
        if self.device:
            state = MatchingState(
                partner=torch.full((n,), -1, dtype=torch.int32,
                                   device=ctx.device),
                weight=torch.zeros(n, dtype=torch.float32,
                                   device=ctx.device),
            )
            for c in self.stream:
                state = _matching_step(state, c)
                yield state
            return
        state = _host_state(n)
        for c in self.stream:
            state = _matching_step_host(state, c)
            yield state

    def events(self) -> Iterator[MatchingEvent]:
        """ADD/REMOVE event stream with raw vertex ids (the reference's
        collector output). Host path only: a ``device=True`` stream uses
        ``final()``/``final_matching()``."""
        if self.device:
            raise NotImplementedError(
                "events() is host-path only; use device=False"
            )
        ctx = self.stream.ctx
        state = _host_state(ctx.vertex_capacity)
        for c in self.stream:
            evs: list = []
            state = _matching_step_host(state, c, evs)
            if evs:
                flat = np.array([x for e in evs for x in (e.src, e.dst)])
                raw = ctx.decode(flat).tolist()
                for i, e in enumerate(evs):
                    yield MatchingEvent(
                        e.type, raw[2 * i], raw[2 * i + 1], e.weight
                    )
        # A full drain just happened: cache it.
        self._final = state
        self._drained = True

    def final(self) -> MatchingState:
        if not getattr(self, "_drained", False):
            state = None
            for state in self:
                pass
            if state is None:  # empty stream
                state = _host_state(self.stream.ctx.vertex_capacity)
            self._final = state
            self._drained = True
        return self._final

    def final_matching(self) -> list[tuple[int, int, float]]:
        state = self.final()
        ctx = self.stream.ctx
        partner = to_numpy(state.partner)
        weight = to_numpy(state.weight)
        out = []
        for u in np.nonzero(partner >= 0)[0].tolist():
            v = int(partner[u])
            if u < v:  # each matched pair once
                ru, rv = ctx.decode(np.array([u, v])).tolist()
                out.append((min(ru, rv), max(ru, rv), float(weight[u])))
        return sorted(out)

    def total_weight(self) -> float:
        return sum(w for _, _, w in self.final_matching())


def weighted_matching(stream, device: bool = False) -> WeightedMatchingStream:
    return WeightedMatchingStream(stream, device=device)
