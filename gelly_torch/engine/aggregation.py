"""The summary-aggregation engine of the port, single-device slice.

Counterpart of ``gelly_tpu/engine/aggregation.py``. An algorithm supplies
the reference's plugin contract (``init``, ``fold``, ``combine``,
``transform``, ``transient``) and the engine runs it. This slice runs one
physical plan: **one device, ``merge_every`` windows, raw chunks, the
accumulate plan** (``fold_accumulates`` and not ``transient``) — the plan
``gelly_tpu`` picks for CC on a one-device mesh. Each chunk is staged to
the stream's device and folded into ONE running summary; every
``merge_every`` chunks, and once more at the end of the stream for a
partial window, the engine yields ``transform(summary)``.

Where ``gelly_tpu`` donates the fold state to XLA, the port rebinds it:
the fold returns new tensors and the old ones go back to PyTorch's caching
allocator. An emission is a transform output or a clone, never a view of
live state. The chunk copy is asynchronous (pinned host memory,
``non_blocking``) in a plain in-order loop; the codec workers, the
``h2d_depth`` pipeline, meshes, windows, checkpoints and tracing come with
later slices, and asking for any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch

from ..core.chunk import EdgeChunk

Summary = Any


@dataclasses.dataclass(eq=False)
class SummaryAggregation:
    """The plugin contract (M/SummaryAggregation.java:31-55).

    - ``init(device)`` → fresh summary (NamedTuple of tensors on ``device``).
    - ``fold(summary, chunk)`` → summary: chunk-vectorized edge fold.
    - ``combine(a, b)`` → summary: associative + commutative merge.
    - ``transform(summary)`` → emission (optional).
    - ``transient`` — when True the global summary resets every window.
    - ``merge_stacked`` — optional ``stacked -> summary`` merge of K
      summaries at once (leading axis K).
    - ``flatten`` — optional label-preserving compaction of the summary.
    - ``fold_accumulates`` — declares ``fold(combine(a, b), c) ==
      combine(a, fold(b, c))``: the engine may carry ONE running summary
      across windows (the accumulate plan).
    - ``fold_backend`` — the kernel backend the plan's folds were built for.
    """

    init: Callable[[torch.device], Summary]
    fold: Callable[[Summary, EdgeChunk], Summary]
    combine: Callable[[Summary, Summary], Summary]
    transform: Callable[[Summary], Any] | None = None
    transient: bool = False
    merge_stacked: Callable[[Summary], Summary] | None = None
    flatten: Callable[[Summary], Summary] | None = None
    fold_accumulates: bool = False
    fold_backend: str = "plain"
    name: str = "aggregation"


class SummaryStream:
    """Lazy stream of per-window emissions from a running aggregation.

    Iterating yields ``transform(summary)`` once per closed window (plus
    once at end of stream for a final partial window). ``result()`` drains
    the stream and returns the last emission.
    """

    def __init__(self, gen_fn: Callable[[], Iterator]):
        self._gen_fn = gen_fn

    def __iter__(self):
        return self._gen_fn()

    def result(self):
        last = None
        for last in self:
            pass
        return last


# Knobs of gelly_tpu's run_aggregation this slice does not run, with the
# value that means "off" and the ROADMAP.md item that brings each.
_NOT_YET = {
    "mesh": (None, "queue 1 item 8 (multi-GPU merge)"),
    "window_ms": (None, "queue 1 item 10 (stream API and windows)"),
    "allowed_lateness": (0, "queue 1 item 10 (stream API and windows)"),
    "windowed": (None, "queue 1 item 10 (stream API and windows)"),
    "ttl_panes": (None, "queue 1 item 10 (stream API and windows)"),
    "checkpoint_path": (None, "queue 1 item 6 (durability)"),
    "resume": (False, "queue 1 item 6 (durability)"),
    "prefetch_depth": (None, "queue 1 item 4 (pipelined executor)"),
    "device_fields": (None, "queue 1 item 4 (pipelined executor)"),
    "host_precombine": (None, "queue 1 item 4 (pipelined executor)"),
    "fold_batch": (1, "queue 1 item 4 (pipelined executor)"),
    "ingest_workers": (None, "queue 1 item 4 (pipelined executor)"),
    "codec_workers": (None, "queue 1 item 4 (pipelined executor)"),
    "h2d_depth": (None, "queue 1 item 4 (pipelined executor)"),
    "timer": (None, "queue 1 item 12 (host planes: obs)"),
    "source_provider": (None, "queue 1 item 12 (host planes: ingest)"),
    "precompressed": (False, "queue 1 items 3 and 5 (host codec)"),
    "queries": (None, "queue 1 item 11 (batched engines)"),
}


def _refuse_later_knobs(knobs: dict) -> None:
    for key, value in knobs.items():
        if key not in _NOT_YET:
            raise TypeError(f"run_aggregation() got an unexpected keyword "
                            f"argument {key!r}")
        off, item = _NOT_YET[key]
        if value != off:
            raise NotImplementedError(
                f"run_aggregation({key}=...) is not ported yet: "
                f"ROADMAP.md {item}"
            )


def _fresh(emission):
    """A transform-less emission must not alias live state."""
    if isinstance(emission, torch.Tensor):
        return emission.clone()
    if isinstance(emission, tuple):
        return type(emission)(*(_fresh(e) for e in emission))
    return emission


def run_aggregation(agg: SummaryAggregation, stream,
                    merge_every: int | None = None, **knobs) -> SummaryStream:
    """Execute ``agg`` over ``stream`` on ``stream.ctx.device``.

    ``merge_every`` (chunks, default 1) sets the emit cadence. Every other
    knob of ``gelly_tpu``'s ``run_aggregation`` is accepted by name and
    raises ``NotImplementedError`` (naming its ROADMAP.md item) unless it
    is left at its "off" value.
    """
    _refuse_later_knobs(knobs)
    if merge_every is None:
        merge_every = 1
    if merge_every < 1:
        raise ValueError(f"merge_every must be >= 1, got {merge_every}")
    if not agg.fold_accumulates or agg.transient:
        raise NotImplementedError(
            f"aggregation {agg.name!r} needs the per-window Merger plan "
            "(transient or non-accumulating folds), which is not ported "
            "yet: ROADMAP.md queue 1 item 4"
        )
    device = stream.ctx.device

    def emit(summary):
        if agg.transform is None:
            return _fresh(summary)
        return agg.transform(summary)

    def gen():
        summary = agg.init(device)
        in_window = 0
        for chunk in stream:
            summary = agg.fold(summary, chunk.to(device, non_blocking=True))
            in_window += 1
            if in_window >= merge_every:
                in_window = 0
                yield emit(summary)
        if in_window:
            yield emit(summary)

    return SummaryStream(gen)
