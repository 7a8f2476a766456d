"""Background prefetch and an ordered parallel map (host work overlap).

Counterpart of ``gelly_tpu/utils/prefetch.py`` (:func:`prefetch`,
:func:`prefetch_map` and :func:`restartable_prefetch`; pure threading). Host staging for upcoming items
runs on a background thread or a worker pool while the consumer drives
the device with earlier ones. Exceptions re-raise at the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


class _Error:
    """Private out-of-band wrapper: user items can never alias it."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(it: Iterable[T], depth: int = 2,
             name: str = "gelly-prefetch", gauge=None) -> Iterator[T]:
    """Iterate ``it`` on a background thread, ``depth`` items ahead (a
    plain pass-through when depth is 0).

    Cancellation-safe: abandoning the returned generator signals the
    worker, which stops pulling from the source instead of blocking on
    the full queue. ``name`` names the worker thread. ``gauge``
    (optional ``callable(int)``) samples the queue depth after each
    enqueue (the executor wires it to an ``obs`` bus gauge); None costs
    nothing.
    """
    if depth <= 0:
        yield from it
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    cancel = threading.Event()

    def put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
                if gauge is not None:
                    gauge(q.qsize())
        except BaseException as e:  # re-raised at the consumer
            put(_Error(e))
        finally:
            # The consumer needs _DONE to stop, but a consumer that is gone
            # (cancel set) must not leave this thread parked on a full queue.
            while True:
                try:
                    q.put(_DONE, timeout=0.1)
                    break
                except queue.Full:
                    if cancel.is_set():
                        break

    t = threading.Thread(target=worker, daemon=True, name=name)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _Error):
                raise item.exc  # the worker's traceback is kept
            yield item
    finally:
        cancel.set()


def prefetch_map(fn, it: Iterable, depth: int = 2,
                 workers: int = 2,
                 cancel: "threading.Event | None" = None,
                 on_cancel=None, gauge=None) -> Iterator:
    """Apply ``fn`` to up to ``depth`` upcoming items of ``it`` on a pool
    of ``workers`` threads, yielding results in input order (a plain map
    when depth or workers is 0).

    Cancellation-safe: closing or abandoning the generator cancels the
    submitter thread, drains the queue (so a submitter parked on a full
    queue unblocks at once), cancels the drained and queued futures, and
    waits for the items already running, so no worker outlives the
    generator.

    ``cancel`` (optional ``threading.Event``) ends the stream from OUTSIDE
    the consuming thread: a generator can only be closed between items, so
    a consumer parked inside ``__next__`` on a stalled source is reached
    only through the event, which the parked get polls.

    ``on_cancel(item)`` (optional) is called for every item whose ``fn``
    was submitted but never ran because the stream was cancelled: a
    worker may take item i+1 while item i is being cancelled, so work
    that waits on its predecessors (ordered turns) must be told.

    ``gauge`` — the same queue-depth-at-enqueue hook as :func:`prefetch`.
    """
    if depth <= 0 or workers <= 0:
        yield from map(fn, it)
        return
    from concurrent.futures import Future, ThreadPoolExecutor

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    if cancel is None:
        cancel = threading.Event()
    pool = ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix="gelly-codec")

    def submit(item):
        fut = pool.submit(fn, item)
        if on_cancel is not None:
            fut.add_done_callback(
                lambda f: on_cancel(item) if f.cancelled() else None)
        return fut

    def submitter():
        try:
            for item in it:
                fut = submit(item)
                while not cancel.is_set():
                    try:
                        q.put(fut, timeout=0.1)
                        if gauge is not None:
                            gauge(q.qsize())
                        break
                    except queue.Full:
                        continue
                if cancel.is_set():
                    fut.cancel()
                    return
        except BaseException as e:
            while not cancel.is_set():
                try:
                    q.put(_Error(e), timeout=0.1)
                    break
                except queue.Full:
                    continue
        finally:
            while True:
                try:
                    q.put(_DONE, timeout=0.1)
                    break
                except queue.Full:
                    if cancel.is_set():
                        break

    t = threading.Thread(target=submitter, daemon=True,
                         name="gelly-prefetch-submit")
    t.start()
    try:
        while True:
            # Checked every iteration: with a fast source the queue is
            # never empty, and an external cancel must still end the
            # stream.
            if cancel.is_set():
                return
            try:
                got = q.get(timeout=0.1)
            except queue.Empty:
                continue
            if got is _DONE:
                return
            if isinstance(got, _Error):
                raise got.exc  # the submitter's traceback is kept
            yield got.result()  # re-raises fn's exception in order
    finally:
        cancel.set()
        try:
            while True:
                got = q.get_nowait()
                if isinstance(got, Future):
                    got.cancel()
        except queue.Empty:
            pass
        pool.shutdown(wait=True, cancel_futures=True)
        # A submitter parked inside a stalled source's __next__ cannot be
        # interrupted; it is a daemon thread and exits at its next poll.
        t.join(timeout=0.2)


def restartable_prefetch(make_iter, depth: int = 2, *, start: int = 0,
                         max_restarts: int = 3, should_restart=None,
                         position=None, on_restart=None) -> Iterator:
    """Prefetch that survives source/worker failure by reopening the source.

    ``make_iter(i)`` must return a fresh iterator positioned at item ``i``
    (items are numbered from 0; ``start`` is the first index pulled). When
    iteration raises and ``should_restart(exc)`` returns True, the dead
    prefetch pipeline (worker thread included) is torn down and a new one
    opened at the next undelivered index — items already yielded are never
    re-yielded, items that were only sitting in the prefetch queue are
    re-read from the source. After ``max_restarts`` restarts (or a
    non-restartable error) the exception propagates with its original
    traceback.

    ``position`` — optional zero-arg callable reporting the consumer's own
    index of the next item it needs; when given it overrides the internal
    delivered count at restart (the resilient runner's chunk position).
    ``on_restart(exc, index)`` is called before each reopen.
    """
    delivered = start
    restarts = 0
    while True:
        it = None
        while True:
            try:
                # make_iter runs inside the try: an error OPENING the
                # source (seek failure, injected source fault) restarts
                # like any mid-stream error.
                if it is None:
                    it = prefetch(make_iter(delivered), depth)
                item = next(it)
            except StopIteration:
                return
            except BaseException as e:
                restarts += 1
                if (should_restart is not None and not should_restart(e)) \
                        or restarts > max_restarts:
                    raise
                if position is not None:
                    delivered = position()
                if on_restart is not None:
                    on_restart(e, delivered)
                break  # reopen the source at ``delivered``
            # The yield sits OUTSIDE the try: a consumer-side throw (incl.
            # GeneratorExit on close) must propagate, never trigger a
            # source restart.
            yield item
            delivered += 1
