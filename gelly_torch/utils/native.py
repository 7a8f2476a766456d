"""ctypes bindings for the native chunk combiner (the host codecs).

Counterpart of ``gelly_tpu/utils/native.py``, the part the codec plans
call: the spanning-forest combiners (dense, sparse, root-indexed sparse),
the fused unit segment codec (:func:`cc_unit_forest_segments`,
:class:`UnitForestBuilder`), the persistent compact-id table
(:class:`NativeCompactSession`), the parity combiners of the
bipartiteness plan and the degree-delta codecs, all from
``native/chunk_combiner.cc``; the host spanner fold
(:func:`spanner_chunk_fold`, ``native/spanner.cc``) and the greedy
matching fold (:func:`matching_chunk_fold`, ``native/matching.cc``).

The port builds each source itself, at first use, with ``g++ -O3 -shared
-fPIC`` into ``gelly_torch/_build/lib<stem>.so``: the build is
rebuilt when the source is newer, runs under a thread lock and a file lock
(concurrent processes build once), writes to a temporary name that
``os.replace`` moves into place, and never writes into ``native/``. Every
call releases the GIL (ctypes), so codec workers on a thread pool run in
parallel. A missing compiler makes :func:`available` report False and the
codec plans fall back to their numpy codecs.

The resilient runner's hooks are here too, as in ``gelly_tpu``: every
ctypes entry fires the fault hook (``engine/faults.install`` sets it),
:func:`disable` takes a stem out of service process-wide (the degradation
ladder), and :func:`classify_error` / :func:`classify_native` sort an
error into transient or permanent and name the stem it came from.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
import weakref

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "gelly_torch", "_build")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


# Fault-injection hook: ``engine/faults.install`` points this at the active
# plan's "native" boundary (a plain attribute write — utils never imports
# engine). Checked at every ctypes entry point; None when no plan is
# installed.
_fault_hook = None

# Stems disabled at run time (the resilient runner's degradation ladder, or
# an operator override): available() reports them unavailable, so every
# codec probe falls back to the numpy path.
_DISABLED: dict[str, str] = {}


def _inject(stem: str) -> None:
    hook = _fault_hook
    if hook is not None:
        hook(stem)


def disable(stem: str, reason: str = "") -> None:
    """Force ``available(stem)`` False process-wide (numpy fallback)."""
    _AVAILABLE[stem] = False
    _DISABLED[stem] = reason or "disabled"


def reenable(stem: str) -> None:
    """Undo :func:`disable`; the next ``available()`` re-probes."""
    _AVAILABLE.pop(stem, None)
    _DISABLED.pop(stem, None)


def disabled_reason(stem: str) -> str | None:
    return _DISABLED.get(stem)


# Retryable-error classification for the resilient runner: allocation and
# I/O failures are environment pressure (transient — backoff and retry);
# ValueError-class failures are data-dependent (permanent — the same chunk
# will fail the same way forever).
_TRANSIENT_TYPES = (MemoryError, OSError, ConnectionError, TimeoutError)


def classify_error(exc: BaseException) -> str:
    """``"transient"`` (worth retrying with backoff) or ``"permanent"``."""
    return "transient" if isinstance(exc, _TRANSIENT_TYPES) else "permanent"


def classify_native(exc: BaseException) -> str | None:
    """The native component stem an error is attributable to, or None for
    errors that did not originate in a native binding. Errors raised by the
    wrappers here carry a ``.stem`` attribute; injected faults carry their
    boundary."""
    stem = getattr(exc, "stem", None)
    if stem is not None:
        return str(stem)
    if getattr(exc, "boundary", None) == "native":
        return "unknown"
    return None


def _stamp(exc: BaseException, stem: str) -> BaseException:
    """Attach the originating stem so classify_native can attribute it."""
    exc.stem = stem
    return exc


def library_path(stem: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{stem}.so")


def _stale(src: str, so: str) -> bool:
    return not os.path.exists(so) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so)
    )


def _load_lib(stem: str) -> ctypes.CDLL:
    """Compile ``native/<stem>.cc`` into ``gelly_torch/_build/`` (mtime
    fresh, under a lock) and dlopen it."""
    with _lock:
        if stem in _libs:
            return _libs[stem]
        src = os.path.join(NATIVE_DIR, f"{stem}.cc")
        so = library_path(stem)
        if _stale(src, so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(os.path.join(BUILD_DIR, f"lib{stem}.lock"), "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                if _stale(src, so):  # another process may have built it
                    tmp = f"{so}.{os.getpid()}.tmp"
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                        check=True, capture_output=True,
                    )
                    os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _libs[stem] = lib
        return lib


def _load_combiner() -> ctypes.CDLL:
    lib = _load_lib("chunk_combiner")
    if not getattr(lib, "_sigs_set", False):
        lib.cc_chunk_combine.restype = ctypes.c_int
        lib.cc_chunk_combine.argtypes = [
            _i32p, _i32p, _u8p, ctypes.c_int64, ctypes.c_int32, _i32p,
        ]
        # Bound separately (as in gelly_tpu), one flag a codec: a library
        # that predates a symbol only disables the codec that needs it.
        _bind(lib, "_has_sparse_codecs", "cc_chunk_combine_sparse",
              ctypes.c_int64, [_i32p, _i32p, _u8p, ctypes.c_int64,
                               ctypes.c_int32, _i32p, _i32p,
                               ctypes.c_int64])
        _bind(lib, "_has_sparse_idx", "cc_chunk_combine_sparse_idx",
              ctypes.c_int64, [_i32p, _i32p, _u8p, ctypes.c_int64,
                               ctypes.c_int32, _i32p, _i32p, _i32p,
                               ctypes.c_int64])
        try:
            lib.compact_session_create.restype = ctypes.c_void_p
            lib.compact_session_create.argtypes = [ctypes.c_int32]
            lib.compact_session_destroy.restype = None
            lib.compact_session_destroy.argtypes = [ctypes.c_void_p]
            lib.compact_session_reset.restype = None
            lib.compact_session_reset.argtypes = [ctypes.c_void_p]
            lib.compact_session_assigned.restype = ctypes.c_int32
            lib.compact_session_assigned.argtypes = [ctypes.c_void_p]
            lib.compact_session_assign.restype = ctypes.c_int64
            lib.compact_session_assign.argtypes = [
                ctypes.c_void_p, _i32p, ctypes.c_int64, _i32p,
            ]
            lib.compact_session_new_ids.restype = None
            lib.compact_session_new_ids.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, _i32p,
            ]
            lib.compact_session_lookup.restype = ctypes.c_int64
            lib.compact_session_lookup.argtypes = [
                ctypes.c_void_p, _i32p, ctypes.c_int64, _i32p,
            ]
            lib.compact_session_rebuild.restype = ctypes.c_int
            lib.compact_session_rebuild.argtypes = [
                ctypes.c_void_p, _i32p, ctypes.c_int32,
            ]
            lib._has_compact_session = True
        except AttributeError:
            lib._has_compact_session = False
        try:
            lib.cc_unit_forest_segments.restype = ctypes.c_int
            lib.cc_unit_forest_segments.argtypes = [
                _i32p, _i32p, _u8p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int64, _i32p, ctypes.c_int64, _i32p,
                ctypes.c_int64, _i64p,
            ]
            lib.cc_unit_begin.restype = ctypes.c_void_p
            lib.cc_unit_begin.argtypes = []
            lib.cc_unit_destroy.restype = None
            lib.cc_unit_destroy.argtypes = [ctypes.c_void_p]
            lib.cc_unit_members.restype = ctypes.c_int64
            lib.cc_unit_members.argtypes = [ctypes.c_void_p]
            lib.cc_unit_add.restype = ctypes.c_int
            lib.cc_unit_add.argtypes = [
                ctypes.c_void_p, _i32p, _i32p, _u8p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int64,
            ]
            lib.cc_unit_finish.restype = ctypes.c_int
            lib.cc_unit_finish.argtypes = [
                ctypes.c_void_p, _i32p, ctypes.c_int64, _i32p,
                ctypes.c_int64, _i64p,
            ]
            lib._has_unit_segments = True
        except AttributeError:
            lib._has_unit_segments = False
        _bind(lib, "_has_parity_combine", "parity_chunk_combine",
              ctypes.c_int, [_i32p, _i32p, _u8p, ctypes.c_int64,
                             ctypes.c_int32, _i32p, _u8p, _i32p])
        _bind(lib, "_has_degree_deltas", "degree_chunk_deltas",
              ctypes.c_int, [_i32p, _i32p, _i8p, _u8p, ctypes.c_int64,
                             ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                             _i32p])
        _bind(lib, "_has_parity_sparse", "parity_chunk_combine_sparse",
              ctypes.c_int64, [_i32p, _i32p, _u8p, ctypes.c_int64,
                               ctypes.c_int32, _i32p, _i32p, _u8p, _i32p,
                               ctypes.c_int64])
        _bind(lib, "_has_degree_sparse", "degree_chunk_deltas_sparse",
              ctypes.c_int64, [_i32p, _i32p, _i8p, _u8p, ctypes.c_int64,
                               ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32, _i32p, _i32p,
                               ctypes.c_int64])
        lib._sigs_set = True
    return lib


def _bind(lib: ctypes.CDLL, flag: str, name: str, restype, argtypes) -> None:
    """Declare one symbol's signature and set ``lib.<flag>`` to whether
    the library exports it."""
    try:
        fn = getattr(lib, name)
    except AttributeError:
        setattr(lib, flag, False)
        return
    fn.restype = restype
    fn.argtypes = argtypes
    setattr(lib, flag, True)


def _as_i32p(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


_AVAILABLE: dict[str, bool] = {}


def available(stem: str) -> bool:
    """Probe (compile + dlopen + bind) one native component by source
    stem; failures are negative-cached so a missing toolchain does not
    re-run g++ per chunk."""
    if stem not in _AVAILABLE:
        loader = {
            "chunk_combiner": _load_combiner,
            "matching": _load_matching,
            "spanner": _load_spanner,
        }[stem]
        try:
            loader()
            _AVAILABLE[stem] = True
        except (OSError, subprocess.SubprocessError, AttributeError):
            _AVAILABLE[stem] = False
    return _AVAILABLE[stem]


def _exports(flag: str) -> bool:
    """The chunk-combiner library loads AND sets ``flag`` (it exports the
    symbols of one codec)."""
    return available("chunk_combiner") and getattr(
        _load_combiner(), flag, False
    )


def sparse_codecs_available() -> bool:
    """The combiner exports the sparse CC codec."""
    return _exports("_has_sparse_codecs")


def sparse_idx_available() -> bool:
    """The combiner exports the root-indexed sparse codec."""
    return _exports("_has_sparse_idx")


def compact_session_available() -> bool:
    """The combiner exports the persistent compact-id session."""
    return _exports("_has_compact_session")


def unit_segments_available() -> bool:
    """The combiner exports the fused unit-level segment codec."""
    return _exports("_has_unit_segments")


def parity_combine_available() -> bool:
    """The combiner exports the dense parity codec."""
    return _exports("_has_parity_combine")


def degree_deltas_available() -> bool:
    """The combiner exports the dense degree-delta codec."""
    return _exports("_has_degree_deltas")


def parity_sparse_available() -> bool:
    """The combiner exports the sparse parity codec."""
    return _exports("_has_parity_sparse")


def degree_sparse_available() -> bool:
    """The combiner exports the sparse degree-delta codec."""
    return _exports("_has_degree_sparse")


def _valid_ptr(valid):
    """(kept-alive uint8 array, pointer) of an optional valid mask."""
    if valid is None:
        return None, None
    valid = np.ascontiguousarray(valid, np.uint8)
    return valid, valid.ctypes.data_as(_u8p)


def _event_ptr(event):
    """(kept-alive int8 array, pointer) of an optional event column."""
    if event is None:
        return None, None
    event = np.ascontiguousarray(event, np.int8)
    return event, event.ctypes.data_as(_i8p)


def cc_chunk_combine(src: np.ndarray, dst: np.ndarray,
                     valid: np.ndarray | None, n_v: int) -> np.ndarray:
    """Spanning-forest labels i32[n_v] of one chunk; -1 for untouched
    slots (the dense codec)."""
    _inject("chunk_combiner")
    lib = _load_combiner()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    labels = np.empty((n_v,), np.int32)
    valid, vp = _valid_ptr(valid)
    rc = lib.cc_chunk_combine(
        _as_i32p(src), _as_i32p(dst), vp, src.shape[0], n_v, _as_i32p(labels)
    )
    if rc != 0:
        raise _stamp(ValueError(
            f"cc_chunk_combine: vertex slot out of range (rc={rc})"
        ), "chunk_combiner")
    return labels


def _sparse_rc_check(rc: int, fn: str) -> None:
    if rc == -2:
        raise _stamp(ValueError(f"{fn}: vertex slot out of range"),
                     "chunk_combiner")
    if rc == -3:
        raise _stamp(ValueError(f"{fn}: pair capacity overflow"),
                     "chunk_combiner")
    if rc < 0:
        raise _stamp(MemoryError(f"{fn}: allocation failed (rc={rc})"),
                     "chunk_combiner")


def cc_chunk_combine_sparse(src: np.ndarray, dst: np.ndarray,
                            valid: np.ndarray | None, n_v: int):
    """Counted (vertex, root) pairs of one chunk's spanning forest — the
    touched-slot codec. Returns ``(verts i32[t], roots i32[t])``."""
    _inject("chunk_combiner")
    lib = _load_combiner()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    cap = 2 * max(1, src.shape[0])
    out_v = np.empty((cap,), np.int32)
    out_r = np.empty((cap,), np.int32)
    valid, vp = _valid_ptr(valid)
    rc = lib.cc_chunk_combine_sparse(
        _as_i32p(src), _as_i32p(dst), vp, src.shape[0], n_v,
        _as_i32p(out_v), _as_i32p(out_r), cap,
    )
    _sparse_rc_check(rc, "cc_chunk_combine_sparse")
    return out_v[:rc], out_r[:rc]


def cc_chunk_combine_sparse_idx(src: np.ndarray, dst: np.ndarray,
                                valid: np.ndarray | None, n_v: int):
    """Counted (vertex, root, root-index) triples of one chunk's spanning
    forest — the compact pairs wire: ``verts[ri[j]] == roots[j]``."""
    _inject("chunk_combiner")
    lib = _load_combiner()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    cap = 2 * max(1, src.shape[0])
    out_v = np.empty((cap,), np.int32)
    out_r = np.empty((cap,), np.int32)
    out_ri = np.empty((cap,), np.int32)
    valid, vp = _valid_ptr(valid)
    rc = lib.cc_chunk_combine_sparse_idx(
        _as_i32p(src), _as_i32p(dst), vp, src.shape[0], n_v,
        _as_i32p(out_v), _as_i32p(out_r), _as_i32p(out_ri), cap,
    )
    _sparse_rc_check(rc, "cc_chunk_combine_sparse_idx")
    return out_v[:rc], out_r[:rc], out_ri[:rc]


def parity_chunk_combine(src: np.ndarray, dst: np.ndarray,
                         valid: np.ndarray | None, n_v: int):
    """``(labels i32[n_v], parity u8[n_v], conflict bool)`` of one chunk:
    its spanning forest, each touched slot's 2-coloring parity relative to
    its root, and whether the chunk alone holds an odd cycle."""
    _inject("chunk_combiner")
    lib = _load_combiner()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    labels = np.empty((n_v,), np.int32)
    parity = np.empty((n_v,), np.uint8)
    conflict = ctypes.c_int32(0)
    valid, vp = _valid_ptr(valid)
    rc = lib.parity_chunk_combine(
        _as_i32p(src), _as_i32p(dst), vp, src.shape[0], n_v,
        _as_i32p(labels), parity.ctypes.data_as(_u8p), ctypes.byref(conflict),
    )
    if rc != 0:
        raise _stamp(ValueError(
            f"parity_chunk_combine: vertex slot out of range (rc={rc})"
        ), "chunk_combiner")
    return labels, parity, bool(conflict.value)


def parity_chunk_combine_sparse(src: np.ndarray, dst: np.ndarray,
                                valid: np.ndarray | None, n_v: int):
    """Counted (vertex, root, parity) triples + the chunk's odd-cycle flag.
    Returns ``(verts i32[t], roots i32[t], parity u8[t], conflict bool)``."""
    _inject("chunk_combiner")
    lib = _load_combiner()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    cap = 2 * max(1, src.shape[0])
    out_v = np.empty((cap,), np.int32)
    out_r = np.empty((cap,), np.int32)
    out_p = np.empty((cap,), np.uint8)
    conflict = ctypes.c_int32(0)
    valid, vp = _valid_ptr(valid)
    rc = lib.parity_chunk_combine_sparse(
        _as_i32p(src), _as_i32p(dst), vp, src.shape[0], n_v,
        _as_i32p(out_v), _as_i32p(out_r), out_p.ctypes.data_as(_u8p),
        ctypes.byref(conflict), cap,
    )
    _sparse_rc_check(rc, "parity_chunk_combine_sparse")
    return out_v[:rc], out_r[:rc], out_p[:rc], bool(conflict.value)


def degree_chunk_deltas(src: np.ndarray, dst: np.ndarray,
                        event: np.ndarray | None, valid: np.ndarray | None,
                        n_v: int, count_out: bool = True,
                        count_in: bool = True) -> np.ndarray:
    """Dense ±1 endpoint-degree delta vector i32[n_v] of one chunk.
    ``event`` (i8, 1 = deletion) and ``valid`` may be None (all additions /
    all valid)."""
    _inject("chunk_combiner")
    lib = _load_combiner()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    out = np.empty((n_v,), np.int32)
    event, ep = _event_ptr(event)
    valid, vp = _valid_ptr(valid)
    rc = lib.degree_chunk_deltas(
        _as_i32p(src), _as_i32p(dst), ep, vp, src.shape[0], n_v,
        int(count_out), int(count_in), _as_i32p(out),
    )
    if rc != 0:
        raise _stamp(ValueError(
            f"degree_chunk_deltas: vertex slot out of range (rc={rc})"
        ), "chunk_combiner")
    return out


def degree_chunk_deltas_sparse(src: np.ndarray, dst: np.ndarray,
                               event: np.ndarray | None,
                               valid: np.ndarray | None, n_v: int,
                               count_out: bool = True,
                               count_in: bool = True):
    """Counted (vertex, net-delta) pairs of one chunk, zero nets omitted.
    Returns ``(verts i32[t], deltas i32[t])``."""
    _inject("chunk_combiner")
    lib = _load_combiner()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    cap = 2 * max(1, src.shape[0])
    out_v = np.empty((cap,), np.int32)
    out_d = np.empty((cap,), np.int32)
    event, ep = _event_ptr(event)
    valid, vp = _valid_ptr(valid)
    rc = lib.degree_chunk_deltas_sparse(
        _as_i32p(src), _as_i32p(dst), ep, vp, src.shape[0], n_v,
        int(count_out), int(count_in), _as_i32p(out_v), _as_i32p(out_d), cap,
    )
    _sparse_rc_check(rc, "degree_chunk_deltas_sparse")
    return out_v[:rc], out_d[:rc]


def cc_unit_forest_segments(src: np.ndarray, dst: np.ndarray,
                            valid: np.ndarray | None, n_v: int,
                            block: int = 1 << 16):
    """Segment-format spanning forest of one merge-window unit. Returns
    ``(members i32[t], lengths i32[s])``: members grouped by component,
    each component's ROOT first in its segment."""
    _inject("chunk_combiner")
    lib = _load_combiner()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    cap = 2 * max(1, src.shape[0])
    out_v = np.empty((cap,), np.int32)
    out_len = np.empty((cap,), np.int32)
    counts = np.zeros((2,), np.int64)
    valid, vp = _valid_ptr(valid)
    rc = lib.cc_unit_forest_segments(
        _as_i32p(src), _as_i32p(dst), vp, src.shape[0], n_v, block,
        _as_i32p(out_v), cap, _as_i32p(out_len), cap,
        counts.ctypes.data_as(_i64p),
    )
    _sparse_rc_check(rc, "cc_unit_forest_segments")
    return out_v[: counts[0]], out_len[: counts[1]]


class UnitForestBuilder:
    """Streaming form of :func:`cc_unit_forest_segments`: ``add`` each
    chunk's buffers as they arrive (no host concatenation of the unit's
    edges), then ``finish`` sizes the output exactly from the interned
    member count. One builder per unit; not thread-safe."""

    def __init__(self, n_v: int, block: int = 1 << 18):
        self._lib = _load_combiner()
        self._n_v = int(n_v)
        self._block = int(block)
        self._h = self._lib.cc_unit_begin()
        if not self._h:
            raise _stamp(MemoryError("cc_unit_begin failed"),
                         "chunk_combiner")
        # weakref.finalize runs at most once and before module teardown.
        self._finalize = weakref.finalize(
            self, self._lib.cc_unit_destroy, self._h
        )

    def add(self, src: np.ndarray, dst: np.ndarray,
            valid: np.ndarray | None) -> None:
        if not self._h:
            raise RuntimeError(
                "UnitForestBuilder already finished; create a new one"
            )
        src = np.ascontiguousarray(src, np.int32)
        dst = np.ascontiguousarray(dst, np.int32)
        valid, vp = _valid_ptr(valid)
        rc = self._lib.cc_unit_add(
            self._h, _as_i32p(src), _as_i32p(dst), vp, src.shape[0],
            self._n_v, self._block,
        )
        _sparse_rc_check(rc, "cc_unit_add")

    def finish(self):
        """(members, lengths) — root-first segment format; consumes the
        builder."""
        if not self._h:
            raise RuntimeError(
                "UnitForestBuilder already finished; create a new one"
            )
        count = int(self._lib.cc_unit_members(self._h))
        out_v = np.empty((count,), np.int32)
        out_len = np.empty((count,), np.int32)
        counts = np.zeros((2,), np.int64)
        rc = self._lib.cc_unit_finish(
            self._h, _as_i32p(out_v), count, _as_i32p(out_len), count,
            counts.ctypes.data_as(_i64p),
        )
        _sparse_rc_check(rc, "cc_unit_finish")
        self._finalize()  # destroys the handle now; idempotent thereafter
        self._h = None
        return out_v[: counts[0]], out_len[: counts[1]]


class NativeCompactSession:
    """Handle over the native open-addressing id -> cid table: one hash
    probe per id, O(1) amortized insert. Not internally locked; the
    caller (:class:`~gelly_torch.ops.compact_space.CompactIdSession`)
    serializes access."""

    def __init__(self, capacity: int):
        self._lib = _load_combiner()
        self._capacity = int(capacity)
        self._h = self._lib.compact_session_create(self._capacity)
        if not self._h:
            raise _stamp(MemoryError("compact_session_create failed"),
                         "chunk_combiner")
        self._finalize = weakref.finalize(
            self, self._lib.compact_session_destroy, self._h
        )

    def _handle(self):
        if not self._h:
            raise RuntimeError(
                "compact session discarded after a native allocation "
                "failure; create a new session"
            )
        return self._h

    def _poison(self):
        """Destroy the handle after a native -4: the table may alias
        dropped cids, so the session must not be reused."""
        self._finalize()
        self._h = None

    def reset(self) -> None:
        self._lib.compact_session_reset(self._handle())

    @property
    def assigned(self) -> int:
        return int(self._lib.compact_session_assigned(self._handle()))

    def assign(self, ids: np.ndarray):
        """(cids, new_ids, base) — fresh ids get cids in first-seen ARRAY
        order. Returns base=-1 on capacity overflow (session unchanged).
        Negative ids raise ValueError."""
        ids = np.ascontiguousarray(ids, np.int32)
        if ids.size and int(ids.min()) < 0:
            raise ValueError(
                "compact_session_assign: negative vertex ids "
                f"(min={int(ids.min())})"
            )
        out = np.empty(ids.shape[0], np.int32)
        base = self._lib.compact_session_assign(
            self._handle(), _as_i32p(ids), ids.shape[0], _as_i32p(out)
        )
        if base == -4:
            self._poison()
            raise _stamp(
                MemoryError("compact_session_assign: allocation failed"),
                "chunk_combiner",
            )
        if base == -2:
            raise ValueError("compact_session_assign: negative vertex id")
        if base < 0:
            return None, None, -1
        top = self.assigned
        new_ids = np.empty(top - base, np.int32)
        if top > base:
            self._lib.compact_session_new_ids(
                self._h, base, top, _as_i32p(new_ids)
            )
        return out, new_ids, int(base)

    def lookup(self, ids: np.ndarray):
        """(cids, n_unknown) — unknown ids get cid -1."""
        ids = np.ascontiguousarray(ids, np.int32)
        out = np.empty(ids.shape[0], np.int32)
        bad = self._lib.compact_session_lookup(
            self._handle(), _as_i32p(ids), ids.shape[0], _as_i32p(out)
        )
        return out, int(bad)

    def rebuild(self, vertex_of: np.ndarray) -> None:
        vertex_of = np.ascontiguousarray(vertex_of, np.int32)
        rc = self._lib.compact_session_rebuild(
            self._handle(), _as_i32p(vertex_of), vertex_of.shape[0]
        )
        if rc == -1:
            raise ValueError(
                f"compact_session_rebuild: checkpoint holds "
                f"{vertex_of.shape[0]} cids but session capacity is "
                f"{self._capacity}; resume with compact_capacity >= "
                f"{vertex_of.shape[0]}"
            )
        if rc != 0:
            self._poison()
            raise _stamp(
                MemoryError("compact_session_rebuild: allocation failed"),
                "chunk_combiner",
            )


def _load_spanner() -> ctypes.CDLL:
    lib = _load_lib("spanner")
    if not getattr(lib, "_sigs_set", False):
        lib.spanner_chunk_fold.restype = ctypes.c_int
        lib.spanner_chunk_fold.argtypes = [
            _i32p, _i32p, _u8p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            _i32p, _i32p, _i32p, _i64p,
            _i32p, _i32p, ctypes.c_int64,
        ]
        lib._sigs_set = True
    return lib


def spanner_chunk_fold(src: np.ndarray, dst: np.ndarray,
                       valid: np.ndarray | None, n_v: int, k: int,
                       max_degree: int, nbr: np.ndarray, deg: np.ndarray,
                       stamp: np.ndarray, meta: np.ndarray,
                       out_src: np.ndarray, out_dst: np.ndarray) -> None:
    """Fold one chunk into the host spanner state, in stream order.

    ``nbr`` (i32[n_v, max_degree]), ``deg``/``stamp`` (i32[n_v]) and
    ``meta`` (i64[3]: stamp counter, accepted count, degree overflows) are
    mutated in place; accepted edges append to ``out_src``/``out_dst`` at
    ``meta[1]``. Raises on slot range errors or output-list overflow.
    ctypes releases the GIL during the call.
    """
    _inject("spanner")
    lib = _load_spanner()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    valid, vp = _valid_ptr(valid)
    for a, dt in ((nbr, np.int32), (deg, np.int32), (stamp, np.int32),
                  (meta, np.int64), (out_src, np.int32),
                  (out_dst, np.int32)):
        assert a.dtype == dt and a.flags.c_contiguous
    rc = lib.spanner_chunk_fold(
        _as_i32p(src), _as_i32p(dst), vp, src.shape[0], n_v, k, max_degree,
        _as_i32p(nbr), _as_i32p(deg), _as_i32p(stamp),
        meta.ctypes.data_as(_i64p),
        _as_i32p(out_src), _as_i32p(out_dst), out_src.shape[0],
    )
    if rc == 3:
        raise _stamp(ValueError(
            "spanner edge list overflowed; raise max_edges"
        ), "spanner")
    if rc != 0:
        raise _stamp(
            ValueError(f"spanner_chunk_fold: bad vertex slot (rc={rc})"),
            "spanner",
        )


def _load_matching() -> ctypes.CDLL:
    lib = _load_lib("matching")
    if not getattr(lib, "_sigs_set", False):
        lib.matching_chunk_fold.restype = ctypes.c_int
        lib.matching_chunk_fold.argtypes = [
            _i32p, _i32p, _f64p, _u8p, ctypes.c_int64, ctypes.c_int32,
            _i32p, _f64p,
            _u8p, _i32p, _i32p, _f64p, ctypes.c_int64, _i64p,
        ]
        lib._sigs_set = True
    return lib


def matching_chunk_fold(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                        valid: np.ndarray | None, n_v: int,
                        partner: np.ndarray, weight: np.ndarray,
                        want_events: bool = False):
    """Fold one chunk into the greedy-matching state, in stream order.

    ``partner`` (i32[n_v], C-contiguous) and ``weight`` (f64[n_v]) are
    mutated in place. With ``want_events`` returns the chunk's ordered
    event records ``(types u8[k], a i32[k], b i32[k], w f64[k])`` where
    type 0 = ADD, 1 = REMOVE; otherwise returns None. ctypes releases the
    GIL during the call.
    """
    _inject("matching")
    lib = _load_matching()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    w = np.ascontiguousarray(w, np.float64)
    assert partner.dtype == np.int32 and partner.flags.c_contiguous
    assert weight.dtype == np.float64 and weight.flags.c_contiguous
    valid, vp = _valid_ptr(valid)
    n = src.shape[0]
    if want_events:
        cap = 3 * n
        ev_type = np.empty((cap,), np.uint8)
        ev_a = np.empty((cap,), np.int32)
        ev_b = np.empty((cap,), np.int32)
        ev_w = np.empty((cap,), np.float64)
        ev_args = (
            ev_type.ctypes.data_as(_u8p), _as_i32p(ev_a), _as_i32p(ev_b),
            ev_w.ctypes.data_as(_f64p),
        )
    else:
        ev_args = (None, None, None, None)
        cap = 0
    count = ctypes.c_int64(0)
    rc = lib.matching_chunk_fold(
        _as_i32p(src), _as_i32p(dst), w.ctypes.data_as(_f64p), vp, n,
        n_v, _as_i32p(partner), weight.ctypes.data_as(_f64p),
        *ev_args, cap, ctypes.byref(count),
    )
    if rc == 3:
        raise _stamp(
            ValueError("matching_chunk_fold: event buffer overflow"),
            "matching",
        )
    if rc != 0:
        raise _stamp(
            ValueError(f"matching_chunk_fold: bad vertex slot (rc={rc})"),
            "matching",
        )
    if want_events:
        k = count.value
        return ev_type[:k], ev_a[:k], ev_b[:k], ev_w[:k]
    return None
