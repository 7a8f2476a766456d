"""Checkpoint / resume of summary state.

Counterpart of ``gelly_tpu/engine/checkpoint.py``, with the same on-disk
format, so a checkpoint written by either package loads in the other. The
reference's only checkpoint hook is ``Merger implements
ListCheckpointed`` (``M/SummaryAggregation.java:127-135``): the summary
*is* the checkpoint payload. A checkpoint is the device→host snapshot of
the summary tree plus the stream position (chunks consumed), written
atomically and durably; resume reloads the leaves onto the template's
device and continues folding from that position.

Format: an uncompressed ``.npz`` holding ``__header__`` (UTF-8 JSON:
``version``, ``treedef``, ``num_leaves``, ``position``, ``meta``,
``crc32``) and ``leaf_<i>`` arrays, no pickle. Leaves are numbered in
``jax.tree.flatten``'s order (:func:`tree_flatten`). Version 2 adds a
per-leaf CRC32 so a torn or bit-rotted file is detected at load
(:class:`CheckpointCorruptError`); version-1 files (no ``version`` key)
still load, without the CRC check. Files claiming a version newer than
:data:`CHECKPOINT_VERSION` are refused: schema skew, not corruption. The
``treedef`` string is informative; the loader never compares it.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

# Bump when the on-disk schema changes incompatibly. v1 = no version key,
# no CRCs; v2 = per-leaf crc32 list in the header.
CHECKPOINT_VERSION = 2

# Positions beyond this are nonsense (2^53: exact-integer float range, and
# far past any real chunk count) — treat as corruption, not data.
_MAX_POSITION = 1 << 53


class CheckpointCorruptError(ValueError):
    """The checkpoint file is unreadable, torn, or fails validation.

    Subclasses ValueError so ``except ValueError`` callers keep working;
    recovery code (``engine/resilience.py``) catches this to fall back to
    the previous checkpoint in the rotation.
    """


# ---------------------------------------------------------------------- #
# the tree of a summary, in jax.tree.flatten's leaf order


def tree_flatten(tree) -> tuple[list, Any]:
    """``(leaves, spec)`` of a summary tree, in ``jax.tree.flatten``'s
    order: NamedTuple fields and tuple/list items in order, dict values by
    sorted key, ``None`` gives no leaf; anything else (a tensor, an array,
    a scalar) is a leaf."""
    leaves: list = []

    def walk(x):
        if x is None:
            return None
        if isinstance(x, (tuple, list)):  # NamedTuples included
            return (type(x), [walk(v) for v in x])
        if isinstance(x, dict):
            keys = sorted(x)
            return (dict, keys, [walk(x[k]) for k in keys])
        leaves.append(x)
        return "*"

    return leaves, walk(tree)


def tree_unflatten(spec, leaves: list):
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return None
        if sp == "*":
            return next(it)
        if sp[0] is dict:
            return {k: build(s) for k, s in zip(sp[1], sp[2])}
        kind, items = sp
        vals = [build(s) for s in items]
        if kind in (tuple, list):
            return kind(vals)
        return kind(*vals)  # a NamedTuple

    return build(spec)


def tree_map(fn, tree):
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [fn(x) for x in leaves])


def _spec_str(spec) -> str:
    if spec is None:
        return "None"
    if spec == "*":
        return "*"
    if spec[0] is dict:
        return "dict[{}]".format(", ".join(
            f"{k!r}: {_spec_str(s)}" for k, s in zip(spec[1], spec[2])))
    kind, items = spec
    return f"{kind.__name__}[{', '.join(_spec_str(s) for s in items)}]"


def to_host(x) -> np.ndarray:
    """One leaf as a host numpy array: a tensor on any device is COPIED
    (the snapshot must not alias a CPU tensor a later step writes in
    place); an array or a scalar is taken as it is, as ``jax.device_get``
    takes numpy leaves."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _numpy_dtype(t) -> np.dtype | None:
    dtype = getattr(t, "dtype", None)
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


# ---------------------------------------------------------------------- #
# files


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync — makes the rename itself durable.
    Some filesystems reject O_RDONLY directory fsync; that is their
    durability model, not an error this layer can act on."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_checkpoint(path: str, summary, position: int = 0,
                    meta: dict | None = None, fsync: bool = True) -> dict:
    """Atomically AND durably write ``summary`` (a tree of tensors on any
    device, arrays or scalars) plus the stream position: tmp file → fsync
    → rename → directory fsync. Readers see the previous checkpoint or
    this one in full, never a torn file. ``fsync=False`` skips both syncs
    for throwaway stores. Returns the written header dict (rotation
    cross-checks its CRC list against the on-disk header)."""
    if position < 0:
        raise ValueError(f"checkpoint position must be >= 0, got {position}")
    leaves, spec = tree_flatten(summary)
    arrays = {f"leaf_{i}": to_host(l) for i, l in enumerate(leaves)}
    header = {
        "version": CHECKPOINT_VERSION,
        "treedef": _spec_str(spec),
        "num_leaves": len(leaves),
        "position": int(position),
        "meta": meta or {},
        "crc32": [
            zlib.crc32(np.ascontiguousarray(a).tobytes())
            for a in arrays.values()
        ],
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    # The tmp name carries the target basename so a crashed writer's
    # leftover is attributable: CheckpointManager reaps stale tmps by
    # rotation prefix at takeover.
    base = os.path.basename(path)
    stem = base[: -len(".npz")] if base.endswith(".npz") else base
    fd, tmp = tempfile.mkstemp(dir=d, prefix=stem + "-", suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __header__=np.frombuffer(
                json.dumps(header).encode(), dtype=np.uint8
            ), **arrays)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if fsync:
        _fsync_dir(d)
    return header


_READ_ERRORS = (zipfile.BadZipFile, KeyError, OSError, ValueError,
                json.JSONDecodeError, zlib.error, EOFError)


def read_checkpoint_header(path: str) -> dict:
    """Parse ONLY the ``__header__`` entry (schema version, position,
    per-leaf CRC list) — a few-KB read. A torn/truncated file fails here
    (the zip central directory lives at EOF), as
    :class:`CheckpointCorruptError`."""
    try:
        with np.load(path) as z:
            header = json.loads(bytes(z["__header__"]).decode())
    except _READ_ERRORS as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} header unreadable (torn write?): {e}"
        ) from e
    if not isinstance(header, dict):
        raise CheckpointCorruptError(
            f"checkpoint {path}: header is {type(header).__name__}, "
            "expected an object"
        )
    return header


def _validate_leaf(i: int, arr: np.ndarray, template, path: str) -> None:
    t_shape = tuple(template.shape if isinstance(template, torch.Tensor)
                    else np.shape(template))
    if tuple(arr.shape) != t_shape:
        raise CheckpointCorruptError(
            f"checkpoint {path}: leaf {i} has shape {tuple(arr.shape)} but "
            f"the template expects {t_shape}"
        )
    t_dtype = _numpy_dtype(template)
    if t_dtype is not None and np.dtype(arr.dtype) != t_dtype:
        raise CheckpointCorruptError(
            f"checkpoint {path}: leaf {i} has dtype {arr.dtype} but the "
            f"template expects {t_dtype}"
        )


def _like_leaf(arr: np.ndarray, template):
    """A loaded leaf in the template's kind: a tensor on the template's
    device for a tensor template, else the numpy array."""
    if isinstance(template, torch.Tensor):
        # ascontiguousarray turns a 0-d leaf (a sticky flag) into shape
        # (1,): keep the stored shape.
        return torch.from_numpy(
            np.ascontiguousarray(arr).reshape(arr.shape)).to(template.device)
    return arr


def load_checkpoint(path: str, like=None):
    """Load a checkpoint. Returns ``(summary, position, meta)``.

    ``like`` — a template tree with the same structure (e.g.
    ``agg.init(device)``); each loaded leaf comes back in its template's
    kind, a tensor on the template leaf's device. When None, returns the
    flat list of numpy leaves in saved order. Every leaf is validated
    against the template's shape/dtype and, for version-2 files, against
    its stored CRC32. Torn/unparseable files raise
    :class:`CheckpointCorruptError`.
    """
    try:
        with np.load(path) as z:
            header = json.loads(bytes(z["__header__"]).decode())
            version = header.get("version", 1)
            if version > CHECKPOINT_VERSION:
                raise CheckpointCorruptError(
                    f"checkpoint {path} has format version {version}; this "
                    f"build reads up to {CHECKPOINT_VERSION} — written by a "
                    "newer release?"
                )
            leaves = [z[f"leaf_{i}"] for i in range(header["num_leaves"])]
    except FileNotFoundError:
        raise
    except CheckpointCorruptError:
        raise
    except _READ_ERRORS as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is unreadable (torn write?): {e}"
        ) from e
    position = header.get("position")
    if (not isinstance(position, int) or isinstance(position, bool)
            or position < 0 or position > _MAX_POSITION):
        raise CheckpointCorruptError(
            f"checkpoint {path} records position {position!r}; expected an "
            f"integer in [0, {_MAX_POSITION}]"
        )
    crcs = header.get("crc32")
    if crcs is not None:
        if len(crcs) != len(leaves):
            raise CheckpointCorruptError(
                f"checkpoint {path}: {len(crcs)} CRCs for "
                f"{len(leaves)} leaves"
            )
        for i, (arr, want) in enumerate(zip(leaves, crcs)):
            got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if got != want:
                raise CheckpointCorruptError(
                    f"checkpoint {path}: leaf {i} CRC mismatch "
                    f"(stored {want:#010x}, computed {got:#010x}) — "
                    "corrupt or torn file"
                )
    meta = header.get("meta", {})
    if not isinstance(meta, dict):
        raise CheckpointCorruptError(
            f"checkpoint {path} records meta of type "
            f"{type(meta).__name__}; expected a dict"
        )
    if like is None:
        return leaves, position, meta
    t_leaves, spec = tree_flatten(like)
    if len(t_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves; template has "
            f"{len(t_leaves)}"
        )
    for i, (arr, tmpl) in enumerate(zip(leaves, t_leaves)):
        _validate_leaf(i, arr, tmpl, path)
    summary = tree_unflatten(
        spec, [_like_leaf(a, t) for a, t in zip(leaves, t_leaves)])
    return summary, position, meta
