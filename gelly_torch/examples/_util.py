"""Shared CLI plumbing for the example programs.

Mirrors the reference examples' hand-rolled ``parseParameters`` pattern
(positional args; no args = built-in default data, e.g.
``M/example/ConnectedComponentsExample.java:81-118``), plus the port's
``--device=DEV`` flag (default ``cuda``), the counterpart of the
``JAX_PLATFORMS`` the JAX examples run under.
"""

from __future__ import annotations

from gelly_torch import edge_stream_from_edges, edge_stream_from_file
from gelly_torch.core.device import DEFAULT_DEVICE, resolve_device


def split_device(args, resolve=True):
    """``(device, rest)``: the ``--device=DEV`` flag (last one wins,
    default ``cuda``) and the other arguments in order. The device is
    resolved here, so a CUDA request without a card raises before any
    work; ``resolve=False`` returns the flag's text unresolved, for a
    caller that may need no device at all."""
    device = DEFAULT_DEVICE
    rest = []
    for a in args:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return (resolve_device(device) if resolve else device), rest


def stream_from_args(args, vertex_capacity=1 << 16, chunk_size=4096,
                     num_value_cols=0, default_edges=None,
                     device=DEFAULT_DEVICE, **kw):
    """args[0] = optional edge-list path; otherwise built-in default data."""
    if args:
        return edge_stream_from_file(
            args[0], vertex_capacity=vertex_capacity, chunk_size=chunk_size,
            num_value_cols=num_value_cols, device=device, **kw,
        )
    # Built-in default data is tiny; cap the chunk at its length so
    # sequential per-slot folds (e.g. the spanner insert scan) don't pay
    # for padding slots.
    return edge_stream_from_edges(
        default_edges, vertex_capacity=vertex_capacity,
        chunk_size=min(chunk_size, 256, max(1, len(default_edges))),
        device=device, **kw,
    )


def sequence_default_edges():
    """The reference examples' default stream: (k, k+2) for k=1..100 with
    event time k*100 (ConnectedComponentsExample.java:121-134)."""
    return [(k, k + 2, float(k * 100)) for k in range(1, 101)]


def arg(args, i, default, cast=int):
    return cast(args[i]) if len(args) > i else default
