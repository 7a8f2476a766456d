"""k-Spanner (SpannerExample.java:49-166).

Usage: python -m gelly_torch.examples.spanner_example [--device=DEV]
           [<edges path> <merge every chunks> <k>]
"""

import sys

from gelly_torch.examples._util import arg, split_device, stream_from_args
from gelly_torch.library.spanner import spanner, spanner_edges

# SpannerExample default data (SpannerExample.java:122-134).
DEFAULT = [
    (1, 4), (4, 7), (7, 8), (4, 8), (4, 5), (5, 6), (2, 3), (3, 4),
    (3, 6), (8, 9), (6, 8), (5, 9),
]


def main(args):
    device, args = split_device(args)
    # The spanner summary is a dense N^2 adjacency per shard: size the slot
    # space to the graph, not the generic default (16 slots cover the
    # built-in 9-vertex default).
    stream = stream_from_args(
        args, default_edges=DEFAULT,
        vertex_capacity=(1 << 12) if args else 16, device=device,
    )
    merge_every = arg(args, 1, 4)
    k = arg(args, 2, 3)
    agg = spanner(stream.ctx.vertex_capacity, k)
    summary = stream.aggregate(agg, merge_every=merge_every).result()
    for a, b in spanner_edges(summary, stream.ctx):
        print(f"({a},{b})")


if __name__ == "__main__":
    main(sys.argv[1:])
