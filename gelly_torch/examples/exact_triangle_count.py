"""Exact streaming triangle count (ExactTriangleCount.java:41-207).

Usage: python -m gelly_torch.examples.exact_triangle_count [--device=DEV]
           [<edges path>]
Prints (vertex, count) pairs; key -1 is the global count.
"""

import sys

from gelly_torch.examples._util import split_device, stream_from_args
from gelly_torch.examples.window_triangles import DEFAULT
from gelly_torch.library.triangles import exact_triangle_count


def main(args):
    device, args = split_device(args)
    # Dense N^2 adjacency state: keep the slot space graph-sized.
    stream = stream_from_args(args, default_edges=[
        (s, d) for s, d, _ in DEFAULT
    ], vertex_capacity=1 << 12, device=device)
    for k, v in sorted(exact_triangle_count(stream).final_counts().items()):
        print(f"({k},{v})")


if __name__ == "__main__":
    main(sys.argv[1:])
