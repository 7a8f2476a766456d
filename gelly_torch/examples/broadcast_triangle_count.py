"""Sampled triangle estimate, broadcast-style (BroadcastTriangleCount.java).

All sample instances advance over every edge (the reference broadcasts the
stream to each subtask's reservoir states; here the instances are one
vectorized axis on one device).

Usage: python -m gelly_torch.examples.broadcast_triangle_count
           [--device=DEV] [<edges path> <samples> <vertices>]
"""

import sys

from gelly_torch.examples._util import arg, split_device, stream_from_args
from gelly_torch.examples.window_triangles import DEFAULT
from gelly_torch.library.triangles import sampled_triangle_count


def main(args):
    device, args = split_device(args)
    stream = stream_from_args(args, default_edges=[
        (s, d) for s, d, _ in DEFAULT
    ], device=device)
    samples = arg(args, 1, 1000)
    vertices = arg(args, 2, 11)
    est = None
    for est in sampled_triangle_count(stream, samples, num_vertices=vertices):
        pass
    print(f"estimate: {est}")


if __name__ == "__main__":
    main(sys.argv[1:])
