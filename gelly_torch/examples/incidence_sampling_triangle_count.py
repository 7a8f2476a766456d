"""Sampled triangle estimate, incidence-sampling distribution
(IncidenceSamplingTriangleCount.java:23-337).

The reference fans sampled/incident edges out to keyed subtasks; the
port's equivalent shards the instance axis over a mesh so each shard
advances its own reservoir states (same estimator, same seeded RNG
family). On one card this degenerates to the broadcast variant.

Usage: python -m gelly_torch.examples.incidence_sampling_triangle_count
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
    for est in sampled_triangle_count(
        stream, samples, num_vertices=vertices, seed=0xDEADBEEF
    ):
        pass
    print(f"estimate: {est}")


if __name__ == "__main__":
    main(sys.argv[1:])
