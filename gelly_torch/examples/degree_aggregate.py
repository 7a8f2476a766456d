"""Continuous degree aggregate (getDegrees, SimpleEdgeStream.java:413-438) —
the BASELINE workload #1 surface.

Usage: python -m gelly_torch.examples.degree_aggregate [--device=DEV]
           [<edges path> <out|in|both>]
"""

import sys

from gelly_torch.examples._util import (
    arg,
    sequence_default_edges,
    split_device,
    stream_from_args,
)


def main(args):
    device, args = split_device(args)
    stream = stream_from_args(args, default_edges=sequence_default_edges(),
                              device=device)
    mode = arg(args, 1, "both", str)
    ds = {
        "out": stream.get_out_degrees,
        "in": stream.get_in_degrees,
        "both": stream.get_degrees,
    }[mode]()
    for v, d in sorted(ds.final_degrees().items()):
        print(f"({v},{d})")


if __name__ == "__main__":
    main(sys.argv[1:])
