"""Fully-dynamic degree distribution (DegreeDistribution.java:42-193).

Usage: python -m gelly_torch.examples.degree_distribution [--device=DEV]
           [<edges path (src dst +|-)>]
Prints the final (degree, vertex count) distribution.
"""

import sys

import numpy as np

from gelly_torch.core.io import EdgeChunkSource
from gelly_torch.core.stream import edge_stream_from_source
from gelly_torch.examples._util import split_device
from gelly_torch.library.degrees import degree_distribution

# ExamplesTestData.DEGREES_DATA (+/- events).
DEFAULT = [
    (1, 2, 0), (2, 3, 0), (1, 4, 0), (2, 3, 1), (3, 4, 0), (1, 2, 1),
]


def parse_event_file(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("%", "#")):
                continue
            s, d, ev = line.split()
            rows.append((int(s), int(d), 1 if ev == "-" else 0))
    return rows


def main(args):
    device, args = split_device(args)
    rows = parse_event_file(args[0]) if args else DEFAULT
    src = np.array([r[0] for r in rows])
    dst = np.array([r[1] for r in rows])
    ev = np.array([r[2] for r in rows], np.int8)
    stream = edge_stream_from_source(
        EdgeChunkSource(src, dst, events=ev, chunk_size=256), 1 << 16,
        device=device,
    )
    dist = degree_distribution(stream, max_degree=1 << 12).final_distribution()
    for d in sorted(dist):
        print(f"({d},{dist[d]})")


if __name__ == "__main__":
    main(sys.argv[1:])
