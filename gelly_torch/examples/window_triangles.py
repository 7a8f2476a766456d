"""Window triangle count (WindowTriangles.java:48-224).

Usage: python -m gelly_torch.examples.window_triangles [--device=DEV]
           [<edges path> <window ms>]
Edge values are event-time timestamps (the ITCase's format). On the
card, dense windows count through the wedge kernel
(``csrc/wedge_count_matrix.cu``: ``method="auto"`` picks ``"mxu"``).
"""

import sys

import numpy as np

from gelly_torch import TimeCharacteristic
from gelly_torch.examples._util import arg, split_device, stream_from_args
from gelly_torch.library.triangles import window_triangles

DEFAULT = [
    (1, 2, 100.0), (1, 3, 150.0), (3, 2, 200.0), (2, 4, 250.0),
    (3, 4, 300.0), (3, 5, 350.0), (4, 5, 400.0), (4, 6, 450.0),
    (6, 5, 500.0), (5, 7, 550.0), (6, 7, 600.0), (8, 6, 650.0),
    (7, 8, 700.0), (7, 9, 750.0), (8, 9, 800.0), (10, 8, 850.0),
    (9, 10, 900.0), (9, 11, 950.0), (10, 11, 1000.0),
]


def main(args):
    device, args = split_device(args)
    window_ms = arg(args, 1, 400)
    # Per-window dense adjacency: keep the slot space graph-sized.
    stream = stream_from_args(
        args, default_edges=DEFAULT, num_value_cols=1,
        time=TimeCharacteristic.EVENT,
        ts_fn=lambda s, d, v: v.astype(np.int64),
        vertex_capacity=1 << 12, device=device,
    )
    for w, count in window_triangles(stream, window_ms):
        print(f"({count},{(w + 1) * window_ms - 1})")


if __name__ == "__main__":
    main(sys.argv[1:])
