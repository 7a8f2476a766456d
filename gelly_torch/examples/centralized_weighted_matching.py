"""Greedy weighted matching (CentralizedWeightedMatching.java:36-113).

Usage: python -m gelly_torch.examples.centralized_weighted_matching
           [--device=DEV] [<edges path (src dst weight)>]
Prints the final matching and its total weight plus net runtime, mirroring
the reference's getNetRuntime report (:62-64). The matching folds on the
host (the event stream is the host path's); ``--device`` places the
stream.
"""

import sys
import time

from gelly_torch.examples._util import split_device, stream_from_args
from gelly_torch.library.matching import weighted_matching

DEFAULT = [
    (1, 2, 10.0), (3, 4, 10.0), (2, 3, 45.0), (5, 6, 3.0), (6, 7, 10.0),
]


def main(args):
    device, args = split_device(args)
    stream = stream_from_args(args, default_edges=DEFAULT, num_value_cols=1,
                              device=device)
    t0 = time.perf_counter()
    wm = weighted_matching(stream)
    for ev in wm.events():  # the reference's MatchingEvent print stream
        print(f"{ev.type} ({ev.src},{ev.dst},{ev.weight})")
    print(f"total weight: {wm.total_weight()}")
    print(f"Runtime: {int((time.perf_counter() - t0) * 1000)} ms")


if __name__ == "__main__":
    main(sys.argv[1:])
