"""Bipartiteness check (BipartitenessCheckExample.java:40-125).

Usage: python -m gelly_torch.examples.bipartiteness_check [--device=DEV]
           [<edges path> <merge every chunks>]
"""

import sys

from gelly_torch.examples._util import arg, split_device, stream_from_args
from gelly_torch.library.bipartiteness import bipartiteness_check, to_candidates

# BipartitenessCheckTest bipartite fixture as the built-in default.
DEFAULT = [(1, 2), (1, 3), (1, 4), (4, 5), (4, 7), (4, 9)]


def main(args):
    device, args = split_device(args)
    stream = stream_from_args(args, default_edges=DEFAULT, device=device)
    agg = bipartiteness_check(stream.ctx.vertex_capacity)
    res = stream.aggregate(agg, merge_every=arg(args, 1, 4)).result()
    print(to_candidates(res, stream.ctx))


if __name__ == "__main__":
    main(sys.argv[1:])
