"""Iterative (label-propagation) CC (IterativeConnectedComponents.java:43-229).

Usage: python -m gelly_torch.examples.iterative_connected_components
           [--device=DEV] [<edges path>]
"""

import sys

import numpy as np

from gelly_torch.core.device import to_numpy
from gelly_torch.examples._util import (
    sequence_default_edges,
    split_device,
    stream_from_args,
)
from gelly_torch.library.iterative_cc import IterativeCCStream


def main(args):
    device, args = split_device(args)
    stream = stream_from_args(args, default_edges=sequence_default_edges(),
                              device=device)
    labels = to_numpy(IterativeCCStream(stream).final_labels())
    for slot in np.nonzero(labels >= 0)[0]:
        vertex = int(stream.ctx.decode(np.array([slot]))[0])
        comp = int(stream.ctx.decode(np.array([labels[slot]]))[0])
        print(f"({vertex},{comp})")


if __name__ == "__main__":
    main(sys.argv[1:])
