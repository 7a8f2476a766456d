"""gelly_torch — the PyTorch / CUDA port of gelly_tpu for one NVIDIA H100.

Mirrors ``gelly_tpu``'s layout (see that package for the design): ``core/``
chunks, sources and the stream API, ``engine/`` the aggregation engine,
``ops/`` union-find, scatter ops and the hand-written Hopper kernels
(sources in ``csrc/``), ``library/`` the algorithms, ``parallel/`` the
mesh (S shards driven from one controller; one card may hold several). The port imports
``torch`` and numpy only, never JAX or ``gelly_tpu``. Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""

from .core.chunk import EDGE_ADDITION, EDGE_DELETION, EdgeChunk, make_chunk
from .core.io import TimeCharacteristic
from .core.stream import (
    EdgeStream,
    StreamContext,
    edge_stream_from_edges,
    edge_stream_from_file,
    edge_stream_from_source,
)
from .core.vertices import IdentityVertexTable, VertexTable

__version__ = "0.1.0"

__all__ = [
    "EDGE_ADDITION",
    "EDGE_DELETION",
    "EdgeChunk",
    "EdgeStream",
    "IdentityVertexTable",
    "StreamContext",
    "TimeCharacteristic",
    "VertexTable",
    "edge_stream_from_edges",
    "edge_stream_from_file",
    "edge_stream_from_source",
    "make_chunk",
]
