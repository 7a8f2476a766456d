"""One-pass graph algorithms."""

from .bipartiteness import (
    BipartitenessResult,
    bipartiteness_check,
    bipartiteness_query,
    to_candidates,
)
from .connected_components import cc_host_precombine
from .degrees import (
    degree_aggregate,
    degree_distribution,
    degrees_query,
    sharded_degrees,
)
from .matching import weighted_matching
from .spanner import host_spanner, spanner, spanner_edges, spanner_query
from .triangles import window_triangles

__all__ = [
    "BipartitenessResult",
    "bipartiteness_check",
    "bipartiteness_query",
    "cc_host_precombine",
    "degree_aggregate",
    "degree_distribution",
    "degrees_query",
    "host_spanner",
    "sharded_degrees",
    "spanner",
    "spanner_edges",
    "spanner_query",
    "to_candidates",
    "weighted_matching",
    "window_triangles",
]
