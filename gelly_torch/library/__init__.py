"""One-pass graph algorithms."""

from .bipartiteness import (
    BipartitenessResult,
    bipartiteness_check,
    bipartiteness_query,
    to_candidates,
)
from .degrees import (
    degree_aggregate,
    degree_distribution,
    degrees_query,
    sharded_degrees,
)
from .triangles import window_triangles

__all__ = [
    "BipartitenessResult",
    "bipartiteness_check",
    "bipartiteness_query",
    "degree_aggregate",
    "degree_distribution",
    "degrees_query",
    "sharded_degrees",
    "to_candidates",
    "window_triangles",
]
