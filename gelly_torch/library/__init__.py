"""One-pass graph algorithms.

The ``connected_components`` function is not exported here (``gelly_tpu``
exports it): the name would shadow the ``connected_components`` module,
which callers import as ``from gelly_torch.library import
connected_components``; call it as ``connected_components.
connected_components(...)``."""

from .bipartiteness import (
    BipartitenessResult,
    bipartiteness_check,
    bipartiteness_query,
    to_candidates,
)
from .connected_components import (
    CCSummary,
    cc_host_precombine,
    cc_query,
    connected_components_tree,
    labels_to_components,
)
from .degrees import (
    degree_aggregate,
    degree_distribution,
    degrees_query,
    sharded_degrees,
)
from .iterative_cc import IterativeCCStream
from .matching import weighted_matching
from .spanner import host_spanner, spanner, spanner_edges, spanner_query
from .triangles import (
    exact_triangle_count,
    sampled_triangle_count,
    window_triangles,
)

__all__ = [
    "BipartitenessResult",
    "CCSummary",
    "IterativeCCStream",
    "bipartiteness_check",
    "bipartiteness_query",
    "cc_host_precombine",
    "cc_query",
    "connected_components_tree",
    "degree_aggregate",
    "degree_distribution",
    "degrees_query",
    "exact_triangle_count",
    "host_spanner",
    "labels_to_components",
    "sampled_triangle_count",
    "sharded_degrees",
    "spanner",
    "spanner_edges",
    "spanner_query",
    "to_candidates",
    "weighted_matching",
    "window_triangles",
]
