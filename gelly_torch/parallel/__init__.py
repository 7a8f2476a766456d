"""The mesh layer: S shards driven by one controller (see ``mesh.py``)."""

from .collectives import (
    butterfly_merge,
    gather_merge,
    hierarchical_merge,
    psum_tree,
)
from .mesh import (
    SHARD_AXIS,
    Mesh,
    make_mesh,
    num_shards,
    replicated_spec,
    shard_map_fn,
    shard_spec,
)
from .partition import (
    owned_mask,
    owner_of,
    slots_per_shard,
    split_chunk,
    to_local_slot,
)
