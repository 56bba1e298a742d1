"""Multi-device / multi-host scaling: mesh data parallelism for pair
batches, sequence-parallel sharded haystack search with halo exchange.

The reference is single-threaded, single-process (SURVEY.md §2.5): these
components are new and first-class, built on `jax.sharding` meshes + XLA
collectives (no custom comm backend needed — XLA hands the collectives to
NCCL on GPUs).
"""

from .mesh import (
    DATA_AXIS,
    assert_mesh_consistent,
    batch_sharding,
    make_mesh,
)
from .sharded import (
    assemble_sharded_search,
    collect_sharded_hits,
    match_count_psum,
    shard_haystack,
    sharded_distance_step,
    sharded_hamming_search_mins,
    sharded_myers_distance,
    sharded_myers_search_mins,
    sharded_myers_search_mins_packed,
    sharded_pack_segs,
    sharded_search_step,
)

__all__ = [
    "DATA_AXIS",
    "assert_mesh_consistent",
    "batch_sharding",
    "make_mesh",
    "assemble_sharded_search",
    "collect_sharded_hits",
    "match_count_psum",
    "shard_haystack",
    "sharded_distance_step",
    "sharded_hamming_search_mins",
    "sharded_myers_distance",
    "sharded_myers_search_mins",
    "sharded_myers_search_mins_packed",
    "sharded_pack_segs",
    "sharded_search_step",
]
