"""Parallelism substrate: the shard meshes of the distributed layer (one
device, or one process per shard), the logical specs' rules of the
training side's data axes, their collectives and the launcher of the
ranks."""
from .sharding import (RankMesh, ShardMesh, make_rank_mesh,  # noqa: F401
                       make_shard_mesh)
