"""Parallelism substrate: the shard mesh of the distributed layer."""
from .sharding import ShardMesh, make_shard_mesh  # noqa: F401
