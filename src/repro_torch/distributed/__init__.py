"""Distributed PackSELL: row-block partitioning, the halo exchange and the
distributed plan layer over a shard mesh, on one device or one process
per shard (DESIGN.md §7). The port of ``repro.distributed``;
``python -m repro_torch.distributed.run`` drives it over ranks."""
from . import halo  # noqa: F401
from .halo import HaloMaps, build_halo_maps, gather_halo  # noqa: F401
from .partition import (RowPartition, ShardSplit,  # noqa: F401
                        assemble_global, comm_matrix, partition_rows,
                        split_csr)
from .plan import (DistMeta, DistOperands, DistSpMVPlan,  # noqa: F401
                   DistTierLadder, build_composite_operands,
                   build_dist_plan, build_dist_tiers, build_operands,
                   reference_spmv)
