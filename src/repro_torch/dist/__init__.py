"""The §6 sharding bridge: mesh shardings that are provably valid paper
partitions (see ``repro_torch.dist.sharding``) plus mesh-strategy
attention dispatch (``repro_torch.dist.flash``)."""
from .sharding import (ShardCtx, current_ctx, param_shardings,
                       partition_tree_of, use_mesh)

__all__ = ["ShardCtx", "current_ctx", "param_shardings",
           "partition_tree_of", "use_mesh"]
