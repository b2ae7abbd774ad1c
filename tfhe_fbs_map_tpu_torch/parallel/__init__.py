from .distributed import global_mesh, init_distributed
from .mesh import (make_mesh, replicate, shard_batch, shard_fast_keys,
                   sharded_bootstrap)

__all__ = ["global_mesh", "init_distributed", "make_mesh", "replicate",
           "shard_batch", "shard_fast_keys", "sharded_bootstrap"]
