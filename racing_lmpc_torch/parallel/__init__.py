"""Scale-out of the port: meshes of ranks, scenario-batch sharding and the
``torch.distributed`` process group (the counterpart of
``racing_lmpc_tpu.parallel``); ``parallel.spawn`` starts a group of
processes on one machine."""

from racing_lmpc_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_batch,
    sharded_batch_solver,
    sharded_metrics,
)
from racing_lmpc_torch.parallel import distributed

__all__ = ["make_mesh", "make_mesh_2d", "shard_batch", "replicate",
           "sharded_batch_solver", "sharded_metrics", "distributed"]
