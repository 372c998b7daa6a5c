"""Multi-device training and serving over ``torch.distributed``: port of
``trajnetplusplusbaselines_tpu.parallel``, under its names."""

from .mesh import batch_sharding, make_mesh, param_sharding_rule, scene_sharding, shard_params
from .multihost import (
    all_processes_agree,
    process_info,
    process_slice,
    put_global,
    put_global_tree,
    shard_items,
)
from .train import make_sharded_rollout, make_sharded_train_step

__all__ = [
    "batch_sharding",
    "make_mesh",
    "param_sharding_rule",
    "scene_sharding",
    "shard_params",
    "make_sharded_rollout",
    "make_sharded_train_step",
    "all_processes_agree",
    "process_info",
    "process_slice",
    "put_global",
    "put_global_tree",
    "shard_items",
]
