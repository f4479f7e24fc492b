"""Episode-parallel and tensor-parallel training and eval over
torch.distributed (see mesh.py). Importing it starts no process group."""
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    average,
    distribute_local_episodes,
    gather_state,
    grid_mesh,
    in_group,
    make_mesh,
    make_mesh_2d,
    make_sharded_eval,
    make_sharded_train_step,
    rank_device,
    replicate_tree,
    shard_episode_batch,
    spawn_ranks,
    tensor_sharding_rules,
    wrap_pad_episodes,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "average", "distribute_local_episodes",
    "gather_state", "grid_mesh", "in_group", "make_mesh", "make_mesh_2d",
    "make_sharded_eval", "make_sharded_train_step", "rank_device",
    "replicate_tree", "shard_episode_batch", "spawn_ranks",
    "tensor_sharding_rules", "wrap_pad_episodes",
]
