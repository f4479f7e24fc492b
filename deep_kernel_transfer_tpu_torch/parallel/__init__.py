"""Episode-parallel training and eval over torch.distributed (see mesh.py).
Importing it starts no process group."""
from .mesh import (
    DATA_AXIS,
    Mesh,
    average,
    distribute_local_episodes,
    in_group,
    make_mesh,
    make_sharded_eval,
    make_sharded_train_step,
    rank_device,
    replicate_tree,
    shard_episode_batch,
    spawn_ranks,
    wrap_pad_episodes,
)

__all__ = [
    "DATA_AXIS", "Mesh", "average", "distribute_local_episodes", "in_group",
    "make_mesh", "make_sharded_eval", "make_sharded_train_step",
    "rank_device", "replicate_tree", "shard_episode_batch", "spawn_ranks",
    "wrap_pad_episodes",
]
