from .mesh import (
    Mesh,
    batch_sharded_render,
    gather,
    make_mesh,
    on_device,
    ray_sharded_fast_render,
    ray_sharded_render,
    replicated,
    shard_batch,
    shard_batch_flat,
    shard_rays,
)

__all__ = [
    "Mesh",
    "batch_sharded_render",
    "gather",
    "make_mesh",
    "on_device",
    "ray_sharded_fast_render",
    "ray_sharded_render",
    "replicated",
    "shard_batch",
    "shard_batch_flat",
    "shard_rays",
]
