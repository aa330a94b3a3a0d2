from .mesh import (  # noqa: F401
    RAY_AXIS,
    RayMesh,
    all_reduce_grads,
    barrier,
    gather_rays,
    make_ray_mesh,
    mesh_mean,
    mesh_sums,
    rank_rows,
    replicate,
    shard_rays,
    shard_train_step,
)
