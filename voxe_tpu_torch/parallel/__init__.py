from voxe_tpu_torch.parallel.mesh import (  # noqa: F401
    RAY_AXIS,
    make_mesh,
    shard_rays,
    replicate,
)
