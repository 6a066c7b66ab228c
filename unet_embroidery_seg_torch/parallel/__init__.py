from unet_embroidery_seg_torch.parallel.mesh import (
    Mesh,
    global_batch_from_local,
    init_multihost,
    launch_local,
    make_mesh,
    replicate,
    shard_batch_arrays,
)

__all__ = [
    "Mesh",
    "global_batch_from_local",
    "init_multihost",
    "launch_local",
    "make_mesh",
    "replicate",
    "shard_batch_arrays",
]
