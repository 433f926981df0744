from captionax_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate_params,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate_params"]
