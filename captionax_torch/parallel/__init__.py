from captionax_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate_params,
    shard_batch,
    vocab_tp_sharding,
)
from captionax_torch.parallel.pipeline import (
    make_pipeline,
    pipeline_mesh,
    pipelined_bert_encoder,
    stack_layers,
    unstack_layers,
)

__all__ = [
    "Mesh", "make_mesh", "shard_batch", "replicate_params", "vocab_tp_sharding",
    "make_pipeline", "pipeline_mesh", "pipelined_bert_encoder",
    "stack_layers", "unstack_layers",
]
