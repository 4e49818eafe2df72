"""Multi-rank training and inference on ``torch.distributed`` (counterpart
of ``usip_tpu/parallel/``): the data mesh (``mesh``), the collectives with
gradients (``collectives``), the point-sharded ops, detector, trainer and
descriptor (``sharded_*``), tensor parallelism (``tensor_parallel``) and the
detect -> describe pipeline (``pipeline_parallel``)."""

from usip_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    initialize_distributed,
    is_main_process,
    jit_train_step,
    make_grid,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "initialize_distributed",
    "is_main_process",
    "jit_train_step",
    "make_grid",
    "make_mesh",
    "replicate",
    "replicated",
    "shard_batch",
]
