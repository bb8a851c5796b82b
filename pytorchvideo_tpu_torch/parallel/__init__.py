"""The parallel layer of the port (counterpart of pytorchvideo_tpu/parallel):
process groups, the mesh and batch sharding, differentiable collectives,
sequence-parallel attention, and tensor parallelism and FSDP: the sharding
rules (parallel/sharding.py) and a model put on their placements
(parallel/tensor.py)."""

from pytorchvideo_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather_with_grad,
    all_reduce_with_grad,
    cat_all_gather,
    enter_region,
    reduce_from_region,
)
from pytorchvideo_tpu_torch.parallel.distributed import (  # noqa: F401
    get_local_size,
    get_rank,
    get_world_size,
    init_distributed_training,
    local_sync_groups,
    new_local_sync_groups,
)
from pytorchvideo_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_rows,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from pytorchvideo_tpu_torch.parallel.sequence import (  # noqa: F401
    sequence_parallel_attention,
    sequence_parallel_body,
    sequence_shard,
)
from pytorchvideo_tpu_torch.parallel.sharding import (  # noqa: F401
    MEGATRON_ATTENTION_RULES,
    infer_param_shardings,
    optimizer_state_shardings,
)
from pytorchvideo_tpu_torch.parallel.tensor import (  # noqa: F401
    MeshAxes,
    ShardPlan,
    shard_model_,
)
