"""Data and tensor parallelism on torch.distributed (ertdx/parallel/)."""
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, make_mesh,  # noqa: F401
                   pad_to_multiple, shard_batch, tp_shard_params)
from .multihost import (global_batch, global_mesh,  # noqa: F401
                        init_distributed, process_count, process_index,
                        replicate_tree)
