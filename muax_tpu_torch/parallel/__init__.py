"""Mesh construction, the sharded training program, the multi-process
entry and the channel-sharded AlphaZero tower, over ``torch.distributed``."""

from muax_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    data_sharding,
    replicated,
)
from muax_tpu_torch.parallel.model_parallel import (
    make_model_parallel_apply,
    shard_az_params,
    sharded_fraction,
)
from muax_tpu_torch.parallel.sharded import ShardedProgram, make_sharded_program
