"""ray_tpu_torch.parallel — device meshes and logical sharding rules.

Counterpart of ``ray_tpu.parallel``: a `MeshSpec` with the named axes
(dp/fsdp/tp/sp/pp/ep), a rank's `Mesh` over `torch.distributed` process
groups (or the one-process `loopback_mesh`), the logical rules table with
the parameter shards it gives a rank, Megatron's tensor-parallel autograd
functions (`tensor_parallel`), the MoE FFN's collectives over ep and the
batch group (`expert_parallel`), the GPipe schedule over pp (`pipeline`)
and a dry run of all six axes on CPU processes (`dryrun`).
"""

from .mesh import (  # noqa: F401
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_ORDER,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
    MeshSpec,
    build_mesh,
    loopback_mesh,
    mesh_shape_for,
)
from .sharding import (  # noqa: F401
    DEFAULT_RULES,
    ShardingRules,
    gather_params,
    logical_sharding,
    shard_batch,
    shard_params,
    with_logical_constraint,
)
