"""ray_tpu_torch.parallel — device meshes and logical sharding rules.

Counterpart of ``ray_tpu.parallel``: a `MeshSpec` with the named axes
(dp/fsdp/tp/sp/pp/ep), a rank's `Mesh` over `torch.distributed` process
groups (or the one-process `loopback_mesh`), and the logical rules table.
This slice runs the dp and sp axes; the parameters stay whole on every
rank.
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
    shard_batch,
)
