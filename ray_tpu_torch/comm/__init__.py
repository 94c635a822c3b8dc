"""ray_tpu_torch.comm — host collectives and ``MeshGroup``, a copy of
``ray_tpu.comm``.

The in-program collectives of a mesh are ``torch.distributed``'s (see
``ray_tpu_torch.parallel``). This package is the other plane:
actor-to-actor allreduce/allgather/… for arrays and tensors that live on
*hosts* (CPU rollout workers, parameter servers, a GPU learner syncing
with CPU ranks: CUDA tensors go through the host). API mirrors the
reference's ``util/collective/collective.py:258-615``; rendezvous runs
through a named actor like the reference's named-store rendezvous.

``MeshGroup`` ties a placement-group gang of host actors to one logical
device mesh — the SPMD-vs-actor bridge (SURVEY §7 "hard parts").
"""

from .collective import (  # noqa: F401
    CollectiveActorMixin,
    CollectiveTimeoutError,
    FaultTolerantGroup,
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    ensure_collective_group,
    ft_allreduce,
    ft_collective,
    get_rank,
    get_collective_group_size,
    init_collective_group,
    recv,
    reducescatter,
    reform_collective_group,
    send,
)
from .device_mesh import MeshGroup, mesh_group  # noqa: F401
