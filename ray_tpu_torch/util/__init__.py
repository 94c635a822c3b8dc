"""ray_tpu.util — user-facing utilities layered on the core API.

Mirrors the reference's ``python/ray/util/`` (placement groups,
scheduling strategies, actor pool, queue, collectives live in
``ray_tpu.comm``).
"""

from .placement_group import (  # noqa: F401
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from .scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
from .actor_pool import ActorPool  # noqa: F401
from .queue import Queue  # noqa: F401
