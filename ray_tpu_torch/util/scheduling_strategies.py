"""Scheduling strategies (reference: ``util/scheduling_strategies.py``).

The dataclasses live in ``_private.scheduler`` because the node-side
scheduler pattern-matches on them; this module is the public name.
"""

from .._private.scheduler import (  # noqa: F401
    DEFAULT,
    SPREAD,
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
