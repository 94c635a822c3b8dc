"""Placement groups: gang reservation of resource bundles.

Reference: ``python/ray/util/placement_group.py:146`` (API) +
``gcs_placement_group_scheduler.h:274`` (2-phase reserve; ours is the
node-side ``reserve_bundle``/``release_bundle`` pair with rollback,
``_private/node.py``). On TPU the headline use is gang-scheduling one
worker per TPU host so a ``comm.device_mesh.MeshGroup`` can lay a
`jax.sharding.Mesh` over the gang (SURVEY §7.7c).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from .._private import context as _ctx
from .._private import protocol as P
from .._private.ids import PlacementGroupID
from .._private.scheduler import PlacementGroupSchedulingStrategy  # noqa: F401

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    """Handle to a (possibly not-yet-reserved) placement group."""

    def __init__(self, pg_id: PlacementGroupID,
                 bundles: List[Dict[str, float]], strategy: str,
                 name: str = "", assignment: Optional[list] = None):
        self.id = pg_id
        self._bundles = bundles
        self._strategy = strategy
        self._name = name
        self._assignment = assignment

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    @property
    def strategy(self) -> str:
        return self._strategy

    def is_ready(self) -> bool:
        return self._assignment is not None

    def ready(self, timeout: Optional[float] = None) -> "PlacementGroup":
        """Block until the reservation succeeds (retrying as resources
        free up — the reference keeps pending PGs queued in the GCS)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.02
        while self._assignment is None:
            self._try_create()
            if self._assignment is not None:
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"placement group {self.id} not ready within {timeout}s")
            time.sleep(delay)
            delay = min(delay * 2, 0.5)
        return self

    def _try_create(self) -> None:
        client = _ctx.require_client()
        spec = P.PlacementGroupSpec(pg_id=self.id, bundles=self._bundles,
                                    strategy=self._strategy, name=self._name)
        assignment = client.create_placement_group(spec)
        if assignment is not None:
            self._assignment = assignment

    def __reduce__(self):
        return (_rebuild_pg, (self.id.binary(), self._bundles,
                              self._strategy, self._name, self._assignment))


def _rebuild_pg(id_bytes, bundles, strategy, name, assignment):
    return PlacementGroup(PlacementGroupID(id_bytes), bundles, strategy,
                          name, assignment)


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    """Reserve resource bundles across the cluster (async: call
    ``.ready()`` to block on reservation; the first attempt is made
    eagerly)."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or not all(isinstance(b, dict) and b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty "
                         "resource dicts")
    del lifetime  # detached PGs: accepted for parity, all PGs job-scoped
    pg = PlacementGroup(PlacementGroupID.from_random(), list(bundles), strategy,
                        name)
    pg._try_create()
    return pg


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release the reservation and its bundles."""
    _ctx.require_client().remove_placement_group(pg.id)
    pg._assignment = None
