"""Cluster-level scheduling policies.

Equivalent role to the reference's two-phase scheduler: a cluster-level node
selection (``ClusterResourceScheduler::GetBestSchedulableNode``,
``raylet/scheduling/cluster_resource_scheduler.h:44``) followed by local
dispatch. Policies mirrored: hybrid pack-then-spread with top-k
randomization (``policy/hybrid_scheduling_policy.cc:186``), spread,
node-affinity, placement-group bundles
(``policy/bundle_scheduling_policy.cc``).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .config import CONFIG
from .ids import NodeID, PlacementGroupID

ResourceDict = Dict[str, float]


# ------------------------------------------------------ scheduling strategies

@dataclass
class NodeAffinitySchedulingStrategy:
    """Pin a task/actor to one node (reference:
    ``util/scheduling_strategies.py:41``)."""

    node_id: NodeID
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy:
    """Run inside a reserved placement-group bundle (reference:
    ``util/scheduling_strategies.py:135``)."""

    placement_group: "object"            # PlacementGroup handle or id
    placement_group_bundle_index: int = -1

    def pg_id(self) -> PlacementGroupID:
        pg = self.placement_group
        return pg if isinstance(pg, PlacementGroupID) else pg.id


SPREAD = "SPREAD"
DEFAULT = "DEFAULT"


# ------------------------------------------------------------ resource math

def fits(available: ResourceDict, demand: ResourceDict) -> bool:
    for k, v in demand.items():
        if v > 0 and available.get(k, 0.0) + 1e-9 < v:
            return False
    return True


def subtract(avail: ResourceDict, demand: ResourceDict) -> None:
    for k, v in demand.items():
        if v:
            avail[k] = avail.get(k, 0.0) - v


def add(avail: ResourceDict, demand: ResourceDict) -> None:
    for k, v in demand.items():
        if v:
            avail[k] = avail.get(k, 0.0) + v


def utilization(total: ResourceDict, available: ResourceDict) -> float:
    """Max over resources of used/total — the 'critical resource' view the
    hybrid policy scores with."""
    best = 0.0
    for k, cap in total.items():
        if cap <= 0:
            continue
        used = cap - available.get(k, 0.0)
        best = max(best, used / cap)
    return best


# ---------------------------------------------------------------- selection

def pick_node(
    demand: ResourceDict,
    strategy,
    candidates: List[Tuple[NodeID, ResourceDict, ResourceDict]],
    local_node: Optional[NodeID] = None,
    rng: Optional[random.Random] = None,
) -> Optional[NodeID]:
    """Choose a node for a task.

    ``candidates``: list of (node_id, total, available) for alive nodes.
    Returns None if no *feasible* node exists (demand exceeds every node's
    total capacity) — infeasible tasks wait in the queue like the
    reference's infeasible task set.
    """
    rng = rng or random
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        for nid, total, avail in candidates:
            if nid == strategy.node_id:
                if fits(total, demand):
                    return nid
                break
        if strategy.soft:
            return pick_node(demand, DEFAULT, candidates, local_node, rng)
        return None

    feasible = [(nid, total, avail) for nid, total, avail in candidates
                if fits(total, demand)]
    if not feasible:
        return None

    if strategy == SPREAD:
        # least-utilized first, ties broken randomly
        scored = sorted(feasible,
                        key=lambda c: (utilization(c[1], c[2]),
                                       rng.random()))
        for nid, total, avail in scored:
            if fits(avail, demand):
                return nid
        return scored[0][0]

    # hybrid DEFAULT: prefer packing onto nodes below the spread threshold
    # (lowest score wins), with top-k randomization to avoid herding.
    theta = CONFIG.scheduler_spread_threshold

    def score(c):
        nid, total, avail = c
        u = utilization(total, avail)
        if not fits(avail, demand):
            u += 100.0          # currently-full nodes only as a last resort
        if u <= theta:
            # below threshold: pack — prefer *higher* utilization, and the
            # local node as tiebreaker (reference: prefer local when legal)
            return (0, -u, 0 if nid == local_node else 1)
        return (1, u, 0 if nid == local_node else 1)

    ranked = sorted(feasible, key=score)
    k = max(1, int(len(ranked) * CONFIG.scheduler_top_k_fraction))
    return rng.choice(ranked[:k])[0]


# ------------------------------------------------------------ bundle packing

def pack_bundles(
    bundles: List[ResourceDict],
    strategy: str,
    candidates: List[Tuple[NodeID, ResourceDict, ResourceDict]],
) -> Optional[List[NodeID]]:
    """Assign placement-group bundles to nodes; None if unsatisfiable.

    Reference analogue: ``BundleSchedulingPolicy``
    (``policy/bundle_scheduling_policy.cc``) — PACK/SPREAD best-effort,
    STRICT_PACK single-node, STRICT_SPREAD distinct nodes.
    """
    avail = {nid: dict(a) for nid, _, a in candidates}
    order = [nid for nid, _, _ in candidates]

    if strategy == "STRICT_PACK":
        for nid in order:
            trial = dict(avail[nid])
            if all(_try_take(trial, b) for b in bundles):
                return [nid] * len(bundles)
        return None

    assignment: List[NodeID] = []
    if strategy == "STRICT_SPREAD":
        used_nodes = set()
        for b in bundles:
            placed = None
            for nid in order:
                if nid in used_nodes:
                    continue
                if _try_take(avail[nid], b):
                    placed = nid
                    break
            if placed is None:
                return None
            used_nodes.add(placed)
            assignment.append(placed)
        return assignment

    # PACK: fill nodes in order; SPREAD: round-robin over feasible nodes.
    spread = strategy == "SPREAD"
    idx = 0
    for b in bundles:
        placed = None
        tries = list(range(len(order)))
        if spread:
            tries = tries[idx:] + tries[:idx]
        for i in tries:
            nid = order[i]
            if _try_take(avail[nid], b):
                placed = nid
                idx = (i + 1) % len(order)
                break
        if placed is None:
            return None
        assignment.append(placed)
    return assignment


def _try_take(avail: ResourceDict, demand: ResourceDict) -> bool:
    if fits(avail, demand):
        subtract(avail, demand)
        return True
    return False
