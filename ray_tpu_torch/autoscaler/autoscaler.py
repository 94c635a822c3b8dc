"""StandardAutoscaler: demand-driven scale-up, idle-driven scale-down.

Reference: ``python/ray/autoscaler/_private/autoscaler.py:171``. Each
update:

1. read the cluster's load report from the control plane — every node's
   heartbeat carries its availability and its queued-but-unplaced
   resource shapes (``NodeService.pending_demand``);
2. subtract what the live cluster can already absorb, then first-fit
   bin-pack the unmet shapes onto fresh nodes of the configured node
   types (``resource_demand_scheduler.py:102``), bounded by per-type
   ``max_workers`` and ``upscaling_speed``;
3. terminate provider nodes that have been fully idle (nothing running,
   nothing queued) longer than ``idle_timeout_s``, down to per-type
   ``min_workers``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class NodeType:
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class AutoscalerConfig:
    node_types: Dict[str, NodeType] = field(default_factory=dict)
    idle_timeout_s: float = 60.0
    update_interval_s: float = 5.0
    # max fraction of the current node count added per update (>=1 node)
    upscaling_speed: float = 1.0


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in demand.items() if v > 0)


def _subtract(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


class StandardAutoscaler:
    def __init__(self, gcs, provider, config: AutoscalerConfig):
        self.gcs = gcs
        self.provider = provider
        self.config = config
        self._idle_since: Dict[str, float] = {}    # provider handle id(str)
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # observability (and test hooks)
        self.num_launched = 0
        self.num_terminated = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rtpu-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _run(self) -> None:
        while not self._stopped.wait(self.config.update_interval_s):
            try:
                self.update()
            except Exception:
                import sys
                import traceback
                traceback.print_exc(file=sys.stderr)

    # max age of a pending-PG record before it stops driving scale-up
    # (the blocked client refreshes it every <=0.5s when healthy; the
    # margin is wide because a refresh that slips under host load must
    # not drop the gang mid-launch — that drained half-launched gang
    # nodes and churned the whole placement. A dead driver's record
    # still expires, just later.)
    PENDING_PG_STALE_S = 30.0

    # --------------------------------------------------------------- update
    def update(self) -> None:
        nodes = [n for n in self.gcs.alive_nodes()]
        demand: List[Dict[str, float]] = []
        for n in nodes:
            demand.extend(n.pending_shapes)
        gangs = self._pending_gangs()
        self._scale_up(nodes, demand, gangs)
        self._scale_down(nodes, demand or gangs)

    def _pending_gangs(self) -> List[Any]:
        """Fresh unplaceable placement groups (reference:
        ``resource_demand_scheduler.py:102`` — pending PGs feed
        scale-up; on TPU, gangs are THE autoscaling driver)."""
        try:
            recs = self.gcs.pending_pgs_snapshot()
        except Exception:
            return []
        now = time.time()
        return [r["spec"] for r in recs
                if now - r["last_attempt"] < self.PENDING_PG_STALE_S]

    def _scale_up(self, nodes,
                  demand: List[Dict[str, float]],
                  gangs: Optional[List[Any]] = None) -> None:
        if not demand and not gangs:
            return
        # shapes the live cluster will absorb on its own don't count
        avail = [dict(n.resources_available or n.resources_total)
                 for n in nodes]
        unmet = []
        for shape in demand:
            if not shape:
                continue
            placed = False
            for a in avail:
                if _fits(a, shape):
                    _subtract(a, shape)
                    placed = True
                    break
            if not placed:
                unmet.append(shape)

        counts = self._count_by_type()
        # first-fit decreasing over open bins of configured node types
        bins: List[tuple] = []                     # (type_name, remaining)
        to_launch: Dict[str, int] = {}

        def open_bin(shape) -> bool:
            for tname, ntype in self.config.node_types.items():
                live = counts.get(tname, 0) + to_launch.get(tname, 0)
                if live >= ntype.max_workers:
                    continue
                if _fits(dict(ntype.resources), shape):
                    remaining = dict(ntype.resources)
                    _subtract(remaining, shape)
                    bins.append((tname, remaining))
                    to_launch[tname] = to_launch.get(tname, 0) + 1
                    return True
            return False

        for shape in sorted(unmet, key=lambda s: -sum(s.values())):
            placed = False
            for _, remaining in bins:
                if _fits(remaining, shape):
                    _subtract(remaining, shape)
                    placed = True
                    break
            if not placed:
                open_bin(shape)
            # no type fits the shape: it stays unmet (the task will fail
            # at its grace deadline with a clear error)

        # Gangs: pack WHOLE placement groups, honoring their strategy —
        # partial capacity is useless to a gang, so the nodes it needs
        # are planned together (atomic scale-up; the launch-cap below
        # still rate-limits the provider calls per update).
        for spec in gangs or []:
            self._plan_gang(spec, avail, bins, counts, to_launch, open_bin)

        cap = max(1, int(self.config.upscaling_speed * max(1, len(nodes))))
        budget = cap
        for tname, n in to_launch.items():
            n = min(n, budget)
            budget -= n
            ntype = self.config.node_types[tname]
            for _ in range(n):
                self.provider.create_node(
                    tname, ntype.resources,
                    labels={"rtpu.io/autoscaled": "1"})
                self.num_launched += 1

    def _plan_gang(self, spec, avail, bins, counts, to_launch,
                   open_bin) -> None:
        """Plan nodes for one unplaceable placement group.

        STRICT_PACK: all bundles on ONE node — a single new node fitting
        their sum. STRICT_SPREAD: each bundle on a DISTINCT node — one
        new node per bundle not absorbable by a distinct live node.
        PACK/SPREAD: best-effort — bundles bin-packed like plain shapes.
        Reference: ``resource_demand_scheduler.py:102`` +
        ``bundle_scheduling_policy.cc`` strategy semantics.
        """
        bundles = list(spec.bundles)
        if spec.strategy == "STRICT_PACK":
            total: Dict[str, float] = {}
            for b in bundles:
                for k, v in b.items():
                    total[k] = total.get(k, 0.0) + v
            for a in avail:
                if _fits(a, total):
                    _subtract(a, total)     # live capacity will absorb it
                    return
            open_bin(total)
            return
        if spec.strategy == "STRICT_SPREAD":
            # greedily absorb bundles onto DISTINCT live nodes; a node
            # may host at most one bundle of this gang
            used = set()
            remaining = []
            for b in bundles:
                for i, a in enumerate(avail):
                    if i not in used and _fits(a, b):
                        _subtract(a, b)
                        used.add(i)
                        break
                else:
                    remaining.append(b)
            # one FRESH node per leftover bundle (bins opened by other
            # demand must not double-host two bundles of this gang)
            for b in remaining:
                open_bin(b)
            return
        # PACK / SPREAD: best-effort placement, plain bin-packing
        for b in bundles:
            placed = False
            for a in avail:
                if _fits(a, b):
                    _subtract(a, b)
                    placed = True
                    break
            if placed:
                continue
            for _, remaining_bin in bins:
                if _fits(remaining_bin, b):
                    _subtract(remaining_bin, b)
                    placed = True
                    break
            if not placed:
                open_bin(b)

    def _scale_down(self, nodes, demand: List[Dict[str, float]]) -> None:
        if demand:
            # queued work anywhere: keep capacity (conservative, like the
            # reference's load-based idle criterion)
            self._idle_since.clear()
            return
        counts = self._count_by_type()
        by_id = {n.node_id: n for n in nodes}
        # nodes holding the primary copy of a shm/arena-backed object are
        # not drainable — terminating them would vaporize data a driver
        # may still get() (put objects have no lineage to rebuild from).
        # Inline values travel in the directory meta itself and survive
        # their host.
        try:
            object_hosts = {nid for _, (nid, meta) in
                            self.gcs.directory_snapshot()
                            if meta.shm_name is not None
                            or meta.arena_ref is not None}
        except Exception:
            object_hosts = set()
        try:
            # reservation state is authoritative at the GCS: a freshly
            # reserved gang node can look idle until its next heartbeat
            # lands, but must never drain while its PG lives
            gang_hosts = self.gcs.gang_hosts()
        except Exception:
            gang_hosts = set()
        now = time.monotonic()
        for handle in self.provider.non_terminated_nodes():
            node_id = self.provider.node_id_of(handle)
            key = node_id.hex()
            info = by_id.get(node_id)
            if info is None:
                continue
            avail = info.resources_available or {}
            busy = any(total - avail.get(k, 0.0) > 1e-9
                       for k, total in info.resources_total.items())
            if (busy or info.pending_shapes or node_id in object_hosts
                    or node_id in gang_hosts):
                self._idle_since.pop(key, None)
                continue
            first = self._idle_since.setdefault(key, now)
            if now - first < self.config.idle_timeout_s:
                continue
            tname = self.provider.node_type_of(handle)
            ntype = self.config.node_types.get(tname)
            if ntype is not None and counts.get(tname, 0) <= ntype.min_workers:
                continue
            self.provider.terminate_node(handle)
            counts[tname] = counts.get(tname, 0) - 1
            self._idle_since.pop(key, None)
            self.num_terminated += 1

    def _count_by_type(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for handle in self.provider.non_terminated_nodes():
            t = self.provider.node_type_of(handle)
            counts[t] = counts.get(t, 0) + 1
        return counts
