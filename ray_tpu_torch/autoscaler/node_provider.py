"""Node providers: how the autoscaler actually adds/removes machines.

Reference: ``python/ray/autoscaler/node_provider.py`` (NodeProvider
interface) and ``_private/fake_multi_node/node_provider.py:237``
(FakeMultiNodeProvider — cloudless nodes for tests). The fake provider
here backs onto ``cluster_utils.Cluster``, so scale-up creates a REAL
node service (scheduler, worker pool, object store) and scale-down
kills one.
"""

from __future__ import annotations


from .._private import locksan
from typing import Any, Dict, List, Optional


class NodeProvider:
    """Minimal provider surface the autoscaler drives."""

    def create_node(self, node_type: str,
                    resources: Dict[str, float],
                    labels: Dict[str, str]) -> Any:
        """Launch one node of ``node_type``; returns a provider handle."""
        raise NotImplementedError

    def terminate_node(self, handle: Any) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[Any]:
        raise NotImplementedError

    def node_id_of(self, handle: Any):
        """The cluster NodeID a provider handle registered as."""
        raise NotImplementedError

    def node_type_of(self, handle: Any) -> str:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Adds/removes real in-process node services on one machine."""

    def __init__(self, cluster):
        self._cluster = cluster
        self._lock = locksan.lock("autoscaler.provider")
        self._nodes: List[dict] = []   # {"node": ..., "type": str}

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> Any:
        node = self._cluster.add_node(
            resources=dict(resources),
            labels={**labels, "rtpu.io/node-type": node_type})
        rec = {"node": node, "type": node_type}
        with self._lock:
            self._nodes.append(rec)
        return rec

    def terminate_node(self, handle: Any) -> None:
        # remove from the cluster FIRST: if that raises, the handle stays
        # tracked and the autoscaler retries next update
        self._cluster.remove_node(handle["node"], allow_graceful=True)
        with self._lock:
            if handle in self._nodes:
                self._nodes.remove(handle)

    def non_terminated_nodes(self) -> List[Any]:
        with self._lock:
            return list(self._nodes)

    def node_id_of(self, handle: Any):
        node = handle["node"]
        nid = getattr(node, "node_id", None)
        if nid is not None:
            return nid
        from .._private.ids import NodeID
        return NodeID.from_hex(node.node_id_hex)   # process-isolated node

    def node_type_of(self, handle: Any) -> str:
        return handle["type"]
