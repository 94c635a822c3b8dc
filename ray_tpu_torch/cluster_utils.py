"""Multi-node clusters for tests and tools, in one process.

Equivalent role to the reference's ``ray.cluster_utils.Cluster``
(``python/ray/cluster_utils.py:108``) — the primary
multi-node-without-a-cluster mechanism (SURVEY §4): each ``add_node``
starts a full node service (its own scheduler, worker subprocess pool and
object store), and the node services share one in-process control plane
(fast, and every internal is introspectable from the test).

``ray_tpu``'s second mode, ``process_isolated=True`` (each node a separate
OS process joined over TCP through ``_private/main.py``), waits for that
module's port and is refused here.
"""

from __future__ import annotations

import tempfile
from typing import Dict, Optional

from ._private.gcs import GlobalControlPlane
from ._private.node import NodeService


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None,
                 process_isolated: bool = False):
        if process_isolated:
            raise NotImplementedError(
                "process-isolated clusters need the node main "
                "(_private/main.py), which ray_tpu_torch does not have yet")
        self.process_isolated = False
        self.session_dir = tempfile.mkdtemp(prefix="rtpt_cluster_")
        self.nodes: list = []
        self.head = None
        self.gcs_address: Optional[str] = None
        self.gcs = GlobalControlPlane()
        if initialize_head:
            self.head = self.add_node(**(head_node_args or {}))

    # ------------------------------------------------------------ members
    def add_node(self, num_cpus: int = 4, num_gpus: int = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 num_tpus: int = 0):
        """Start a node service with ``num_cpus`` CPUs and ``num_gpus``
        exclusive GPU slots (``num_tpus`` means the same, for scripts
        written for ``ray_tpu``)."""
        res = dict(resources or {})
        res.setdefault("CPU", float(num_cpus))
        if num_gpus or num_tpus:
            res.setdefault("GPU", float(num_gpus or num_tpus))
        node = NodeService(self.gcs, self.session_dir, res)
        node.start(labels=labels)
        self.nodes.append(node)
        if self.head is None:
            self.head = node
        return node

    def remove_node(self, node, allow_graceful: bool = False) -> None:
        """Kill a node, simulating failure (reference analogue:
        ``Cluster.remove_node`` and the chaos node-killer,
        ``_private/test_utils.py:1391``)."""
        node.kill()
        if node in self.nodes:
            self.nodes.remove(node)

    def shutdown(self) -> None:
        for node in list(self.nodes):
            node.stop()
        self.nodes.clear()
        import shutil
        shutil.rmtree(self.session_dir, ignore_errors=True)
