"""Multi-node clusters for tests and tools: in-process or OS-isolated.

Equivalent role to the reference's ``ray.cluster_utils.Cluster``
(``python/ray/cluster_utils.py:108``) — the primary
multi-node-without-a-cluster mechanism (SURVEY §4): each ``add_node``
starts a full node service (its own scheduler, worker subprocess pool and
object store). Two modes:

- default: node services share one in-process control plane (fast, and
  every internal is introspectable from the test);
- ``process_isolated=True``: each node is a separate OS process joined
  over TCP through the GCS service (``_private/main.py``) — the same
  topology as a real multi-host deployment, with ``remove_node`` a
  genuine ``SIGKILL`` (chaos testing; reference analogue:
  ``Cluster`` + the node killer, ``_private/test_utils.py:1391``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from ._private.gcs import GlobalControlPlane
from ._private.node import NodeService


class RemoteNode:
    """Handle to a node running in its own OS process."""

    def __init__(self, proc: subprocess.Popen, ready: dict):
        self.proc = proc
        self.ready = ready            # full readiness record (ports etc.)
        self.node_id_hex: str = ready["node_id"]
        self.address: str = ready["node_address"]
        self.job_port = ready.get("job_port")

    @property
    def pid(self) -> int:
        return self.proc.pid


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None,
                 process_isolated: bool = False):
        self.process_isolated = process_isolated
        self.session_dir = tempfile.mkdtemp(prefix="rtpt_cluster_")
        self.nodes: list = []
        self.head = None
        self.gcs = None
        self.gcs_address: Optional[str] = None
        if not process_isolated:
            self.gcs = GlobalControlPlane()
        if initialize_head:
            self.head = self.add_node(**(head_node_args or {}))

    # ------------------------------------------------------------ members
    def add_node(self, num_cpus: int = 4, num_gpus: int = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 num_tpus: int = 0,
                 env: Optional[Dict[str, str]] = None):
        """Start a node service with ``num_cpus`` CPUs and ``num_gpus``
        exclusive GPU slots (``num_tpus`` means the same, for scripts
        written for ``ray_tpu``). A process-isolated node gets exactly
        these slots (``--num-gpus``, 0 included), never the cards its
        process happens to see; ``env`` is added to its environment
        (``CUDA_VISIBLE_DEVICES`` picks the cards slot i maps to)."""
        res = dict(resources or {})
        num_gpus = num_gpus or num_tpus
        if self.process_isolated:
            return self._spawn_node(num_cpus, num_gpus, res, labels or {},
                                    extra_env=env)
        res.setdefault("CPU", float(num_cpus))
        if num_gpus:
            res.setdefault("GPU", float(num_gpus))
        node = NodeService(self.gcs, self.session_dir, res)
        node.start(labels=labels)
        self.nodes.append(node)
        if self.head is None:
            self.head = node
        return node

    def _spawn_node(self, num_cpus, num_gpus, resources, labels,
                    timeout: float = 30.0,
                    extra_env: Optional[Dict[str, str]] = None) -> RemoteNode:
        is_head = self.head is None
        ready_file = os.path.join(
            self.session_dir, f"ready_{len(self.nodes)}_{os.getpid()}.json")
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.main",
               "--num-cpus", str(num_cpus),
               "--resources", json.dumps(resources),
               "--labels", json.dumps(labels),
               "--session-dir", os.path.join(
                   self.session_dir, f"node_{len(self.nodes)}"),
               "--ready-file", ready_file,
               "--num-gpus", str(num_gpus)]
        if is_head:
            cmd += ["--head"]
        else:
            cmd += ["--address", self.gcs_address]
        env = dict(os.environ)
        # dev checkouts: the framework may be importable only via the
        # driver's cwd; installed builds need no path help
        from ._private.config import fw_importable_without_path
        fw_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        pp = env.get("PYTHONPATH", "")
        if (not fw_importable_without_path()
                and fw_root not in pp.split(os.pathsep)):
            env["PYTHONPATH"] = (pp + os.pathsep if pp else "") + fw_root
        if extra_env:
            env.update(extra_env)
        proc = subprocess.Popen(cmd, env=env)
        deadline = time.monotonic() + timeout
        while not os.path.exists(ready_file):
            if proc.poll() is not None:
                raise RuntimeError(
                    f"node process exited rc={proc.returncode} before ready")
            if time.monotonic() > deadline:
                proc.kill()
                raise TimeoutError("node process never became ready")
            time.sleep(0.05)
        with open(ready_file) as f:
            ready = json.load(f)
        node = RemoteNode(proc, ready)
        self.nodes.append(node)
        if is_head:
            self.head = node
            self.gcs_address = f"127.0.0.1:{ready['gcs_port']}"
        return node

    def remove_node(self, node, allow_graceful: bool = False) -> None:
        """Kill a node, simulating failure (reference analogue:
        ``Cluster.remove_node`` and the chaos node-killer,
        ``_private/test_utils.py:1391``)."""
        if isinstance(node, RemoteNode):
            if allow_graceful:
                node.proc.terminate()
            else:
                node.proc.kill()
            node.proc.wait(timeout=10)
        else:
            node.kill()
        if node in self.nodes:
            self.nodes.remove(node)

    def shutdown(self) -> None:
        for node in list(self.nodes):
            if isinstance(node, RemoteNode):
                node.proc.terminate()
            else:
                node.stop()
        for node in list(self.nodes):
            if isinstance(node, RemoteNode):
                try:
                    node.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    node.proc.kill()
        self.nodes.clear()
        import shutil
        shutil.rmtree(self.session_dir, ignore_errors=True)
