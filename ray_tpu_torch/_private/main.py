"""Node process entrypoint: ``python -m ray_tpu_torch._private.main``.

Starts one node service in this OS process, either as the head (hosting
the GCS service) or joining an existing cluster over TCP. Equivalent
role to the reference's ``ray start --head`` / ``ray start --address=``
(``python/ray/scripts/scripts.py`` start command + ``node.py`` process
supervision).

On readiness a JSON line ``{"node_id": ..., "gcs_port": ...,
"node_address": ...}`` is written to ``--ready-file`` (and stdout) so a
parent process (``cluster_utils.Cluster(process_isolated=True)`` or an
operator script) can discover ports and identity.

The node's ``"GPU"`` resource is ``--num-gpus`` (``--num-tpus`` means the
same, for scripts written for ``ray_tpu``), else the number of CUDA
devices this process sees. That count imports no torch and creates no
CUDA context: a node process never owns a card. Its workers reach the
cards through ``RTPU_NODE_CUDA_DEVICES`` and ``CUDA_VISIBLE_DEVICES``,
which the node sets when it spawns them (``node._spawn_worker``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ray_tpu_torch node")
    ap.add_argument("--head", action="store_true",
                    help="host the GCS service in this process")
    ap.add_argument("--address", default=None,
                    help="host:port of the head GCS (join an existing cluster)")
    ap.add_argument("--gcs-port", type=int, default=0,
                    help="head only: TCP port for the GCS service (0 = auto)")
    ap.add_argument("--node-port", type=int, default=0,
                    help="TCP port for this node service (0 = auto)")
    ap.add_argument("--advertise-host", default="127.0.0.1")
    ap.add_argument("--num-cpus", type=float, default=None)
    ap.add_argument("--num-gpus", "--num-tpus", dest="num_gpus",
                    type=float, default=None,
                    help="GPU slots (default: the CUDA devices this "
                         "process sees; --num-tpus means the same)")
    ap.add_argument("--resources", default="{}",
                    help="extra custom resources as JSON")
    ap.add_argument("--labels", default="{}")
    ap.add_argument("--session-dir", default=None)
    ap.add_argument("--ready-file", default=None)
    ap.add_argument("--job-port", type=int, default=0,
                    help="head only: REST port for job submission (0 = auto)")
    ap.add_argument("--dashboard-port", type=int, default=0,
                    help="head only: dashboard HTTP port (0 = auto, "
                         "-1 = disabled)")
    ap.add_argument("--http-host", default="127.0.0.1",
                    help="bind address for the dashboard + job REST "
                         "servers (default loopback; set 0.0.0.0 to "
                         "expose on all interfaces)")
    ap.add_argument("--storage", default=None,
                    help="head only: GCS persistence path (journal file "
                         "or directory); durable KV/jobs/PG metadata "
                         "survives a head restart")
    args = ap.parse_args(argv)

    if bool(args.head) == bool(args.address):
        ap.error("exactly one of --head / --address is required")

    from .gcs import GlobalControlPlane
    from .gcs_service import GcsServer, RemoteControlPlane
    from .gpus import visible_gpu_count
    from .node import NodeService

    session_dir = args.session_dir or tempfile.mkdtemp(prefix="rtpt_node_")
    resources = dict(json.loads(args.resources))
    resources.setdefault(
        "CPU", float(args.num_cpus if args.num_cpus is not None
                     else os.cpu_count() or 4))
    if "GPU" not in resources:
        gpus = (args.num_gpus if args.num_gpus is not None
                else visible_gpu_count())
        if gpus:
            resources["GPU"] = float(gpus)

    gcs_server = None
    if args.head:
        from .gcs_storage import open_storage
        plane = GlobalControlPlane(storage=open_storage(args.storage))
        # bound journal growth from the previous life before serving
        if args.storage:
            plane.compact_storage()
        gcs_server = GcsServer(plane, port=args.gcs_port)
        gcs = plane
        gcs_port = gcs_server.port
    else:
        gcs = RemoteControlPlane(args.address)
        gcs_port = int(args.address.rsplit(":", 1)[1])

    node = NodeService(gcs, session_dir, resources)
    node.start(labels=json.loads(args.labels), tcp_port=args.node_port,
               advertise_host=args.advertise_host)
    job_rest = None
    job_port = None
    if args.head:
        # drivers attaching by GCS address find the head node here
        gcs.kv_put(b"__rtpu_head_node",
                   json.dumps({"node_id": node.node_id.hex(),
                               "address": node.tcp_address,
                               "host": node.host,
                               "shm_probe": [node.shm_probe_path,
                                             node.shm_probe_token]}).encode())
        # advertise an address something actually listens on: a loopback
        # bind must not be advertised as the external advertise_host
        http_adv = (args.advertise_host if args.http_host == "0.0.0.0"
                    else args.http_host)
        # job submission API (reference: dashboard job head)
        from ..job.http_server import JobRestServer
        from ..job.manager import JobManager
        manager = JobManager(
            gcs, cluster_address=f"{args.advertise_host}:{gcs_port}",
            session_dir=session_dir)
        job_rest = JobRestServer(manager, host=args.http_host,
                                 port=args.job_port)
        job_rest.start()
        job_port = job_rest.port
        gcs.kv_put(b"__rtpu_job_api",
                   f"{http_adv}:{job_port}".encode())

    dashboard = None
    dashboard_port = None
    if args.head and args.dashboard_port >= 0:
        from ..dashboard import DashboardServer
        dashboard = DashboardServer(node, job_manager=manager,
                                    host=args.http_host,
                                    port=args.dashboard_port)
        dashboard.start()
        dashboard_port = dashboard.port
        gcs.kv_put(b"__rtpu_dashboard",
                   f"{http_adv}:{dashboard_port}".encode())

    ready = {"node_id": node.node_id.hex(), "gcs_port": gcs_port,
             "node_address": node.tcp_address, "session_dir": session_dir,
             "job_port": job_port, "dashboard_port": dashboard_port}
    line = json.dumps(ready)
    if args.ready_file:
        tmp = args.ready_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(line)
        os.replace(tmp, args.ready_file)
    print(line, flush=True)

    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        while not stop.wait(0.5):
            if not args.head and getattr(gcs, "closed", False):
                # head is gone; a node without a control plane is useless
                break
    finally:
        node.stop()
        if dashboard is not None:
            dashboard.stop()
        if job_rest is not None:
            job_rest.stop()
        if gcs_server is not None:
            gcs_server.stop()
        if args.head:
            gcs.close_storage()
    return 0


if __name__ == "__main__":
    sys.exit(main())
