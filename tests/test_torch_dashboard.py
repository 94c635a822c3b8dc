"""Dashboard tests on ray_tpu_torch (copies of tests/test_dashboard.py;
reference analogue: ``dashboard/tests`` — the API modules serving cluster
state over HTTP)."""

import json
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.dashboard import DashboardServer


def _check_sanitizers():
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


@pytest.fixture
def rtpu_init():
    """The port's runtime per test, as conftest's is ray_tpu's."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    _check_sanitizers()


def _fetch(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return resp.status, resp.read()


def _fetch_json(port, path):
    status, body = _fetch(port, path)
    assert status == 200, (path, body)
    return json.loads(body)


@pytest.fixture
def dashboard(rtpu_init):
    server = DashboardServer(ray_tpu_torch._global_node, host="127.0.0.1")
    server.start()
    yield server
    server.stop()


@ray_tpu_torch.remote
def _work(x):
    return x + 1


@ray_tpu_torch.remote
class _Stateful:
    def ping(self):
        return "pong"


def test_cluster_endpoint(dashboard):
    data = _fetch_json(dashboard.port, "/api/cluster")
    assert data["num_nodes"] == 1
    assert data["resources_total"].get("CPU") == 4.0
    assert 0.0 < data["memory"]["usage_fraction"] < 1.0


def test_tasks_and_summary(dashboard):
    assert ray_tpu_torch.get([_work.remote(i) for i in range(4)],
                       timeout=60) == [1, 2, 3, 4]
    tasks = _fetch_json(dashboard.port, "/api/tasks")["tasks"]
    finished = [t for t in tasks if t["state"] == "FINISHED"]
    assert len(finished) >= 4
    summary = _fetch_json(dashboard.port, "/api/summary")
    assert summary["tasks"]["by_state"].get("FINISHED", 0) >= 4


def test_actors_endpoint(dashboard):
    a = _Stateful.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    actors = _fetch_json(dashboard.port, "/api/actors")["actors"]
    assert any(r["class_name"] == "_Stateful" and r["state"] == "ALIVE"
               for r in actors)


def test_nodes_objects_pgs_workers(dashboard):
    ref = ray_tpu_torch.put(list(range(100_000)))       # large -> directory entry
    assert ray_tpu_torch.get(ref, timeout=30)[0] == 0
    nodes = _fetch_json(dashboard.port, "/api/nodes")["nodes"]
    assert len(nodes) == 1 and nodes[0]["alive"]
    objs = _fetch_json(dashboard.port, "/api/objects")["objects"]
    assert any(o["size"] > 100_000 for o in objs)
    assert "placement_groups" in _fetch_json(dashboard.port,
                                             "/api/placement_groups")
    workers = _fetch_json(dashboard.port, "/api/workers")["workers"]
    assert len(workers) >= 1


def test_memory_endpoint(dashboard):
    import time

    import numpy as np

    from ray_tpu_torch import state as rstate  # noqa: F401 — surfaces loaded

    big = ray_tpu_torch.put(np.zeros(120_000, dtype=np.uint8))  # noqa: F841
    time.sleep(0.2)                       # provenance flush cadence
    data = _fetch_json(dashboard.port, "/api/memory")
    assert data["summary"]["total_objects"] >= 1
    assert data["summary"]["total_bytes"] >= 120_000
    assert data["leaks"] == []
    assert data["stores"]
    rows = data["objects"]
    mine = [r for r in rows
            if "test_torch_dashboard.py" in (r.get("callsite") or "")]
    assert mine, rows
    assert mine[0]["ref_types"].get("LOCAL_REFERENCE", 0) >= 1


def test_serve_endpoint(dashboard):
    """GET /api/serve shapes the request-observability plane (latency/
    queue digests, queue depth, replica table, error rate) from the
    head's merged metrics table — no client in the serving process."""
    import time

    from ray_tpu_torch import serve

    @serve.deployment
    def pong(x):
        return {"pong": x}

    try:
        handle = serve.run(pong.bind())
        for i in range(3):
            assert handle.remote(i).result(timeout=15) == {"pong": i}
        deadline = time.monotonic() + 15
        dep = None
        while time.monotonic() < deadline:
            data = _fetch_json(dashboard.port, "/api/serve")
            dep = (data["serve"].get("deployments") or {}).get("pong")
            if dep and (dep.get("latency") or {}).get("count", 0) >= 3:
                break
            time.sleep(0.25)
        assert dep, "deployment never reached /api/serve"
        assert dep["latency"]["p50"] > 0 and dep["latency"]["p99"] > 0
        assert dep["requests_total"] >= 3 and dep["error_rate"] == 0.0
        assert dep["replicas"] and "queue_depth" in dep["replicas"][0]
    finally:
        serve.shutdown()


def test_html_page_and_404(dashboard):
    status, body = _fetch(dashboard.port, "/")
    assert status == 200 and b"ray_tpu_torch dashboard" in body
    with pytest.raises(urllib.error.HTTPError):
        _fetch(dashboard.port, "/api/nope")


def test_head_process_serves_dashboard():
    """The process-isolated head starts the dashboard and publishes its
    address in the cluster KV."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True, process_isolated=True,
                      head_node_args={"num_cpus": 2})
    try:
        port = cluster.head.ready.get("dashboard_port")
        assert port
        data = _fetch_json(port, "/api/cluster")
        assert data["num_nodes"] >= 1
        assert _fetch_json(port, "/api/jobs")["jobs"] == []
    finally:
        cluster.shutdown()


def test_history_and_task_drilldown(dashboard):
    """Dashboard v1: utilization time series accumulates while a
    workload runs; a task's state transitions are queryable by id
    The port's samples count GPU slots (``gpu_total``/``gpu_used``)
    where ray_tpu's count TPUs."""
    import json
    import time
    import urllib.request

    base = f"http://127.0.0.1:{dashboard.port}"

    @ray_tpu_torch.remote
    def work(x):
        time.sleep(0.05)
        return x

    refs = [work.remote(i) for i in range(8)]
    ray_tpu_torch.get(refs)
    deadline = time.monotonic() + 45
    samples = []
    while time.monotonic() < deadline:
        with urllib.request.urlopen(f"{base}/api/history",
                                    timeout=10) as r:
            samples = json.loads(r.read())["samples"]
        # wait for a sample taken AFTER the workload completed
        if len(samples) >= 2 and samples[-1]["tasks_finished"] >= 8:
            break
        time.sleep(1.0)
    assert len(samples) >= 2
    assert {"ts", "cpu_total", "cpu_used", "gpu_total", "gpu_used",
            "tasks_running", "tasks_finished",
            "store_used_bytes"} <= set(samples[-1])
    assert not {"tpu_total", "tpu_used"} & set(samples[-1])
    assert samples[-1]["tasks_finished"] >= 8

    tid = refs[0].task_id().hex()
    with urllib.request.urlopen(f"{base}/api/task/{tid}",
                                timeout=10) as r:
        out = json.loads(r.read())
    states = [e["state"] for e in out["events"]]
    assert "FINISHED" in states
    assert all(e["task_id"] == tid for e in out["events"])
