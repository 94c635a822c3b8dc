"""State API, timeline, metrics, and CLI tests on ray_tpu_torch (copies
of tests/test_state_cli.py; the timeline is held to the same golden file
as ray_tpu's)."""

import json
import subprocess
import sys
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import state as rstate
from ray_tpu_torch.util import metrics as rmetrics


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


def test_list_tasks_and_actors(rtpu_init):
    @ray_tpu_torch.remote
    def work(x):
        return x

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "pong"

    ray_tpu_torch.get([work.remote(i) for i in range(3)])
    a = A.options(name="state_actor").remote()
    ray_tpu_torch.get(a.ping.remote())

    tasks = rstate.list_tasks()
    # names are __qualname__ — closures carry a <locals> prefix
    assert any(t["name"].endswith("work") and t["state"] == "FINISHED"
               for t in tasks)
    actors = rstate.list_actors()
    assert any(r["class_name"] == "A" and r["state"] == "ALIVE"
               for r in actors)
    workers = rstate.list_workers()
    assert workers and all("pid" in w for w in workers)

    summary = rstate.summarize_tasks()
    assert summary["total"] >= 3
    work_counts = [v for k, v in summary["by_func"].items()
                   if k.endswith("work")]
    assert work_counts and work_counts[0]["FINISHED"] == 3


@ray_tpu_torch.remote
def golden_task():
    time.sleep(0.02)
    return 1


_GOLDEN_RID = "feedbead00000000"
_GOLDEN_REQUEST_SPANS = {
    "request::ingress", "request::queue_wait",
    "request::replica_execute", "actor_call::Replica.handle_request",
}


def test_timeline_golden_file(rtpu_init, tmp_path):
    """Golden-file pin of the ``state.timeline()`` Chrome-trace JSON:
    event shape (name/cat/ph/args) byte-exact, variable fields (ts, dur,
    node/task/trace ids) normalized after type/positivity checks.
    Includes a collective flight-recorder span AND one serve request
    lane (a traced HTTP request renders as ``cat: "request"`` events —
    ingress/queue-wait/replica-execute plus the request's actor-call
    spans — keyed by its request id).
    Complements the span-based ``trace_timeline`` coverage in
    ``test_tracing_events.py``."""
    import os
    import urllib.request

    import numpy as np

    from ray_tpu_torch import serve
    from ray_tpu_torch.comm import collective as col

    ray_tpu_torch.get([golden_task.remote() for _ in range(2)])
    # a world-1 collective on the driver: its flight-recorder record
    # must show up as a deterministic `coll::allreduce` span
    col.init_collective_group(1, 0, group_name="tl")
    col.allreduce(np.ones(8, np.float32), group_name="tl")
    col.destroy_collective_group("tl")

    @serve.deployment
    def golden_echo(x):
        return {"ok": True}

    try:
        serve.run(golden_echo.bind())
        url = serve.start_http(port=0)
        req = urllib.request.Request(
            f"{url}/golden_echo", data=json.dumps({"x": 1}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-ID": _GOLDEN_RID})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read())["result"] == {"ok": True}
        # replica-side spans ship at the actor call's task boundary —
        # poll until the request lane is complete, then snapshot
        trace = None
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            out = str(tmp_path / "trace.json")
            assert rstate.timeline(out) == out
            with open(out) as f:
                trace = json.load(f)
            lane = {e["name"] for e in trace
                    if e.get("cat") == "request"}
            if _GOLDEN_REQUEST_SPANS <= lane:
                break
            time.sleep(0.3)
    finally:
        serve.shutdown()

    normalized = []
    for ev in sorted(trace, key=lambda e: (e["name"], e["ts"])):
        assert isinstance(ev["ts"], float) and ev["ts"] > 0
        assert isinstance(ev["dur"], float) and ev["dur"] > 0
        if ev["cat"] == "collective":
            assert ev["pid"].startswith("coll:")
            pid = ev["pid"]                     # group name: literal
            tid = ev["tid"]
            args = ev["args"]
        elif ev["cat"] == "request":
            # fixed X-Request-ID => the lane's pid is literal; span/
            # trace/task ids are random and normalize away
            assert ev["pid"] == f"request:{_GOLDEN_RID}"
            pid = ev["pid"]
            tid = "<tid>"
            args = {k: ("<id>" if k in ("trace_id", "span_id",
                                        "parent_id", "task_id")
                        and v is not None else v)
                    for k, v in sorted(ev["args"].items())}
        else:
            assert ev["pid"].startswith("node:")
            pid = "node:<node>"
            tid = "<tid>"
            args = ev["args"]
        normalized.append({
            "name": ev["name"].rsplit(".", 1)[-1],
            "cat": ev["cat"], "ph": ev["ph"],
            "ts": "<ts>", "dur": "<dur>",
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    golden_path = os.path.join(os.path.dirname(__file__), "golden",
                               "timeline.golden")
    with open(golden_path) as f:
        assert normalized == json.load(f)


def test_timeline_chrome_trace(rtpu_init, tmp_path):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(0.05)
        return 1

    ray_tpu_torch.get([slow.remote() for _ in range(2)])
    out = str(tmp_path / "trace.json")
    rstate.timeline(out)
    with open(out) as f:
        trace = json.load(f)
    spans = [e for e in trace if e["name"].endswith("slow")]
    assert len(spans) == 2
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in spans)


def test_metrics_counter_gauge_histogram(rtpu_init):
    c = rmetrics.Counter("test_requests", "reqs", tag_keys=("route",))
    g = rmetrics.Gauge("test_depth", "queue depth")
    h = rmetrics.Histogram("test_latency", "latency",
                           boundaries=(0.1, 1.0))
    c.inc(tags={"route": "a"})
    c.inc(2.0, tags={"route": "a"})
    g.set(7.0)
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    time.sleep(0.3)     # fire-and-forget records land

    text = rmetrics.export_prometheus()
    assert 'test_requests{route="a"} 3.0' in text
    assert "test_depth 7.0" in text
    assert "test_latency_count 3" in text
    assert 'test_latency_bucket{le="0.1"} 1' in text

    url = rmetrics.start_metrics_http()
    with urllib.request.urlopen(url, timeout=5) as resp:
        body = resp.read().decode()
    assert "test_depth 7.0" in body


def test_metrics_from_workers(rtpu_init):
    @ray_tpu_torch.remote
    def emit(i):
        from ray_tpu_torch.util.metrics import Counter
        Counter("worker_side_events", "").inc()
        return i

    ray_tpu_torch.get([emit.remote(i) for i in range(4)])
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if "worker_side_events 4.0" in rmetrics.export_prometheus():
            break
        time.sleep(0.1)
    assert "worker_side_events 4.0" in rmetrics.export_prometheus()


def test_cli_subprocess(rtpu_init):
    @ray_tpu_torch.remote
    def job(x):
        return x

    ray_tpu_torch.get([job.remote(i) for i in range(2)])
    import numpy as np
    big = ray_tpu_torch.put(np.zeros(150_000, dtype=np.uint8))  # noqa: F841
    time.sleep(0.2)                       # provenance flush cadence
    session = ray_tpu_torch._session_dir
    for argv in (["status"], ["list", "tasks"], ["summary", "tasks"],
                 ["memory"], ["memory", "--group-by", "creator",
                              "--sort-by", "count", "--objects"],
                 ["memory", "--format", "json"]):
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
             "--session", session] + argv,
            capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, (argv, out.stderr)
    memory = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--session",
         session, "memory", "--objects"],
        capture_output=True, text=True, timeout=60)
    # grouped rollup names the put's callsite, objects table the ref type
    assert "test_torch_state_cli.py" in memory.stdout, memory.stdout
    assert "LOCAL_REFERENCE" in memory.stdout, memory.stdout
    status = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--session",
         session, "status"], capture_output=True, text=True, timeout=60)
    assert "Nodes: 1 alive" in status.stdout


def test_list_jobs(rtpu_init):
    from ray_tpu_torch.state import api as state_api

    jobs = state_api.list_jobs()
    assert len(jobs) == 1                    # this driver's job
    assert jobs[0]["driver_pid"] > 0
    assert jobs[0]["end_time"] is None       # still running
