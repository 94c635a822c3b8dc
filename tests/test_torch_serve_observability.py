"""End-to-end request observability on ray_tpu_torch.serve (copies of
tests/test_serve_observability.py): request ids, one request = one trace,
streaming percentile digests, the per-replica access-log ring, slow/error
event promotion, and the serve health / requests surfaces."""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch import state as rstate


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


@pytest.fixture
def serve_session(rtpu_init):
    yield
    serve.shutdown()


def _wait(predicate, timeout=15.0, period=0.25):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        last = predicate()
        if last:
            return last
        time.sleep(period)
    return last


def test_one_request_one_trace_acceptance(serve_session):
    """Request observability's acceptance: one HTTP request to a
    deployment that itself calls a nested .remote() task produces a
    SINGLE trace —
    ingress, queue-wait, replica-execute and the nested task span all
    share the request's trace id and render as one ``cat: "request"``
    lane in state.timeline(); serve_health reports non-zero p50/p99
    latency and queue-wait digests for the deployment."""

    @ray_tpu_torch.remote
    def nested(x):
        return x + 1

    @serve.deployment
    def traced(body):
        return {"rid": serve.get_request_id(),
                "v": ray_tpu_torch.get(nested.remote(1))}

    serve.run(traced.bind())
    url = serve.start_http(port=0)
    rid = "feedc0de00112233"
    req = urllib.request.Request(
        f"{url}/traced", data=json.dumps({"hi": 1}).encode(),
        headers={"Content-Type": "application/json",
                 "X-Request-ID": rid})
    with urllib.request.urlopen(req, timeout=30) as resp:
        payload = json.loads(resp.read())
        assert resp.headers.get("X-RTPU-Request-ID") == rid
    # the handler saw ITS request's id
    assert payload["result"]["rid"] == rid
    assert payload["result"]["v"] == 2

    def lane():
        events = [e for e in rstate.timeline()
                  if e.get("cat") == "request"
                  and e["pid"] == f"request:{rid}"]
        names = {e["name"] for e in events}
        if ({"request::ingress", "request::queue_wait",
             "request::replica_execute"} <= names
                and any(n.startswith("task::") for n in names)):
            return events
        return None

    events = _wait(lane, timeout=20)
    assert events, "request lane never assembled in state.timeline()"
    # one trace: every span in the lane carries the same trace id
    trace_ids = {e["args"]["trace_id"] for e in events}
    assert len(trace_ids) == 1, trace_ids
    ingress = next(e for e in events if e["name"] == "request::ingress")
    assert ingress["args"]["request_id"] == rid
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in events)

    # serve_health: non-zero latency AND queue-wait digests
    def health():
        dep = (rstate.serve_health().get("deployments")
               or {}).get("traced")
        if dep and (dep.get("latency") or {}).get("p50", 0) > 0 \
                and (dep.get("queue_wait") or {}).get("count", 0) > 0 \
                and dep.get("requests_total", 0) >= 1:
            return dep
        return None

    dep = _wait(health, timeout=20)
    assert dep, "digests never reached serve_health"
    assert dep["latency"]["p50"] > 0 and dep["latency"]["p99"] > 0
    assert dep["latency"]["p99"] >= dep["latency"]["p50"]
    assert dep["requests_total"] >= 1 and dep["error_rate"] == 0.0
    assert dep["replicas"], dep


def test_request_ids_and_access_log_python_handle(serve_session):
    """Plain Python handle.remote() requests get ids too; the replica
    ring records one structured row per request with latency and
    queue wait."""

    @serve.deployment
    def echo(x):
        return {"rid": serve.get_request_id(), "x": x}

    handle = serve.run(echo.bind())
    rids = set()
    for i in range(5):
        out = handle.remote(i).result(timeout=15)
        assert out["x"] == i and out["rid"]
        rids.add(out["rid"])
    assert len(rids) == 5                      # distinct per request

    rows = _wait(lambda: (r := rstate.serve_requests())
                 and len(r) >= 5 and r)
    assert rows, "access log never filled"
    assert {r["request_id"] for r in rows} >= rids
    for r in rows:
        assert r["deployment"] == "echo" and r["status"] == "ok"
        assert r["latency_s"] > 0 and r["queue_wait_s"] >= 0
        assert r["route"] == "/echo" and r["proto"] == "python"


def test_slow_and_error_requests_promote_events(serve_session):
    """Failures promote to REQUEST_ERROR; requests over the threshold
    promote to SLOW_REQUEST (threshold set replica-side — workers
    don't see the driver's _system_config)."""

    @serve.deployment
    class Sloth:
        def __init__(self):
            from ray_tpu_torch._private.config import CONFIG
            CONFIG._values["serve_slow_request_threshold_s"] = 0.05

        def __call__(self, x):
            if isinstance(x, dict) and x.get("boom"):
                raise ValueError("kaboom-marker")
            time.sleep(0.08)
            return x

    handle = serve.run(Sloth.bind())
    assert handle.remote(1).result(timeout=15) == 1
    with pytest.raises(Exception, match="kaboom-marker"):
        handle.remote({"boom": True}).result(timeout=15)

    def events():
        evs = rstate.list_cluster_events()
        labels = {e.get("label") for e in evs}
        if {"SLOW_REQUEST", "REQUEST_ERROR"} <= labels:
            return evs
        return None

    evs = _wait(events, timeout=20)
    assert evs, "request events never promoted"
    slow = next(e for e in evs if e.get("label") == "SLOW_REQUEST")
    assert slow["deployment"] == "Sloth" and slow["request_id"]
    assert slow["severity"] == "WARNING"
    err = next(e for e in evs if e.get("label") == "REQUEST_ERROR")
    assert "kaboom-marker" in (err.get("error") or err["message"])

    # access-log filters see the same facts
    errs = _wait(lambda: rstate.serve_requests(errors=True))
    assert errs and all(r["status"] == "error" for r in errs)
    slows = _wait(lambda: rstate.serve_requests(slow=True))
    assert slows and all(r["latency_s"] >= 0.05 for r in slows)

    # doctor names the worst deployment
    rep = rstate.health_report()
    assert rep["serve"]["worst"] == "Sloth"
    assert "Sloth" in rep["serve"]["deployments"]


def test_batch_assembly_digest_and_span(serve_session):
    """@serve.batch stamps each member's batch size into its access
    row, records the per-deployment batch-size digest, and emits one
    request::batch_assemble span per assembled batch."""

    import concurrent.futures

    @serve.deployment(max_concurrent_queries=8)
    class Model:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
        def _infer(self, xs):
            return [x * 2 for x in xs]

        def __call__(self, x):
            return self._infer(x)

    serve.run(Model.bind())
    # through the HTTP gateway so requests are traced: the batch span
    # parents to a member's ingress trace
    url = serve.start_http(port=0)

    def post(i):
        req = urllib.request.Request(
            f"{url}/Model", data=json.dumps(i).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())["result"]

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        out = sorted(pool.map(post, range(8)))
    assert out == [i * 2 for i in range(8)]

    def digest():
        dep = (rstate.serve_health().get("deployments")
               or {}).get("Model")
        if dep and (dep.get("batch_size") or {}).get("count", 0) > 0:
            return dep
        return None

    dep = _wait(digest, timeout=20)
    assert dep and dep["batch_size"]["max"] > 1, dep
    rows = rstate.serve_requests()
    assert any((r.get("batch_size") or 0) > 1 for r in rows), rows
    spans = _wait(lambda: [
        e for e in rstate.timeline()
        if e.get("cat") == "request"
        and e["name"] == "request::batch_assemble"])
    assert spans and spans[0]["args"]["batch_size"] > 1


def test_request_plane_disable_restores_bare_path(serve_session):
    """request_log_capacity=0 in the replica process disables the
    plane: no rows, no batch stamps, and get_request_id() is empty
    inside the handler."""

    @serve.deployment
    class Bare:
        def __init__(self):
            from ray_tpu_torch._private.config import CONFIG
            CONFIG._values["request_log_capacity"] = 0

        def __call__(self, x):
            return {"rid": serve.get_request_id(), "x": x}

    handle = serve.run(Bare.bind())
    out = handle.remote(7).result(timeout=15)
    assert out == {"rid": "", "x": 7}
    time.sleep(0.5)
    assert rstate.serve_requests() == []


def test_capacity_bounds_the_ring(serve_session):
    """The access log is a fixed-capacity ring: N+K requests keep only
    the newest N rows."""

    @serve.deployment
    class Tiny:
        def __init__(self):
            from ray_tpu_torch._private.config import CONFIG
            CONFIG._values["request_log_capacity"] = 4

        def __call__(self, x):
            return x

    handle = serve.run(Tiny.bind())
    for i in range(10):
        assert handle.remote(i).result(timeout=15) == i
    rows = _wait(lambda: rstate.serve_requests(limit=100))
    assert rows and len(rows) == 4


def test_grpc_request_id_roundtrip(serve_session):
    """The gRPC ingress honors a caller-supplied request_id (the
    X-Request-ID analogue) and the handler observes it."""
    pytest.importorskip("grpc")

    @serve.deployment
    def gecho(x):
        return {"rid": serve.get_request_id(), "x": x}

    serve.run(gecho.bind())
    addr = serve.start_grpc()
    try:
        import grpc
        from ray_tpu_torch.serve.grpc_ingress import SERVICE
        req = {"deployment": "gecho", "arg": 5,
               "request_id": "abad1dea00000001"}
        with grpc.insecure_channel(addr) as ch:
            fn = ch.unary_unary(f"/{SERVICE}/Call",
                                request_serializer=lambda b: b,
                                response_deserializer=lambda b: b)
            out = json.loads(fn(json.dumps(req).encode(), timeout=30))
        assert out["result"] == {"rid": "abad1dea00000001", "x": 5}
        rows = _wait(lambda: [r for r in rstate.serve_requests()
                              if r["proto"] == "grpc"])
        assert rows and rows[-1]["request_id"] == "abad1dea00000001"
    finally:
        serve.stop_grpc()


def test_cli_serve_status_and_requests(serve_session):
    """What `rtpt serve-status` and `rtpt requests` render, read through
    the state calls they make (the CLI's own form is the next test): the
    health table's row with its p99, the access rows with their request
    ids, and the JSON form's limit."""

    @serve.deployment
    def cliecho(x):
        return x

    handle = serve.run(cliecho.bind())
    for i in range(3):
        assert handle.remote(i).result(timeout=15) == i

    # digests flush on the maybe_flush cadence; give them a beat
    def visible():
        dep = (rstate.serve_health().get("deployments")
               or {}).get("cliecho")
        return dep and (dep.get("latency") or {}).get("count", 0) >= 3

    assert _wait(visible, timeout=20)
    assert ray_tpu_torch._session_dir     # the session the CLI attaches to
    status = rstate.serve_health()
    dep = status["deployments"]["cliecho"]
    assert dep["latency"]["p99"] > 0
    assert dep["requests_total"] >= 3 and dep["error_rate"] == 0.0
    json.dumps(status, default=str)       # the --format json form
    rows = rstate.serve_requests(limit=100)
    assert any(r["deployment"] == "cliecho" for r in rows)
    assert all(r["request_id"] for r in rows)
    limited = rstate.serve_requests(limit=2)
    assert len(json.loads(json.dumps(limited, default=str))) <= 2


def test_cli_serve_status_and_requests_cli(serve_session):
    """`rtpt serve-status` and `rtpt requests` attach to the session
    and render the health table / access rows (the CLI form of the test
    above, as ray_tpu's test runs it)."""
    import subprocess
    import sys

    @serve.deployment
    def cliecho(x):
        return x

    handle = serve.run(cliecho.bind())
    for i in range(3):
        assert handle.remote(i).result(timeout=15) == i

    def visible():
        dep = (rstate.serve_health().get("deployments")
               or {}).get("cliecho")
        return dep and (dep.get("latency") or {}).get("count", 0) >= 3

    assert _wait(visible, timeout=20)
    session = ray_tpu_torch._session_dir
    status = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--session",
         session, "serve-status"],
        capture_output=True, text=True, timeout=60)
    assert status.returncode == 0, status.stderr
    assert "cliecho" in status.stdout and "p99" in status.stdout
    reqs = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--session",
         session, "requests"],
        capture_output=True, text=True, timeout=60)
    assert reqs.returncode == 0, reqs.stderr
    assert "cliecho" in reqs.stdout and "request_id" in reqs.stdout
    reqs_json = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--session",
         session, "requests", "--format", "json", "--limit", "2"],
        capture_output=True, text=True, timeout=60)
    assert reqs_json.returncode == 0, reqs_json.stderr
    assert len(json.loads(reqs_json.stdout)) <= 2


def test_scale_down_zeroes_dead_replica_gauge(serve_session):
    """A stopped replica's queue-depth gauge row is zeroed by the
    controller (latest-ts-wins on the plane), so serve_health's queue
    sum and replica table don't carry a dead replica's last value
    forever."""

    @serve.deployment(num_replicas=2)
    class Busy:
        def __call__(self, x):
            time.sleep(0.05)
            return x

    app = Busy.bind()
    handle = serve.run(app)
    # drive both replicas so both publish non-zero depths at some point
    rs = [handle.remote(i) for i in range(8)]
    assert sorted(r.result(timeout=20) for r in rs) == list(range(8))

    def two_replicas():
        dep = (rstate.serve_health().get("deployments") or {}).get("Busy")
        return dep if dep and len(dep.get("replicas") or []) >= 2 else None

    assert _wait(two_replicas, timeout=20)

    # scale down to 1: the stopped replica's row is tombstoned by the
    # controller and drops out of the table and the queue sum
    serve.run(Busy.options(num_replicas=1).bind())

    def settled():
        dep = (rstate.serve_health().get("deployments") or {}).get("Busy")
        if not dep:
            return None
        rows = dep.get("replicas") or []
        if len(rows) == 1 and dep["queue_depth"] == 0:
            return dep
        return None

    assert _wait(settled, timeout=20), rstate.serve_health()


def test_crashed_replica_gauge_retired(serve_session):
    """A replica that CRASHES — killed, not scaled down — must have its
    queue-depth gauge series
    deleted too. The controller's ~1/s replica-death observation routes
    the dead replica through the same gauge_delete/tombstone path the
    controlled-stop path uses: after the kill, exactly the survivors'
    rows remain in serve_health's replica table and queue sum."""

    @serve.deployment(num_replicas=2)
    class Crashy:
        def __call__(self, x):
            time.sleep(0.05)
            return x

    handle = serve.run(Crashy.bind())
    # drive both replicas so both publish non-zero depths at some point
    rs = [handle.remote(i) for i in range(8)]
    assert sorted(r.result(timeout=20) for r in rs) == list(range(8))

    def two_replicas():
        dep = (rstate.serve_health().get("deployments") or {}).get(
            "Crashy")
        return (dep if dep and len(dep.get("replicas") or []) >= 2
                else None)

    assert _wait(two_replicas, timeout=20)

    controller = ray_tpu_torch.get_actor("rtpu:serve_controller")
    replicas = ray_tpu_torch.get(controller.get_replicas.remote("Crashy"))
    assert len(replicas) == 2
    survivor_rows = None
    # CRASH (hard kill) one replica — no controlled-stop path runs
    ray_tpu_torch.kill(replicas[0])

    def only_survivors():
        dep = (rstate.serve_health().get("deployments") or {}).get(
            "Crashy")
        if not dep:
            return None
        rows = dep.get("replicas") or []
        return dep if len(rows) == 1 else None

    dep = _wait(only_survivors, timeout=25)
    assert dep, rstate.serve_health()
    survivor_rows = dep["replicas"]
    # exactly the survivor's row remains — and the queue sum carries
    # only its value (the dead replica's last depth is gone; the
    # replacement publishes nothing until it is driven)
    assert len(survivor_rows) == 1
    assert dep["queue_depth"] == survivor_rows[0]["queue_depth"]

    # the dead handle was dropped AND target capacity restored: the
    # survivor plus a freshly-tagged replacement, never the corpse
    def replaced():
        left = ray_tpu_torch.get(controller.get_replicas.remote("Crashy"))
        ids = [r.actor_id for r in left]
        return (left if (len(left) == 2
                         and replicas[1].actor_id in ids
                         and replicas[0].actor_id not in ids)
                else None)

    assert _wait(replaced, timeout=20)
