"""ray_tpu_torch.util.metrics, the user-metric surface over the port's
telemetry: the cases of tests/test_telemetry.py that go through
``util.metrics`` (the exposition's golden file, kind inference, digest
summaries, retired gauges, the trace exemplar and the cluster scrape with
serve and the dashboard), user metrics recorded in workers and read back
by the driver, and the exposition held equal to ray_tpu's on the same
snapshots."""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import telemetry
from ray_tpu_torch._private.gcs import GlobalControlPlane
from ray_tpu_torch.util import metrics as rmetrics

HERE = os.path.dirname(__file__)

GOLDEN_SNAP = {
    "counters": {
        ("rtpu_test_requests_total", (("route", "a"),)): 3.0,
        ("rtpu_test_requests_total", (("route", "b"),)): 1.0,
    },
    "gauges": {("rtpu_test_depth", ()): (7.0, 123.0)},
    "hists": {
        ("rtpu_test_latency_seconds", (("node", "n1"),)): {
            "buckets": (0.1, 1.0), "counts": [1, 1, 1],
            "sum": 5.55, "count": 3,
            "exemplar": {"trace_id": "abcd1234", "value": 0.5,
                         "ts": 111.0}},
    },
    "meta": {
        "rtpu_test_requests_total": {
            "kind": "counter", "description": "test requests"},
        "rtpu_test_depth": {
            "kind": "gauge", "description": "queue depth"},
        "rtpu_test_latency_seconds": {
            "kind": "histogram", "description": "latency",
            "buckets": (0.1, 1.0)},
    },
    "dropped_series": 0,
}

DIGEST_SNAP = {
    "digests": {("rtpu_test_latency_digest_seconds",
                 (("deployment", "d"),)): {
        "centroids": [[0.1, 50.0], [0.9, 50.0]],
        "count": 100, "sum": 50.0, "min": 0.1, "max": 0.9}},
    "meta": {"rtpu_test_latency_digest_seconds": {
        "kind": "digest", "description": "latency digest"}},
}


@pytest.fixture
def rtpu_init():
    """The port's runtime per test, as conftest's is ray_tpu's."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


# --- copies of tests/test_telemetry.py's util.metrics cases -----------------

def test_prometheus_exposition_golden():
    """Golden-file pin of the text exposition: # HELP + one # TYPE per
    metric NAME (not per series), tagged series, cumulative le buckets,
    +Inf, _sum/_count, and a bucket exemplar."""
    text = rmetrics.format_prometheus(GOLDEN_SNAP)
    with open(os.path.join(HERE, "golden",
                           "metrics_exposition.golden")) as f:
        assert text == f.read()
    assert text.count("# TYPE rtpu_test_requests_total counter") == 1
    assert text.count("# HELP rtpu_test_requests_total") == 1


def test_exposition_without_meta_infers_kind():
    text = rmetrics.format_prometheus({
        "counters": {("orphan_total", ()): 2.0}, "meta": {}})
    assert "# TYPE orphan_total counter" in text
    assert "orphan_total 2.0" in text


def test_digest_prometheus_summary_exposition():
    text = rmetrics.format_prometheus(DIGEST_SNAP)
    assert "# TYPE rtpu_test_latency_digest_seconds summary" in text
    assert 'quantile="0.5"' in text and 'quantile="0.99"' in text
    assert ('rtpu_test_latency_digest_seconds_count'
            '{deployment="d"} 100') in text


def test_gauge_delete_retires_series_everywhere():
    """telemetry.gauge_delete ships a NaN marker that makes the plane
    (and local snapshots) FORGET the series, and the exposition never
    prints the marker."""
    name = "rtpu_test_retired_gauge"
    tags = (("case", "retire"),)
    key = (name, tags)
    telemetry.gauge_set(name, 7.0, tags)
    assert telemetry.snapshot_local()["gauges"][key][0] == 7.0
    p1 = telemetry._collect_deltas()
    plane = GlobalControlPlane()
    plane.record_metrics(p1)
    assert plane.metrics_snapshot()["gauges"][key][0] == 7.0
    telemetry.gauge_delete(name, tags)
    assert key not in telemetry.snapshot_local()["gauges"]
    p2 = telemetry._collect_deltas()
    marker = p2["gauges"][key][0]
    assert marker != marker
    telemetry._restore_deltas(p2)
    p3 = telemetry._collect_deltas()
    assert p3["gauges"][key][0] != p3["gauges"][key][0]
    plane.record_metrics(p3)
    assert key not in plane.metrics_snapshot()["gauges"]
    assert name not in rmetrics.format_prometheus(plane.metrics_snapshot())


def test_queue_wait_exemplar_links_trace(rtpu_init):
    """With tracing enabled, histogram samples recorded inside a span
    carry the trace_id as an exemplar through flush + export."""
    from ray_tpu_torch._private.config import CONFIG
    old = CONFIG._values["tracing_enabled"]
    CONFIG._values["tracing_enabled"] = True
    try:
        from ray_tpu_torch.util import tracing
        with tracing.start_span("telem-test") as span:
            telemetry.hist_observe("telem_exemplar_seconds", 0.02, ())
            trace_id = span["trace_id"]
        deadline = time.monotonic() + 5
        text = ""
        while time.monotonic() < deadline:
            text = rmetrics.export_prometheus()
            if f'trace_id="{trace_id}"' in text:
                break
            time.sleep(0.1)
        assert f'trace_id="{trace_id}"' in text
    finally:
        CONFIG._values["tracing_enabled"] = old


def test_cluster_scrape_covers_subsystems():
    """On a 2-node cluster running tasks, puts, one collective and one
    serve request, a single export_prometheus() scrape holds the
    scheduler's, the object store's, the collectives' and serve's metrics,
    and the dashboard's /api/metrics returns the same table as JSON (and
    /metrics the Prometheus text)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.comm import collective as col
    from ray_tpu_torch.dashboard import DashboardServer

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=cluster)
    try:
        cluster.add_node(num_cpus=2)

        @ray_tpu_torch.remote
        def f(x):
            return np.zeros(1024) + x

        ray_tpu_torch.get([f.remote(i) for i in range(4)])
        ray_tpu_torch.get(ray_tpu_torch.put(np.arange(8)))

        @ray_tpu_torch.remote(num_cpus=0)
        class Member(col.CollectiveActorMixin):
            def do_allreduce(self, x):
                return col.allreduce(np.asarray(x, np.float32),
                                     group_name="telem")

        members = [Member.remote() for _ in range(2)]
        col.create_collective_group(members, 2, [0, 1],
                                    group_name="telem")
        out = ray_tpu_torch.get([m.do_allreduce.remote([1.0, 2.0])
                                 for m in members])
        assert np.allclose(out[0], [2.0, 4.0])

        @serve.deployment
        def double(x):
            return x * 2

        try:
            handle = serve.run(double.bind())
            assert handle.remote(21).result(timeout=10) == 42

            wanted = ("rtpu_scheduler_", "rtpu_object_store_",
                      "rtpu_collective_", "rtpu_serve_")
            text = ""
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                text = rmetrics.export_prometheus()
                if all(w in text for w in wanted):
                    break
                time.sleep(0.25)
            missing = [w for w in wanted if w not in text]
            assert not missing, (f"scrape missing subsystems {missing}:\n"
                                 f"{text}")
            assert ("# TYPE rtpu_scheduler_tasks_submitted_total counter"
                    in text)

            server = DashboardServer(cluster.head, host="127.0.0.1")
            server.start()
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{server.port}/api/metrics",
                        timeout=10) as resp:
                    data = json.loads(resp.read())
                names = {m["name"] for m in data["metrics"]}
                for w in wanted:
                    assert any(n.startswith(w) for n in names), (w, names)
                sub = [m for m in data["metrics"]
                       if m["name"] == "rtpu_scheduler_tasks_submitted_total"]
                assert sum(m["value"] for m in sub) >= 4
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{server.port}/metrics",
                        timeout=10) as resp:
                    prom = resp.read().decode()
                assert "rtpu_scheduler_tasks_submitted_total" in prom
            finally:
                server.stop()
        finally:
            serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


# --- user metrics recorded in workers ---------------------------------------

def test_user_metrics_from_an_actor_reach_the_driver(rtpu_init):
    """A Counter, a Gauge and a Histogram (with tag keys and default tags)
    recorded inside an actor are read back by the driver through
    metrics_snapshot() and export_prometheus(); the histogram's count is
    the number of samples observed."""

    @ray_tpu_torch.remote(num_cpus=0)
    class Recorder:
        def __init__(self):
            from ray_tpu_torch.util import metrics as m
            self.steps = m.Counter("user_steps_total", "steps",
                                   tag_keys=("run",))
            self.depth = m.Gauge("user_queue_depth", "depth")
            self.ms = m.Histogram("user_step_ms", "step ms",
                                  boundaries=(10.0, 100.0, 1000.0),
                                  tag_keys=("run",))
            self.ms.set_default_tags({"run": "a"})

        def record(self, values):
            for v in values:
                self.steps.inc(tags={"run": "a"})
                self.ms.observe(v)
            self.depth.set(len(values))
            return len(values)

    rec = Recorder.remote()
    values = [5.0, 50.0, 500.0, 5000.0, 7.0]
    assert ray_tpu_torch.get(rec.record.remote(values)) == 5
    key = ("user_step_ms", (("run", "a"),))
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        snap = rmetrics.metrics_snapshot()
        if snap.get("hists", {}).get(key, {}).get("count") == len(values):
            break
        time.sleep(0.2)
    hist = snap["hists"][key]
    assert hist["count"] == len(values)
    assert hist["counts"] == [2, 1, 1, 1]
    assert hist["sum"] == pytest.approx(sum(values))
    assert snap["counters"][("user_steps_total", (("run", "a"),))] == 5.0
    assert snap["gauges"][("user_queue_depth", ())][0] == 5.0
    text = rmetrics.export_prometheus()
    assert "# TYPE user_step_ms histogram" in text
    assert 'user_step_ms_count{run="a"} 5' in text
    assert 'user_step_ms_bucket{run="a",le="+Inf"} 5' in text


def test_metrics_http_serves_the_exposition(rtpu_init):
    rmetrics.Counter("user_http_total", "hits").inc(3)
    url = rmetrics.start_metrics_http()
    with urllib.request.urlopen(url, timeout=10) as resp:
        body = resp.read().decode()
    assert "user_http_total 3.0" in body


def test_counter_refuses_negative_increments():
    with pytest.raises(ValueError):
        rmetrics.Counter("user_neg_total").inc(-1)


# --- parity: the same snapshots give ray_tpu's exposition -------------------

@pytest.mark.parametrize("snap", ["golden", "digest"])
def test_exposition_equals_jax(snap):
    from ray_tpu.util import metrics as jmetrics

    s = {"golden": GOLDEN_SNAP, "digest": DIGEST_SNAP}[snap]
    for exemplars in (True, False):
        assert (rmetrics.format_prometheus(s, include_exemplars=exemplars)
                == jmetrics.format_prometheus(s,
                                              include_exemplars=exemplars))


def test_recorded_samples_equal_jax():
    """The same records through both packages' metric classes leave the
    same local samples."""
    from ray_tpu._private import telemetry as jtelemetry
    from ray_tpu.util import metrics as jmetrics

    def record(m, suffix):
        m.Counter(f"par_c_{suffix}", tag_keys=("k",)).inc(2.5,
                                                          tags={"k": "x"})
        m.Gauge(f"par_g_{suffix}").set(-4.0)
        h = m.Histogram(f"par_h_{suffix}", boundaries=(1.0, 2.0))
        for v in (0.5, 1.5, 1.5, 9.0):
            h.observe(v)

    record(rmetrics, "port")
    record(jmetrics, "jax")

    def mine(snap, suffix):
        out = {}
        for kind in ("counters", "hists"):
            for (name, tags), v in snap[kind].items():
                if name.endswith(suffix):
                    out[kind, name.replace(suffix, ""), tags] = v
        for (name, tags), (v, _ts) in snap["gauges"].items():
            if name.endswith(suffix):
                out["gauges", name.replace(suffix, ""), tags] = v
        return out

    got = mine(telemetry.snapshot_local(), "port")
    want = mine(jtelemetry.snapshot_local(), "jax")
    assert got and got == want
