# A copy of tests/test_history.py on ray_tpu_torch's runtime: the same tests
# under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown. Docstrings leave
# out the JAX package's issue history.
"""Cluster history plane + black-box post-mortem bundles:
multi-resolution metrics retention, windowed queries with rate/delta
shaping, trend detection, the events ring's time filters + eviction
counter, lifecycle retention, bundle capture/load, and offline autopsy.
"""

import json
import os
import subprocess
import sys
import tarfile
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import state as rstate
from ray_tpu_torch._private import debug_bundle
from ray_tpu_torch._private import history as H
from ray_tpu_torch._private import telemetry as T
from ray_tpu_torch._private.config import CONFIG
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


def _wait(predicate, timeout=20.0, period=0.25):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        last = predicate()
        if last:
            return last
        time.sleep(period)
    return last


# ------------------------------------------------------ ring unit tests

def _mk_digest(values):
    d = T._Digest()
    for v in values:
        d.add(float(v))
    return d.to_payload()


def test_history_multiresolution_fold_and_query():
    """Fine frames every step; coarser levels sample cumulative values
    and MERGE interval digests, so a coarse frame's p95 covers its
    whole interval."""
    h = H.MetricsHistory(10, "1,5", 1 << 20)
    key_c = ("rtpu_x_total", (("node", "a"),))
    key_d = ("rtpu_serve_queue_wait_digest_seconds",
             (("deployment", "X"),))
    for i in range(30):
        h.record(1000.0 + i, {key_c: float(2 * i)}, {}, {},
                 {key_d: _mk_digest([0.01 * (i + 1)] * 4)})
    # finest level: 10 slots of 1s
    fine = h.query(window=8)
    assert fine["step_s"] == 1.0
    counter = [s for s in fine["series"] if s["name"] == "rtpu_x_total"][0]
    assert counter["kind"] == "counter"
    # cumulative values, exact at any resolution
    assert counter["points"][-1][1] == 58.0
    # a 25s window doesn't fit the fine ring -> the 5s level serves it
    coarse = h.query(window=25)
    assert coarse["step_s"] == 5.0
    dig = [s for s in coarse["series"] if s["name"] == key_d[0]][0]
    ts, v = dig["points"][-1]
    # the coarse frame's digest merged 5 fine intervals: 20 samples
    assert v["count"] == 20
    assert 0.2 < v["p95"] <= 0.31


def test_history_rate_delta_shaping_and_reset_clamp():
    pts = [[0.0, 10.0], [1.0, 14.0], [2.0, 2.0], [3.0, 6.0]]
    assert H.shape_points(pts, "delta") == [[1.0, 4.0], [2.0, 0.0],
                                            [3.0, 4.0]]
    rate = H.shape_points(pts, "rate")
    assert rate[0] == [1.0, 4.0]
    assert rate[1][1] == 0.0        # counter reset: clamped, never negative


def test_history_byte_cap_evicts_oldest_fine_frames():
    h = H.MetricsHistory(1000, "1", 20_000)
    key = ("rtpu_big_total", ())
    for i in range(500):
        h.record(1000.0 + i, {key: float(i)}, {}, {}, {})
    assert h.total_bytes <= 20_000
    assert h.frames_evicted > 0
    # the ring kept the NEWEST frames
    res = h.query(window=10_000)
    pts = [s for s in res["series"]][0]["points"]
    assert pts[-1][1] == 499.0
    assert pts[0][1] > 0.0


def test_history_disabled_capacity_zero():
    h = H.MetricsHistory(0, "1,10", 1 << 20)
    assert h.record(1.0, {("x", ()): 1.0}, {}, {}, {}) == 0
    res = h.query(window=100)
    assert res["series"] == [] and res["enabled"] is False


def test_history_dump_roundtrips_through_json():
    h = H.MetricsHistory(10, "1", 1 << 20)
    key = ("rtpu_scheduler_pending_tasks", (("node", "n1"),))
    for i in range(6):
        h.record(1000.0 + i, {}, {key: float(i)}, {}, {})
    dump = json.loads(json.dumps(h.dump()))
    res = H.query_dump(dump, name="rtpu_scheduler_pending_tasks",
                       window=10)
    assert len(res["series"]) == 1
    assert res["series"][0]["points"][-1][1] == 5.0
    # offline == live for the same query
    live = h.query(name="rtpu_scheduler_pending_tasks", window=10)
    assert live["series"] == res["series"]


def test_compute_trends_watchlist_and_idle_node():
    h = H.MetricsHistory(60, "1", 1 << 20)
    leak = ("rtpu_object_leaked_objects", (("node", "n1"),))
    pend = ("rtpu_scheduler_pending_tasks", (("node", "n1"),))
    disp_idle = ("rtpu_scheduler_tasks_dispatched_total",
                 (("node", "idle01"),))
    qwait = ("rtpu_serve_queue_wait_digest_seconds",
             (("deployment", "Model"),))
    for i in range(30):
        gauges = {leak: 0.0 if i < 20 else 3.0,
                  pend: float(i)}
        counters = {disp_idle: 7.0}          # never moves: idle node
        dig = _mk_digest([0.01 if i < 15 else 0.05] * 4)
        h.record(1000.0 + i, counters, gauges, {}, {qwait: dig})
    trends = H.compute_trends(h.query(window=29))
    by_metric = {t["metric"]: t for t in trends}
    assert "rtpu_object_leaked_objects" in by_metric
    assert "rtpu_scheduler_pending_tasks" in by_metric
    qw = by_metric["rtpu_serve_queue_wait_digest_seconds"]
    assert "queue_wait p95" in qw["message"]
    assert "deployment 'Model'" in qw["message"]
    assert qw["ratio"] >= 2.0
    idle = by_metric["rtpu_scheduler_tasks_dispatched_total"]
    assert idle["kind"] == "idle_node"
    assert "idle01" in idle["message"]
    # a quiet window yields nothing
    h2 = H.MetricsHistory(60, "1", 1 << 20)
    for i in range(20):
        h2.record(1000.0 + i, {}, {pend: 0.0}, {}, {})
    assert H.compute_trends(h2.query(window=19)) == []


def test_events_ring_eviction_counter():
    """Satellite: the bounded events ring counts what it silently
    drops (rtpu_events_evicted_total + events_stats)."""
    from ray_tpu_torch._private.gcs import GlobalControlPlane

    orig = CONFIG._values["cluster_events_buffer_size"]
    CONFIG._values["cluster_events_buffer_size"] = 4
    try:
        plane = GlobalControlPlane()
        for i in range(10):
            plane.record_cluster_event({"timestamp": float(i),
                                        "label": "X", "message": str(i)})
        stats = plane.events_stats()
        assert stats["buffered"] == 4 and stats["evicted"] == 6
        # since/until filtering on the plane
        rows = plane.list_cluster_events(since=7.0, until=8.0)
        assert [r["message"] for r in rows] == ["7", "8"]
    finally:
        CONFIG._values["cluster_events_buffer_size"] = orig
    snap = T.snapshot_local()
    total = sum(v for (name, _t), v in snap["counters"].items()
                if name == "rtpu_events_evicted_total")
    assert total >= 6


# ----------------------------------------------------------- live plane

def test_live_metrics_history_and_serve_trend_surface(rtpu_init):
    """The plane-hosting node's tick records frames; the state API
    serves windowed, shaped series; serve_health(trend=) attaches the
    movement dict; doctor carries a trends section."""

    @ray_tpu_torch.remote
    def work(i):
        time.sleep(0.02)
        return i

    def recorded():
        ray_tpu_torch.get([work.remote(i) for i in range(4)])
        res = rstate.metrics_history(window=60)
        names = {s["name"] for s in res.get("series") or []}
        return res if ("rtpu_scheduler_tasks_dispatched_total" in names
                       and len((res.get("series") or [])) > 3) else None

    res = _wait(recorded, timeout=20)
    assert res, "history never recorded frames"
    assert res["enabled"] and res["step_s"] >= 1.0
    # rate shaping of a live counter series
    shaped = rstate.metrics_history(
        name="rtpu_scheduler_tasks_dispatched_total", window=60,
        shape="rate")
    assert shaped["series"], shaped
    assert shaped["series"][0].get("shape") == "rate"
    with pytest.raises(ValueError):
        rstate.metrics_history(shape="bogus")
    # lifecycle: the head node's ALIVE transition is retained
    life = rstate.list_lifecycle_events()
    assert any(r["kind"] == "node" and r["state"] == "ALIVE"
               for r in life)
    # timeline lifecycle lane is opt-in
    trace = rstate.timeline(lifecycle=True)
    assert any(e.get("cat") == "lifecycle" for e in trace)
    # doctor: trends key present (list; empty on a quiet cluster)
    rep = rstate.health_report()
    assert isinstance(rep.get("trends"), list)
    # serve_health(trend=) attaches the movement dict (no deployments
    # -> empty, but the key exists)
    sh = rstate.serve_health(trend=30)
    assert "trend" in sh
    # events since/until on the live ring
    now = time.time()
    assert rstate.list_events(since=now + 3600) == []
    assert rstate.events_stats().get("capacity")


def test_live_history_disabled_knob(rtpu_init):
    orig = CONFIG._values["metrics_history_capacity"]
    CONFIG._values["metrics_history_capacity"] = 0
    try:
        time.sleep(1.5)
        # queries still answer (empty/old), recording is off: frame
        # count must not grow
        a = rstate.metrics_history(window=600)
        n_a = sum(len(s["points"]) for s in a.get("series") or [])
        time.sleep(2.5)
        b = rstate.metrics_history(window=600)
        n_b = sum(len(s["points"]) for s in b.get("series") or [])
        assert n_b == n_a
    finally:
        CONFIG._values["metrics_history_capacity"] = orig


# --------------------------------------------------------------- bundles

def test_bundle_capture_load_autopsy_roundtrip(rtpu_init, tmp_path):
    @ray_tpu_torch.remote
    def work(i):
        time.sleep(0.02)
        return i

    for _ in range(2):
        ray_tpu_torch.get([work.remote(i) for i in range(6)])
        time.sleep(1.1)
    from ray_tpu_torch._private import context as _ctx
    path = str(tmp_path / "bundle.tar.gz")
    out = debug_bundle.capture(path,
                               debug_bundle.ClientSource(
                                   _ctx.current_client))
    assert out == path and os.path.exists(path)
    bundle = debug_bundle.load(path)
    man = bundle["manifest"]
    assert man["format_version"] == debug_bundle.BUNDLE_FORMAT_VERSION
    names = [s["name"] for s in man["sections"]]
    assert names == list(debug_bundle.BUNDLE_SECTIONS)
    assert all(s["ok"] for s in man["sections"]), man["sections"]
    # offline autopsy through the same builders, no cluster consulted
    rep = debug_bundle.build_autopsy(bundle)
    assert rep["doctor"]["tasks"]["total"] >= 12
    assert rep["doctor"]["nodes"]["alive"] == 1
    assert rep["history"].get("series"), "bundle carried no history"
    assert isinstance(rep["trends"], list)
    # DEBUG_BUNDLE event landed on the plane (relay through the node)
    assert _wait(lambda: [e for e in rstate.list_events()
                          if e.get("label") == "DEBUG_BUNDLE"]), \
        "DEBUG_BUNDLE event never recorded"
    # capture counter
    snap = T.snapshot_local()
    assert any(name == "rtpu_debug_bundles_total"
               and dict(tags).get("reason") == "manual"
               for (name, tags) in snap["counters"])


def test_bundle_load_rejects_foreign_tar(tmp_path):
    bad = tmp_path / "notabundle.tar.gz"
    with tarfile.open(bad, "w:gz") as tar:
        pass
    with pytest.raises(ValueError, match="not a rtpu-debug-bundle"):
        debug_bundle.load(str(bad))


def test_auto_capture_gating(rtpu_init, tmp_path, monkeypatch):
    """auto_capture: once per (process, reason), honors the knob and
    the bundle dir."""
    monkeypatch.setitem(CONFIG._values, "debug_bundle_dir",
                        str(tmp_path))
    debug_bundle._auto_captured.discard("test_reason")
    monkeypatch.setitem(CONFIG._values, "debug_bundle_on_failure", False)
    assert debug_bundle.auto_capture("test_reason") is None
    monkeypatch.setitem(CONFIG._values, "debug_bundle_on_failure", True)
    path = debug_bundle.auto_capture("test_reason",
                                     fields={"k": "v"})
    assert path and os.path.exists(path)
    assert path.startswith(str(tmp_path))
    # second capture for the same reason: suppressed
    assert debug_bundle.auto_capture("test_reason") is None
    man = debug_bundle.load(path)["manifest"]
    assert man["reason"] == "test_reason"
    assert man["fields"] == {"k": "v"}
    debug_bundle._auto_captured.discard("test_reason")


def test_bundle_manifest_schema_golden(rtpu_init, tmp_path):
    """Golden pin of the bundle manifest SCHEMA: versioned, section
    list in registry order, byte-deterministic field order (sorted
    keys). Volatile values (timestamps, byte sizes, fields) normalize;
    everything structural must match the golden byte-for-byte."""
    from ray_tpu_torch._private import context as _ctx
    path = str(tmp_path / "golden_probe.tar.gz")
    debug_bundle.capture(path,
                         debug_bundle.ClientSource(_ctx.current_client))
    with tarfile.open(path, "r:*") as tar:
        raw = tar.extractfile("manifest.json").read()
    man = json.loads(raw)
    # determinism of the raw bytes themselves: re-dumping with sorted
    # keys reproduces them exactly (no dict-order dependence)
    assert raw == json.dumps(man, default=str, sort_keys=True).encode()
    man["created_ts"] = "<ts>"
    for s in man["sections"]:
        s["bytes"] = "<bytes>"
        s["ok"] = "<ok>"
    normalized = json.dumps(man, sort_keys=True, indent=1)
    golden_path = os.path.join(os.path.dirname(__file__), "golden",
                               "bundle_manifest.golden")
    with open(golden_path) as f:
        assert normalized == f.read()


# ------------------------------------------------------------------- CLI

def test_history_events_bundle_cli(rtpu_init, tmp_path):
    @ray_tpu_torch.remote
    def work(i):
        return i

    def ticked():
        ray_tpu_torch.get([work.remote(i) for i in range(4)])
        res = rstate.metrics_history(
            name="rtpu_scheduler_tasks_finished_total", window=60)
        return (res.get("series") or None)

    assert _wait(ticked, timeout=20)
    session = ray_tpu_torch._session_dir
    base = [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
            "--session", session]
    hist = subprocess.run(base + ["history",
                                  "rtpu_scheduler_tasks_finished_total",
                                  "--shape", "rate"],
                          capture_output=True, text=True, timeout=60)
    assert hist.returncode == 0, hist.stderr
    assert "rtpu_scheduler_tasks_finished_total" in hist.stdout
    ev = subprocess.run(base + ["events", "--since", "1h"],
                        capture_output=True, text=True, timeout=60)
    assert ev.returncode == 0, ev.stderr
    bundle_path = str(tmp_path / "cli_bundle.tar.gz")
    cap = subprocess.run(base + ["debug-bundle", "-o", bundle_path],
                         capture_output=True, text=True, timeout=120)
    assert cap.returncode == 0, cap.stderr
    assert os.path.exists(bundle_path)
    # autopsy is OFFLINE: no --session, works against the tar alone
    aut = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli",
                          "autopsy", bundle_path],
                         capture_output=True, text=True, timeout=60)
    assert aut.returncode == 0, aut.stderr
    assert "doctor (replayed offline)" in aut.stdout
    aut_json = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "autopsy",
         bundle_path, "--format", "json"],
        capture_output=True, text=True, timeout=60)
    assert aut_json.returncode == 0, aut_json.stderr
    rep = json.loads(aut_json.stdout)
    assert rep["manifest"]["reason"] == "manual"
    assert rep["doctor"]["nodes"]["alive"] == 1
