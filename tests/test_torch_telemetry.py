# A copy of tests/test_telemetry.py on ray_tpu_torch's runtime: the same tests
# under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown. Docstrings leave
# out the JAX package's issue history.
# Not copied again: test_prometheus_exposition_golden,
# test_exposition_without_meta_infers_kind,
# test_cluster_scrape_covers_subsystems, test_queue_wait_exemplar_links_trace,
# test_digest_prometheus_summary_exposition,
# test_gauge_delete_retires_series_everywhere (already held in another
# tests/test_torch_*.py under the same name).
"""Runtime telemetry pipeline tests: exposition golden file, shard
concurrency, device-sampler degradation, multi-subsystem cluster scrape
+ dashboard parity, and the no-RPC record path."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import telemetry
from ray_tpu_torch._private.gcs import GlobalControlPlane
from ray_tpu_torch.util import metrics as rmetrics
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


# ------------------------------------------------------- exposition format

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



def test_histogram_bucket_conflict_warns():
    telemetry.define("histogram", "telem_conflict_seconds", "a",
                     (0.1, 1.0))
    with pytest.warns(UserWarning, match="conflicting"):
        telemetry.define("histogram", "telem_conflict_seconds", "a",
                         (0.5, 2.0))


# ------------------------------------------------------------- concurrency

def test_concurrent_recording_loses_no_samples():
    """8 threads hammer one counter + one histogram; local shard totals
    must be exact (lock correctness on the record path)."""
    n_threads, per_thread = 8, 2000
    name_c = "telem_conc_total"
    name_h = "telem_conc_seconds"
    telemetry.define("counter", name_c, "conc")
    telemetry.define("histogram", name_h, "conc", (0.5,))

    def hammer(i):
        for k in range(per_thread):
            telemetry.counter_inc(name_c, 1.0, (("t", str(i % 2)),))
            telemetry.hist_observe(name_h, (k % 10) / 10.0, ())

    threads = [threading.Thread(target=hammer, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    snap = telemetry.snapshot_local()
    total = sum(v for (n, _), v in snap["counters"].items() if n == name_c)
    assert total == n_threads * per_thread
    h = snap["hists"][(name_h, ())]
    assert h["count"] == n_threads * per_thread
    assert sum(h["counts"]) == n_threads * per_thread


def test_plane_merge_after_flush():
    """Delta payloads merge on the control plane: counters add, gauges
    latest-timestamp-wins, histogram buckets add elementwise."""
    plane = GlobalControlPlane()
    key_c = ("telem_merge_total", ())
    key_g = ("telem_merge_gauge", ())
    key_h = ("telem_merge_seconds", ())
    mk = lambda counts, s, n: {"buckets": (0.5,), "counts": list(counts),
                               "sum": s, "count": n, "exemplar": None}
    p1 = {"counters": {key_c: 5.0}, "gauges": {key_g: (1.0, 10.0)},
          "hists": {key_h: mk([2, 1], 1.5, 3)},
          "meta": {"telem_merge_total": {"kind": "counter",
                                         "description": "m"}}}
    p2 = {"counters": {key_c: 7.0}, "gauges": {key_g: (9.0, 20.0)},
          "hists": {key_h: mk([1, 4], 3.5, 5)}, "meta": {}}
    plane.record_metrics(p1)
    plane.record_metrics(p2)
    snap = plane.metrics_snapshot()
    assert snap["counters"][key_c] == 12.0
    assert snap["gauges"][key_g][0] == 9.0
    assert snap["hists"][key_h]["counts"] == [3, 5]
    assert snap["hists"][key_h]["count"] == 8
    # stale gauge (older ts) must not overwrite
    plane.record_metrics({"gauges": {key_g: (4.0, 15.0)}})
    assert plane.metrics_snapshot()["gauges"][key_g][0] == 9.0


def test_plane_bucket_conflict_keeps_totals():
    plane = GlobalControlPlane()
    key = ("telem_conflict_merge_seconds", ())
    plane.record_metrics({"hists": {key: {
        "buckets": (0.5,), "counts": [1, 0], "sum": 0.1, "count": 1,
        "exemplar": None}}})
    plane.record_metrics({"hists": {key: {
        "buckets": (2.0,), "counts": [3, 0], "sum": 0.3, "count": 3,
        "exemplar": None}}})
    snap = plane.metrics_snapshot()
    h = snap["hists"][key]
    assert h["buckets"] == (0.5,)       # first layout wins
    assert h["count"] == 4              # totals still right
    assert snap["dropped_series"] == 1


# ----------------------------------------------------------- device sampler

def test_device_sampler_noop_on_cpu():
    """JAX_PLATFORMS=cpu (pinned by conftest): memory_stats() is None on
    CPU devices, so the sampler reports nothing and never raises."""
    assert telemetry.sample_devices() == 0
    snap = telemetry.snapshot_local()
    hbm = [k for k in snap["gauges"]
           if k[0] == "rtpu_device_hbm_bytes_in_use"]
    assert hbm == []
    telemetry.sample_once()             # full pass also never raises


# -------------------------------------------------------- record-path cost

def test_record_path_needs_no_runtime():
    """The record path is an in-process shard update: it must work (and
    stay fast) with NO client, node, or control plane — proof there is
    no RPC on the sample path."""
    from ray_tpu_torch._private import context as _ctx
    assert _ctx.current_client is None
    telemetry.define("counter", "telem_norpc_total", "")
    n = 50_000
    t0 = time.perf_counter()
    for _ in range(n):
        telemetry.counter_inc("telem_norpc_total", 1.0, (("a", "b"),))
    elapsed = time.perf_counter() - t0
    snap = telemetry.snapshot_local()
    assert snap["counters"][("telem_norpc_total", (("a", "b"),))] >= n
    # generous bound: ~µs/record; an RPC-per-record design would be
    # orders of magnitude over it
    assert elapsed < 5.0


def test_disabled_telemetry_records_nothing(monkeypatch):
    from ray_tpu_torch._private.config import CONFIG
    monkeypatch.setitem(CONFIG._values, "telemetry_enabled", False)
    telemetry.counter_inc("telem_disabled_total", 1.0, ())
    telemetry.gauge_set("telem_disabled_gauge", 1.0, ())
    telemetry.hist_observe("telem_disabled_seconds", 1.0, ())
    snap = telemetry.snapshot_local()
    assert ("telem_disabled_total", ()) not in snap["counters"]
    assert ("telem_disabled_gauge", ()) not in snap["gauges"]
    assert ("telem_disabled_seconds", ()) not in snap["hists"]


# ------------------------------------------- cluster-wide scrape (tentpole)

def _fetch_json(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return json.loads(resp.read())



# ------------------------------------------------- quantile digests

def test_digest_quantiles_bounded_memory():
    """The streaming digest estimates p50/p95/p99 within ~2% on a
    skewed distribution while holding at most ~2x the centroid cap —
    no sample retention."""
    import random

    rng = random.Random(7)
    d = telemetry._Digest()
    vals = [rng.lognormvariate(0.0, 0.5) for _ in range(50_000)]
    for v in vals:
        d.add(v)
    payload = d.to_payload()
    assert len(payload["centroids"]) <= 2 * telemetry._DIGEST_CENTROIDS
    ordered = sorted(vals)
    for q in (0.5, 0.9, 0.95, 0.99):
        est = telemetry.digest_quantile(payload, q)
        true = ordered[min(int(q * len(ordered)), len(ordered) - 1)]
        assert abs(est - true) / true < 0.02, (q, est, true)
    # exact extremes survive compression
    assert telemetry.digest_quantile(payload, 0.0) >= payload["min"]
    assert telemetry.digest_quantile(payload, 1.0) <= payload["max"]


def test_digest_merge_matches_single_stream():
    """Sharded/per-process digests merged by the plane fold estimate
    the same quantiles as one digest over the whole stream."""
    import random

    rng = random.Random(11)
    vals = [rng.expovariate(1.0) for _ in range(30_000)]
    parts = [telemetry._Digest() for _ in range(3)]
    for i, v in enumerate(vals):
        parts[i % 3].add(v)
    merged = None
    for p in parts:
        merged = telemetry.merge_digest_payloads(merged, p.to_payload())
    assert merged["count"] == len(vals)
    assert len(merged["centroids"]) <= 2 * telemetry._DIGEST_CENTROIDS
    ordered = sorted(vals)
    for q in (0.5, 0.95, 0.99):
        est = telemetry.digest_quantile(merged, q)
        true = ordered[int(q * len(ordered))]
        assert abs(est - true) / max(true, 1e-9) < 0.03, (q, est, true)


def test_digest_empty_and_single():
    assert telemetry.digest_quantile(None, 0.5) == 0.0
    assert telemetry.digest_quantile({"count": 0}, 0.99) == 0.0
    d = telemetry._Digest()
    d.add(4.2)
    assert telemetry.digest_quantile(d.to_payload(), 0.5) == \
        pytest.approx(4.2)


def test_digest_delta_flush_and_plane_merge():
    """digest_observe rides the same delta flusher as histograms: the
    collected delta resets the pending digest (second collect ships
    nothing), the plane merges deltas cumulatively, and a failed-send
    restore re-queues the delta without double-counting the local
    cumulative view."""
    name = "rtpu_test_flush_digest_seconds"
    tags = (("case", "flush"),)
    key = (name, tags)
    for v in (0.1, 0.2, 0.3, 0.4):
        telemetry.digest_observe(name, v, tags)
    snap = telemetry.snapshot_local()
    assert snap["digests"][key]["count"] == 4

    payload = telemetry._collect_deltas()
    assert payload["digests"][key]["count"] == 4
    again = telemetry._collect_deltas()
    assert again is None or key not in (again.get("digests") or {})
    # local cumulative view unchanged by the flush
    assert telemetry.snapshot_local()["digests"][key]["count"] == 4

    plane = GlobalControlPlane()
    plane.record_metrics(payload)
    plane.record_metrics({"digests": {key: {"centroids": [[0.5, 2.0]],
                                            "count": 2, "sum": 1.0,
                                            "min": 0.5, "max": 0.5}}})
    merged = plane.metrics_snapshot()["digests"][key]
    assert merged["count"] == 6
    assert merged["max"] == pytest.approx(0.5)

    # failed send: restore re-queues the delta for the next collect
    telemetry.digest_observe(name, 0.9, tags)
    telemetry._last_digest_ship = 0.0    # bypass the ~1s ship cadence
    payload2 = telemetry._collect_deltas()
    telemetry._restore_deltas(payload2)
    telemetry._last_digest_ship = 0.0
    payload3 = telemetry._collect_deltas()
    assert payload3["digests"][key]["count"] == \
        payload2["digests"][key]["count"]
    assert telemetry.snapshot_local()["digests"][key]["count"] == 5



def test_gauge_delete_tombstone_refuses_stragglers():
    """A delete marker tombstones the series at the marker's ts: an
    older in-flight publish from the dying process (its flusher racing
    the delete) must NOT resurrect the popped series, while a genuinely
    newer set re-creates it (the dead replica's queue-depth row once
    came back forever)."""
    name = "rtpu_test_straggler_gauge"
    tags = (("case", "straggle"),)
    key = (name, tags)
    plane = GlobalControlPlane()
    now = 1000.0
    plane.record_metrics({"gauges": {key: (3.0, now)}})
    assert plane.metrics_snapshot()["gauges"][key][0] == 3.0
    # delete marker at now+1
    plane.record_metrics({"gauges": {key: (float("nan"), now + 1)}})
    assert key not in plane.metrics_snapshot()["gauges"]
    # straggling older publish: refused, series stays gone
    plane.record_metrics({"gauges": {key: (5.0, now + 0.5)}})
    assert key not in plane.metrics_snapshot()["gauges"]
    # a strictly newer set means the subject is genuinely back
    plane.record_metrics({"gauges": {key: (9.0, now + 2)}})
    assert plane.metrics_snapshot()["gauges"][key][0] == 9.0
