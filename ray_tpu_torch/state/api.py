"""State API implementation.

Reference surface: ``experimental/state/api.py`` list_* / summarize_*
and ``ray.timeline()`` (``_private/state.py:865`` — Chrome trace JSON
from task events).
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from typing import Any, Dict, List, Optional

from .._private import context as _ctx


def _query(what: str, filters: Optional[dict] = None) -> Any:
    return _ctx.require_client().state_query(what, filters)


def _apply_filters(rows: List[dict], filters: Optional[dict]) -> List[dict]:
    if not filters:
        return rows
    out = []
    for row in rows:
        if all(str(row.get(k)) == str(v) for k, v in filters.items()):
            out.append(row)
    return out


def _hex(v) -> str:
    return v.hex() if hasattr(v, "hex") else str(v)


# Row shaping is shared with the dashboard, which reads the same raw
# records directly from the head's GCS (no client in that process).

def shape_tasks(events: List[dict]) -> List[dict]:
    latest: Dict[Any, dict] = {}
    for ev in events or []:
        latest[ev["task_id"]] = {
            "task_id": _hex(ev["task_id"]),
            "name": ev["name"],
            "state": ev["state"],
            "node_id": _hex(ev["node_id"]),
            "is_actor_task": ev.get("is_actor_task", False),
            "timestamp": ev["timestamp"],
        }
    return sorted(latest.values(), key=lambda r: r["timestamp"])


def shape_actors(recs: List[dict]) -> List[dict]:
    return [{
        "actor_id": _hex(rec["actor_id"]),
        "class_name": rec["class_name"],
        "name": rec.get("name"),
        "state": rec["state"],
        "num_restarts": rec.get("num_restarts", 0),
        "max_restarts": rec.get("max_restarts", 0),
    } for rec in recs or []]


def shape_objects(recs: List[dict]) -> List[dict]:
    """Tolerant of records missing optional keys (a ledger row for an
    object that is held but not yet sealed has no node/size; pre-PR
    minimal records shape fine too)."""
    return [{
        "object_id": _hex(rec.get("object_id")),
        "node_id": (_hex(rec["node_id"])
                    if rec.get("node_id") is not None else None),
        "size": rec.get("size"),
        "callsite": rec.get("callsite"),
        "creator": rec.get("creator"),
        "ref_types": dict(rec.get("ref_types") or {}),
        "pins": rec.get("pins", 0),
        "pinned_in_store": rec.get("pinned_in_store", 0),
        "spilled": rec.get("spilled", False),
        "leaked": rec.get("leaked", False),
    } for rec in recs or []]


def shape_leaks(recs: List[dict]) -> List[dict]:
    return [{
        **rec,
        "object_id": _hex(rec.get("object_id")),
        "node_id": (_hex(rec["node_id"])
                    if rec.get("node_id") is not None else None),
    } for rec in recs or []]


def summarize_memory_rows(rows: List[dict], group_by: str = "callsite",
                          top_k: int = 20,
                          sort_by: str = "bytes") -> Dict[str, Any]:
    """Group shaped object rows by creation callsite / creator / node
    with byte+count totals and a merged ref-type breakdown, largest
    group first by ``sort_by`` (``bytes`` | ``count`` — applied BEFORE
    the top-K cut, so the #1 group by the chosen key is always shown).
    The ``ray memory --group-by`` rollup, shared by
    ``memory_summary()``, the dashboard ``/api/memory`` endpoint and
    ``rtpu memory``."""
    key_field = "node_id" if group_by == "node" else group_by
    if key_field not in ("callsite", "creator", "node_id"):
        raise ValueError(f"unknown group_by {group_by!r} "
                         "(callsite | creator | node)")
    if sort_by not in ("bytes", "count"):
        raise ValueError(f"unknown sort_by {sort_by!r} (bytes | count)")
    groups: Dict[str, dict] = {}
    total_bytes = 0
    for r in rows:
        size = r.get("size") or 0
        total_bytes += size
        key = str(r.get(key_field) or "<unknown>")
        g = groups.setdefault(key, {"key": key, "objects": 0,
                                    "bytes": 0, "ref_types": {}})
        g["objects"] += 1
        g["bytes"] += size
        for t, n in (r.get("ref_types") or {}).items():
            g["ref_types"][t] = g["ref_types"].get(t, 0) + n
    sort_key = ((lambda g: (-g["objects"], -g["bytes"], g["key"]))
                if sort_by == "count" else
                (lambda g: (-g["bytes"], -g["objects"], g["key"])))
    ordered = sorted(groups.values(), key=sort_key)
    return {
        "group_by": group_by,
        "sort_by": sort_by,
        "total_objects": len(rows),
        "total_bytes": total_bytes,
        "groups": ordered[:top_k],
        "dropped_groups": max(0, len(ordered) - top_k),
    }


def shape_placement_groups(recs: List[dict]) -> List[dict]:
    return [{
        "pg_id": _hex(rec["pg_id"]),
        "state": rec.get("state"),
        "bundles": rec["bundles"],
        "strategy": rec["strategy"],
    } for rec in recs or []]


def shape_nodes(recs: List[dict]) -> List[dict]:
    return [{**rec, "node_id": _hex(rec["node_id"])} for rec in recs or []]


def shape_metrics(snap: Optional[dict]) -> List[dict]:
    """Flatten a telemetry snapshot (tuple-keyed tables) into JSON-able
    series rows, shared by the dashboard ``/api/metrics`` endpoint and
    ``summarize_metrics``."""
    snap = snap or {}
    meta = snap.get("meta") or {}
    rows: List[dict] = []

    def base(name: str, tags: tuple) -> dict:
        m = meta.get(name) or {}
        return {"name": name, "kind": m.get("kind"),
                "description": m.get("description") or "",
                "tags": dict(tags)}

    for (name, tags), value in (snap.get("counters") or {}).items():
        rows.append({**base(name, tags), "kind": "counter",
                     "value": value})
    for (name, tags), (value, ts) in (snap.get("gauges") or {}).items():
        rows.append({**base(name, tags), "kind": "gauge", "value": value,
                     "timestamp": ts})
    for (name, tags), h in (snap.get("hists") or {}).items():
        buckets = list(h.get("buckets") or ())
        counts = list(h.get("counts") or ())
        cumulative, cum = [], 0
        for i, b in enumerate(buckets):
            cum += counts[i] if i < len(counts) else 0
            cumulative.append([b, cum])
        rows.append({**base(name, tags), "kind": "histogram",
                     "buckets": cumulative,
                     "sum": h.get("sum", 0.0),
                     "count": h.get("count", 0),
                     "exemplar": h.get("exemplar")})
    from .._private import telemetry as _tm
    for (name, tags), d in (snap.get("digests") or {}).items():
        rows.append({**base(name, tags), "kind": "digest",
                     "sum": d.get("sum", 0.0),
                     "count": d.get("count", 0),
                     "min": d.get("min"), "max": d.get("max"),
                     "quantiles": {
                         "p50": _tm.digest_quantile(d, 0.50),
                         "p90": _tm.digest_quantile(d, 0.90),
                         "p95": _tm.digest_quantile(d, 0.95),
                         "p99": _tm.digest_quantile(d, 0.99)}})
    rows.sort(key=lambda r: (r["name"], sorted(r["tags"].items())))
    return rows


def list_tasks(filters: Optional[dict] = None,
               limit: int = 1000) -> List[dict]:
    """Task state transitions (latest state per task)."""
    rows = shape_tasks(_query("tasks"))
    return _apply_filters(rows, filters)[:limit]


def list_actors(filters: Optional[dict] = None,
                limit: int = 1000) -> List[dict]:
    return _apply_filters(shape_actors(_query("actors")), filters)[:limit]


def list_objects(filters: Optional[dict] = None,
                 limit: int = 1000) -> List[dict]:
    return _apply_filters(shape_objects(_query("objects")), filters)[:limit]


def list_placement_groups(filters: Optional[dict] = None,
                          limit: int = 1000) -> List[dict]:
    return _apply_filters(
        shape_placement_groups(_query("placement_groups")), filters)[:limit]


def list_nodes(filters: Optional[dict] = None) -> List[dict]:
    return _apply_filters(_ctx.require_client().cluster_info("nodes") or [],
                          filters)


def list_workers(filters: Optional[dict] = None) -> List[dict]:
    return _apply_filters(
        _ctx.require_client().cluster_info("workers") or [], filters)


def list_jobs(filters: Optional[dict] = None) -> List[dict]:
    """Driver jobs with start/end times (reference: ``ray list jobs``)."""
    rows = [{**rec, "job_id": _hex(rec["job_id"])}
            for rec in _query("jobs") or []]
    return _apply_filters(rows, filters)


def summarize_task_rows(rows: List[dict]) -> Dict[str, Any]:
    by_state = Counter(r["state"] for r in rows)
    by_func: Dict[str, Counter] = defaultdict(Counter)
    for r in rows:
        by_func[r["name"]][r["state"]] += 1
    return {"total": len(rows), "by_state": dict(by_state),
            "by_func": {k: dict(v) for k, v in by_func.items()}}


def summarize_actor_rows(rows: List[dict]) -> Dict[str, Any]:
    by_state = Counter(r["state"] for r in rows)
    by_class: Dict[str, Counter] = defaultdict(Counter)
    for r in rows:
        by_class[r["class_name"]][r["state"]] += 1
    return {"total": len(rows), "by_state": dict(by_state),
            "by_class": {k: dict(v) for k, v in by_class.items()}}


def list_metrics(filters: Optional[dict] = None,
                 limit: int = 10000) -> List[dict]:
    """Cluster-wide runtime + user metric series (merged telemetry
    table on the control plane)."""
    rows = shape_metrics(_query("metrics"))
    if filters:
        name = filters.get("name")
        if name is not None:
            rows = [r for r in rows if r["name"] == name]
        rows = [r for r in rows
                if all(str(r["tags"].get(k)) == str(v)
                       for k, v in filters.items() if k != "name")]
    return rows[:limit]


def summarize_metrics(snap: Optional[dict] = None) -> Dict[str, Any]:
    """Per-metric rollup: series count plus a kind-appropriate total
    (counter sum, latest gauge values, histogram count/mean) — the
    ``ray summary``-style view of the telemetry table. Pass ``snap``
    to roll up an already-fetched snapshot (health_report fetches the
    cluster table once and shares it across its sections)."""
    return summarize_metric_rows(shape_metrics(
        snap if snap is not None else _query("metrics")))


def summarize_metric_rows(rows: List[dict]) -> Dict[str, Any]:
    """Pure row-based half of ``summarize_metrics`` — shared with the
    offline bundle replay (``rtpu autopsy``), whose metrics arrive as
    the JSON rows a bundle stores, not a live tuple-keyed snapshot."""
    out: Dict[str, Any] = {}
    for row in rows or []:
        ent = out.setdefault(row["name"], {
            "kind": row["kind"], "description": row["description"],
            "series": 0})
        ent["series"] += 1
        if row["kind"] == "counter":
            ent["total"] = ent.get("total", 0.0) + row["value"]
        elif row["kind"] == "gauge":
            ent["last"] = row["value"]
        else:   # histogram and digest rows both carry count/sum
            ent["count"] = ent.get("count", 0) + row["count"]
            ent["sum"] = ent.get("sum", 0.0) + row["sum"]
            if ent["count"]:
                ent["mean"] = ent["sum"] / ent["count"]
            if row["kind"] == "digest" and row.get("quantiles"):
                # quantiles don't aggregate across tag-sets: keep them
                # only while the name has ONE series — pairing a merged
                # count with one series' percentiles would mislead
                # (use serve_health / list_metrics for per-tag views)
                if ent["series"] == 1:
                    ent["quantiles"] = row["quantiles"]
                else:
                    ent.pop("quantiles", None)
    return out


def memory_summary(group_by: str = "callsite", top_k: int = 20,
                   sort_by: str = "bytes") -> Dict[str, Any]:
    """Cluster-wide object-memory rollup (reference: ``ray memory`` /
    memory summary): every object the control plane tracks — with its
    creation callsite, creator task/actor and reference types
    (LOCAL_REFERENCE / USED_BY_PENDING_TASK / CAPTURED_IN_OBJECT /
    ACTOR_HANDLE / PINNED_IN_STORE) — grouped by ``group_by``
    (``callsite`` | ``creator`` | ``node``) with byte totals, plus the
    current leak findings and per-node store stats."""
    mem = _query("memory") or {}
    rows = shape_objects(mem.get("objects"))
    out = summarize_memory_rows(rows, group_by=group_by, top_k=top_k,
                                sort_by=sort_by)
    out["leaks"] = shape_leaks(mem.get("leaks"))
    out["stores"] = mem.get("stores") or {}
    return out


def shape_serve_health(snap: Optional[dict]) -> Dict[str, Any]:
    """Per-deployment serving health from one merged metrics snapshot —
    the exact tuple the autoscaler consumes: latency / queue-wait /
    batch-size percentiles (streaming digests), live queue depth, a
    per-replica table, and request/error totals. Shared by
    ``state.serve_health()``, the dashboard ``GET /api/serve`` (which
    reads the head's table with no client) and ``rtpu serve-status``."""
    return serve_health_from_rows(shape_metrics(snap))


def serve_health_from_rows(rows: List[dict]) -> Dict[str, Any]:
    """Row-based half of ``shape_serve_health``: consumes the JSON
    series rows ``shape_metrics`` produces — which is exactly what a
    debug bundle stores, so ``rtpu autopsy`` replays the serve surface
    offline through this same function."""
    deps: Dict[str, dict] = {}

    def ent(name: str) -> dict:
        d = deps.get(name)
        if d is None:
            d = deps[name] = {
                "deployment": name, "requests_total": 0.0,
                "errors_total": 0.0, "error_rate": 0.0,
                "queue_depth": 0.0, "replicas": [],
                "latency": {}, "queue_wait": {}, "batch_size": {},
            }
        return d

    digest_fields = {
        "rtpu_serve_request_latency_digest_seconds": "latency",
        "rtpu_serve_queue_wait_digest_seconds": "queue_wait",
        "rtpu_serve_batch_size_digest": "batch_size",
    }
    for row in rows or []:
        name, t = row.get("name"), row.get("tags") or {}
        if name == "rtpu_serve_requests_total":
            d = ent(t.get("deployment", "default"))
            d["requests_total"] += row.get("value") or 0.0
            if t.get("status") == "error":
                d["errors_total"] += row.get("value") or 0.0
        elif name == "rtpu_serve_replica_queue_depth":
            value = row.get("value")
            if value is None or value != value or value < 0:
                continue    # in-flight delete marker / defensive
            d = ent(t.get("deployment", "default"))
            d["queue_depth"] += value
            d["replicas"].append({"replica": t.get("replica", "0"),
                                  "queue_depth": value})
        elif name in digest_fields:
            q = row.get("quantiles") or {}
            count = row.get("count") or 0
            ent(t.get("deployment", "default"))[digest_fields[name]] = {
                "p50": q.get("p50", 0.0),
                "p95": q.get("p95", 0.0),
                "p99": q.get("p99", 0.0),
                "count": count,
                "mean": ((row.get("sum") or 0.0) / count if count
                         else 0.0),
                "max": row.get("max"),
            }
    worst = None
    for d in deps.values():
        d["replicas"].sort(key=lambda r: r["replica"])
        if d["requests_total"]:
            d["error_rate"] = d["errors_total"] / d["requests_total"]
        # worst = highest error rate, then highest p99 latency — the
        # deployment the doctor names first
        key = (d["error_rate"], (d["latency"] or {}).get("p99", 0.0))
        if worst is None or key > worst[0]:
            worst = (key, d["deployment"])
    return {"deployments": deps,
            "worst": worst[1] if worst else None}


def shape_serve_trends(history_result: dict) -> Dict[str, Any]:
    """Per-deployment movement over one windowed history query — the
    exact ``trend=`` signal the autoscaler consumes:
    queue-depth head/tail means (summed over replicas), latency and
    queue-wait p95 head/tail, and request rate head/tail. Pure (history
    rows in, dict out) so the live ``serve_health(trend=)`` and the
    offline autopsy share it."""
    from .._private import history as _h
    window = round(float(history_result.get("window_s") or 0.0))
    out: Dict[str, dict] = {}

    def ent(dep: str) -> dict:
        d = out.get(dep)
        if d is None:
            d = out[dep] = {"deployment": dep, "window_s": window}
        return d

    def pair(head: float, tail: float) -> dict:
        return {"head": round(head, 5), "tail": round(tail, 5),
                "ratio": round(tail / head, 2) if head > 0 else None}

    queue: Dict[str, List[float]] = {}
    rate: Dict[str, List[float]] = {}
    for s in history_result.get("series") or []:
        name, tags = s["name"], s["tags"]
        dep = tags.get("deployment")
        if dep is None:
            continue
        if name == "rtpu_serve_replica_queue_depth":
            h, t = _h._head_tail(_h.shape_points(s["points"], "value"))
            queue.setdefault(dep, [0.0, 0.0])
            queue[dep][0] += h
            queue[dep][1] += t
        elif name == "rtpu_serve_requests_total":
            h, t = _h._head_tail(_h.shape_points(s["points"], "rate"))
            rate.setdefault(dep, [0.0, 0.0])
            rate[dep][0] += h
            rate[dep][1] += t
        elif name == "rtpu_serve_request_latency_digest_seconds":
            pts = [[ts, v.get("p95", 0.0)] for ts, v in s["points"]
                   if isinstance(v, dict) and v.get("count")]
            h, t = _h._head_tail(pts)
            ent(dep)["latency_p95"] = pair(h, t)
        elif name == "rtpu_serve_queue_wait_digest_seconds":
            pts = [[ts, v.get("p95", 0.0)] for ts, v in s["points"]
                   if isinstance(v, dict) and v.get("count")]
            h, t = _h._head_tail(pts)
            ent(dep)["queue_wait_p95"] = pair(h, t)
    for dep, (h, t) in queue.items():
        ent(dep)["queue_depth"] = pair(h, t)
    for dep, (h, t) in rate.items():
        ent(dep)["request_rate"] = pair(h, t)
    return out


def serve_health(trend: Optional[float] = None) -> Dict[str, Any]:
    """Cluster-wide serving health: per-deployment latency/queue-wait/
    batch-size percentiles (from the streaming digests), queue depth,
    error rate and the replica table (see ``shape_serve_health``).
    ``trend=<seconds>`` additionally attaches per-deployment head/tail
    movement over that retention window (queue depth, latency p95,
    queue-wait p95, request rate) — the autoscaling signal with a time
    axis."""
    base = shape_serve_health(_query("metrics"))
    if trend:
        try:
            hist = _query("metrics_history",
                          {"window": float(trend)}) or {}
        except Exception:   # noqa: BLE001 — trends degrade, never die
            hist = {}
        base["trend"] = shape_serve_trends(hist)
    return base


def serve_requests(limit: int = 100, slow: bool = False,
                   errors: bool = False,
                   timeout_s: float = 10.0) -> List[dict]:
    """Recent structured access-log rows gathered from every serve
    replica's ring (``rtpu requests``): request_id, deployment,
    replica, route, status, latency, queue wait, batch size. ``slow``
    keeps rows at/over ``serve_slow_request_threshold_s``, ``errors``
    keeps failures. Empty when serve is not running."""
    from .. import get, get_actor
    from ..serve.api import _CONTROLLER_NAME
    try:
        controller = get_actor(_CONTROLLER_NAME)
    except ValueError:
        return []
    import time as _time
    rows: List[dict] = []
    deadline = _time.monotonic() + timeout_s
    try:
        deployments = get(controller.list_deployments.remote(),
                          timeout=timeout_s)
        # submit the whole fan-out FIRST (replicas answer in parallel),
        # then collect under one shared deadline — a dead replica costs
        # at most the remaining budget once, not timeout_s serially per
        # replica; get_replicas discovery is fanned out the same way
        replica_refs = [controller.get_replicas.remote(name)
                        for name in deployments]
        refs = []
        for rref in replica_refs:
            for replica in get(rref, timeout=max(
                    0.5, deadline - _time.monotonic())):
                refs.append(replica.access_log.remote(limit, slow,
                                                      errors))
        for ref in refs:
            try:
                rows.extend(get(ref, timeout=max(
                    0.5, deadline - _time.monotonic())))
            except Exception:   # noqa: BLE001 — a dead replica is a
                continue        # gap, not a failure
    except Exception:   # noqa: BLE001 — controller mid-shutdown
        return rows
    rows.sort(key=lambda r: r.get("ts") or 0)
    return rows[-limit:]


def summarize_tasks() -> Dict[str, Any]:
    """Count by (name, state) — reference: ``ray summary tasks``."""
    return summarize_task_rows(list_tasks(limit=10**9))


def summarize_actors() -> Dict[str, Any]:
    return summarize_actor_rows(list_actors(limit=10**9))


# ------------------------------------------------- debugging & profiling

def cluster_stacks(timeout_s: float = 5.0) -> dict:
    """Thread dumps from every live node/worker/driver process,
    deduplicated by the control plane (reference: ``ray stack``).
    Returns ``{"nodes": {node_hex: [dump, ...]}, "groups": [...]}``
    where each group collapses threads with identical stacks."""
    return _ctx.require_client().cluster_stacks(timeout_s) or {}


def profile(duration_s: float = 5.0, interval_ms: Optional[float] = None,
            task_filter: Optional[str] = None,
            collapsed_file: Optional[str] = None,
            chrome_trace_file: Optional[str] = None) -> dict:
    """Cluster-wide sampling wall-clock profiler: every worker samples
    its threads for ``duration_s`` (capped by ``profiler_max_duration_s``)
    and the merged collapsed stacks come back flamegraph-ready.
    ``task_filter`` restricts samples to moments a task whose name
    contains the substring is running. Optionally writes a
    ``stack count``-per-line collapsed file and/or a Chrome trace."""
    from .._private import debugging
    from .._private.config import CONFIG

    opts: Dict[str, Any] = {
        "duration_s": duration_s,
        "interval_ms": interval_ms or CONFIG.profiler_default_interval_ms,
    }
    if task_filter:
        opts["task_filter"] = task_filter
    report = _ctx.require_client().cluster_profile(opts) or {}
    if collapsed_file:
        debugging.write_collapsed(report.get("collapsed") or {},
                                  collapsed_file)
    if chrome_trace_file:
        reports = [r for reps in (report.get("nodes") or {}).values()
                   for r in reps]
        with open(chrome_trace_file, "w") as f:
            json.dump(debugging.chrome_trace(reports), f)
    return report


def collective_health(timeout_s: float = 2.0) -> dict:
    """Cluster-wide collective hang & straggler diagnosis (the flight-
    recorder surface): every rank's per-op watermarks plus verdicts for
    stuck ops — ``dead_rank`` (process answered nothing), ``lost_chunk``
    (sender logged the send, receiver never saw the delivery — the edge
    is named) or ``lagging_rank`` (lowest watermark, with its current
    stack attached when a dump matches). Returns
    ``{"ops": [...], "verdicts": [...], "processes": n}``."""
    return _ctx.require_client().collective_health(timeout_s) or {}


def flight_records(timeout_s: float = 2.0) -> dict:
    """Raw per-process collective flight-recorder snapshots: the recent
    event ring (send/deliver/recv per chunk with monotonic timestamps)
    and completed-op records, keyed by node —
    ``{"nodes": {node_hex: [snapshot, ...]}}``."""
    return _ctx.require_client().flight_records(timeout_s) or {}


def metrics_history(name: Optional[str] = None,
                    tags: Optional[dict] = None,
                    window: Optional[float] = None,
                    step: Optional[float] = None,
                    shape: str = "value") -> Dict[str, Any]:
    """Windowed time series from the control plane's multi-resolution
    retention ring: aligned ``[ts, value]`` points per (name, tags)
    series over the trailing ``window`` seconds, at the finest retained
    resolution covering it (or the level nearest an explicit ``step``).
    ``shape`` turns cumulative counter/histogram series into usable
    curves: ``rate`` (per-second) or ``delta`` (per-step); gauges and
    digest series (whose points already carry interval p50/p95/p99)
    ignore it. Empty when ``metrics_history_capacity=0``."""
    if shape not in ("value", "rate", "delta"):
        raise ValueError(f"unknown shape {shape!r} (value | rate | delta)")
    res = _query("metrics_history", {"name": name, "tags": tags,
                                     "window": window, "step": step}) or {}
    if shape != "value":
        from .._private import history as _h
        for s in res.get("series") or []:
            if s.get("kind") in ("counter", "histogram"):
                s["points"] = _h.shape_points(s["points"], shape)
                s["shape"] = shape
    return res


def metrics_trends(window: float = 120.0) -> List[dict]:
    """Named movements over the trailing window (the doctor's trend
    section): rising watchlist gauges, serve p95 inflation, error-rate
    growth, idle-node-while-queueing. Empty on a quiet cluster."""
    from .._private import history as _h
    res = _query("metrics_history", {"window": float(window)}) or {}
    return _h.compute_trends(res)


def list_lifecycle_events(limit: int = 10000,
                          since: Optional[float] = None) -> List[dict]:
    """Node/actor/placement-group state transitions retained past
    death (bounded ring beside the task-event ring): what the cluster
    was doing, even for subjects that no longer exist."""
    rows = _query("lifecycle") or []
    if since is not None:
        rows = [r for r in rows if (r.get("ts") or 0) >= since]
    return rows[-limit:]


def events_stats() -> Dict[str, Any]:
    """Cluster-event ring occupancy + the eviction counter behind
    ``rtpu_events_evicted_total`` (silent history loss, observable)."""
    return _query("events_stats") or {}


_DOCTOR_TREND_WINDOW_S = 120.0


def gather_health_data(trend_window: float = _DOCTOR_TREND_WINDOW_S
                       ) -> Dict[str, Any]:
    """Collect every input ``build_health_report`` consumes from the
    live cluster, as JSON-able rows. Debug bundles store this same
    shape section-by-section, so ``rtpu autopsy`` rebuilds the doctor
    offline from a captured dict instead of live queries."""
    client = _ctx.require_client()
    data: Dict[str, Any] = {
        "nodes": shape_nodes(client.cluster_info("nodes") or []),
        "resources": {
            "total": client.cluster_info("resources_total") or {},
            "available": client.cluster_info("resources_available") or {},
        },
        "tasks": shape_tasks(_query("tasks")),
        "actors": shape_actors(_query("actors")),
        "events": _query("cluster_events") or [],
    }
    try:
        data["collectives"] = collective_health(1.5) or {}
    except Exception:   # noqa: BLE001 — doctor degrades, never dies
        data["collectives"] = {}
    try:
        mem = _query("memory") or {}
    except Exception:   # noqa: BLE001 — doctor degrades, never dies
        mem = {}
    data["memory"] = {"objects": shape_objects(mem.get("objects")),
                      "leaks": shape_leaks(mem.get("leaks"))}
    # ONE cluster-wide metrics snapshot, shared by the serve section
    # and the telemetry highlights (two identical head RPCs otherwise)
    try:
        data["metrics"] = shape_metrics(_query("metrics"))
    except Exception:   # noqa: BLE001 — doctor degrades, never dies
        data["metrics"] = []
    try:
        data["history"] = _query("metrics_history",
                                 {"window": float(trend_window)}) or {}
    except Exception:   # noqa: BLE001 — doctor degrades, never dies
        data["history"] = {}
    return data


def health_report() -> Dict[str, Any]:
    """`rtpu doctor`: one correlated cluster health view — node/resource
    state, task/actor rollups, stall diagnoses, recent WARNING/ERROR
    events, head-vs-tail trend movements over the retention window, and
    telemetry highlights (queue wait, store fill, dropped series)."""
    return build_health_report(gather_health_data())


def build_health_report(data: Dict[str, Any]) -> Dict[str, Any]:
    """Pure doctor: consumes the ``gather_health_data`` dict — live or
    replayed from a debug bundle (``rtpu autopsy``) with no cluster."""
    from .._private import history as _history
    nodes = data.get("nodes") or []
    total = (data.get("resources") or {}).get("total") or {}
    avail = (data.get("resources") or {}).get("available") or {}
    tasks = data.get("tasks") or []
    task_summary = summarize_task_rows(tasks)
    actor_rows = data.get("actors") or []
    actor_summary = summarize_actor_rows(actor_rows)
    events = data.get("events") or []
    recent = events[-500:]
    # a stall is a problem only while its task is still non-terminal:
    # historical TASK_STALL events for tasks that since finished/failed
    # must not keep the doctor red for the rest of the session
    current_state = {t["task_id"]: t["state"] for t in tasks}
    stalls = [e for e in recent
              if e.get("label") == "TASK_STALL"
              and current_state.get(e.get("task_id"))
              in ("PENDING_ARGS_AVAIL", "PENDING_NODE_ASSIGNMENT",
                  "RUNNING")]
    alerts = [e for e in recent
              if e.get("severity") in ("WARNING", "ERROR")
              and e.get("label") != "TASK_STALL"]
    coll = data.get("collectives") or {}
    coll_verdicts = coll.get("verdicts") or []
    mem = data.get("memory") or {}
    mem_rows = mem.get("objects") or []
    leaks = mem.get("leaks") or []

    highlights: Dict[str, Any] = {}
    metric_rows = data.get("metrics") or []
    try:
        serve = serve_health_from_rows(metric_rows)
    except Exception:   # noqa: BLE001 — doctor degrades, never dies
        serve = {"deployments": {}, "worst": None}
    try:
        metrics = summarize_metric_rows(metric_rows)
    except Exception:   # noqa: BLE001 — doctor degrades, never dies
        metrics = {}
    # trend section: head-vs-tail movements over the retention window
    # ("what changed", not just "what is") — empty when the history
    # plane is off or the window has no data
    try:
        trends = _history.compute_trends(data.get("history") or {})
    except Exception:   # noqa: BLE001 — doctor degrades, never dies
        trends = []
    queue_wait = metrics.get("rtpu_scheduler_queue_wait_seconds") or {}
    if queue_wait.get("count"):
        highlights["queue_wait_mean_s"] = round(
            queue_wait["sum"] / queue_wait["count"], 4)
    fill = metrics.get("rtpu_object_store_fill_ratio") or {}
    if "last" in fill:
        highlights["store_fill_ratio"] = fill["last"]
    dropped = metrics.get("rtpu_telemetry_dropped_series_total") or {}
    if dropped.get("total"):
        highlights["dropped_metric_series"] = dropped["total"]

    # recovery: did the self-healing machinery run, and did any budget
    # run dry? (reforms + actor checkpoint/restore counters from the
    # merged telemetry table; recent COLLECTIVE_REFORM/ACTOR_REROUTE
    # events; actors that died with restarts consumed = a budget that
    # was exhausted rather than never used)
    def _ctr(name: str) -> float:
        return (metrics.get(name) or {}).get("total", 0) or 0

    recovery = {
        "collective_reforms": _ctr("rtpu_collective_reforms_total"),
        "fenced_stale_chunks": _ctr("rtpu_collective_fenced_chunks_total"),
        "actor_checkpoints": _ctr("rtpu_actor_checkpoints_total"),
        "actor_restores": _ctr("rtpu_actor_restores_total"),
        "recent_reforms": [e for e in recent
                           if e.get("label") == "COLLECTIVE_REFORM"][-10:],
        "recent_actor_reroutes": [e for e in recent
                                  if e.get("label") == "ACTOR_REROUTE"][-10:],
        # exhausted = died having CONSUMED its whole (non-empty, finite)
        # budget: a deliberately-killed actor mid-budget, or one that
        # never had restarts, is not a crash loop worth flagging
        "exhausted_restart_budgets": [
            {"actor_id": a.get("actor_id"),
             "class_name": a.get("class_name"),
             "num_restarts": a.get("num_restarts", 0)}
            for a in actor_rows
            if a.get("state") == "DEAD"
            and 0 < a.get("max_restarts", 0) <= a.get("num_restarts", 0)],
    }

    dead_nodes = [n for n in nodes if not n.get("alive")]
    by_state = task_summary.get("by_state", {})
    n_pending = (by_state.get("PENDING_ARGS_AVAIL", 0)
                 + by_state.get("PENDING_NODE_ASSIGNMENT", 0))
    problems: List[str] = []
    if dead_nodes:
        named = ", ".join(str(n.get("node_id"))[:12]
                          for n in dead_nodes[:4])
        problems.append(f"{len(dead_nodes)} node(s) dead ({named})")
    if stalls:
        stalled = {e.get("task_id") for e in stalls}
        problems.append(f"{len(stalled)} stalled task(s) — see stalls")
    errors = [e for e in alerts if e.get("severity") == "ERROR"]
    if errors:
        problems.append(f"{len(errors)} ERROR event(s) — see alerts")
    cpu_avail = avail.get("CPU", 0.0)
    if n_pending and cpu_avail <= 0:
        problems.append(f"{n_pending} task(s) pending with 0 CPU "
                        "available (saturated or wedged)")
    if coll_verdicts:
        problems.append(f"{len(coll_verdicts)} stuck collective op(s) "
                        "— see collectives")
    if leaks:
        named = next((lk for lk in leaks if lk.get("callsite")), None)
        where = (f" — e.g. object created at {named['callsite']}"
                 if named else "")
        problems.append(f"{len(leaks)} leaked object(s){where} "
                        "— see memory")
    # serve: name the worst deployment (highest error rate, then p99);
    # a deployment failing a quarter of a real request volume is a
    # problem line, not just a table row
    worst_name = serve.get("worst")
    if worst_name:
        wd = serve["deployments"].get(worst_name) or {}
        if wd.get("error_rate", 0.0) >= 0.25 \
                and wd.get("requests_total", 0.0) >= 4:
            problems.append(
                f"deployment {worst_name!r} failing "
                f"{wd['error_rate']:.0%} of {wd['requests_total']:g} "
                "request(s) — see serve")
    # movements are problems too: a queue-wait p95 3x-ing over the
    # window is actionable before any instantaneous threshold trips
    for t in [t for t in trends if t.get("severity") == "warn"][:5]:
        problems.append(f"trend: {t['message']}")
    return {
        "healthy": not problems,
        "problems": problems,
        "trends": trends,
        "nodes": {"alive": len(nodes) - len(dead_nodes),
                  "dead": len(dead_nodes)},
        "resources": {"total": total, "available": avail},
        "tasks": task_summary,
        "actors": actor_summary,
        "stalls": stalls[-20:],
        "alerts": alerts[-20:],
        "collectives": {"ops": coll.get("ops") or [],
                        "verdicts": coll_verdicts},
        "memory": {"objects": len(mem_rows),
                   "bytes": sum(r.get("size") or 0 for r in mem_rows),
                   "leaked": len(leaks),
                   "leaks": leaks[:10]},
        "serve": serve,
        "recovery": recovery,
        "metrics": highlights,
    }


def list_events(filters: Optional[dict] = None,
                limit: int = 1000,
                since: Optional[float] = None,
                until: Optional[float] = None) -> List[dict]:
    """Structured cluster events — node up/down, OOM kills, actor
    deaths, stalls, leaks (reference: ``ray list cluster-events``).
    ``since``/``until`` are epoch-second bounds applied BEFORE the
    limit, so a time window never loses older matching rows to the
    cap; the ring's eviction counter (``rtpu_events_evicted_total`` /
    ``state.events_stats()``) says whether rows aged out of retention
    entirely."""
    rows = _query("cluster_events") or []
    if since is not None:
        rows = [r for r in rows if (r.get("timestamp") or 0) >= since]
    if until is not None:
        rows = [r for r in rows if (r.get("timestamp") or 0) <= until]
    return _apply_filters(rows, filters)[-limit:]


def list_cluster_events(filters: Optional[dict] = None,
                        limit: int = 1000,
                        since: Optional[float] = None,
                        until: Optional[float] = None) -> List[dict]:
    """Alias of ``list_events`` (the reference-flavored name)."""
    return list_events(filters, limit, since=since, until=until)


def list_spans(filters: Optional[dict] = None,
               limit: int = 10000) -> List[dict]:
    """Finished trace spans (requires ``tracing_enabled``)."""
    # ship this process's own buffered spans first, so driver-side
    # spans are visible mid-session (not only after shutdown)
    from ..util import tracing
    tracing.flush()
    rows = _query("spans") or []
    return _apply_filters(rows, filters)[-limit:]


def trace_timeline(filename: Optional[str] = None) -> Any:
    """Chrome-trace JSON built from SPANS (cross-process causality via
    trace/parent ids; requires ``tracing_enabled``). Complement of
    ``timeline()``, which is built from task state events."""
    trace = []
    for span in list_spans():
        if span.get("end_time") is None:
            continue
        trace.append({
            "name": span["name"],
            "cat": "span",
            "ph": "X",
            "ts": span["start_time"] * 1e6,
            "dur": (span["end_time"] - span["start_time"]) * 1e6,
            "pid": f"trace:{span['trace_id'][:8]}",
            "tid": f"pid:{span.get('pid', '?')}",
            "args": {"span_id": span["span_id"],
                     "parent_id": span.get("parent_id"),
                     "status": span.get("status"),
                     **span.get("attributes", {})},
        })
    if filename is not None:
        with open(filename, "w") as f:
            json.dump(trace, f)
        return filename
    return trace


def _collective_trace_events() -> List[dict]:
    """Completed collective ops from every process's flight recorder as
    Chrome-trace X events: one span per (rank, call), grouped per
    collective group so straggling ranks line up visually against their
    peers. Best-effort — a session with the recorder off (or no runtime)
    contributes nothing. Collective-free sessions skip the cluster
    fan-out entirely: a plain-task timeline must not pay a COLL_PROGRESS
    round trip to every process for an empty result."""
    from .._private import flight_recorder as _fr
    try:
        local_active = bool(_fr._groups or _fr._done or _fr._inflight)
        if not local_active:
            # ranks may live only in workers: the merged metrics table
            # (one STATE_QUERY) says whether ANY process ran collectives
            # (workers flush telemetry at task boundaries)
            counters = (_query("metrics") or {}).get("counters") or {}
            if not any(name == "rtpu_collective_ops_total"
                       for name, _tags in counters):
                return []
        records = flight_records(timeout_s=1.5)
    except Exception:   # noqa: BLE001 — timeline degrades, never dies
        return []
    trace: List[dict] = []
    for snaps in (records.get("nodes") or {}).values():
        for snap in snaps or []:
            for rec in snap.get("done", ()):
                start = rec.get("start")
                dur = rec.get("dur")
                if start is None or dur is None:
                    continue
                trace.append({
                    "name": f"coll::{rec.get('op')}",
                    "cat": "collective",
                    "ph": "X",
                    "ts": start * 1e6,
                    "dur": max(dur, 1e-6) * 1e6,
                    "pid": f"coll:{rec.get('group')}",
                    "tid": f"rank:{rec.get('rank')}",
                    "args": {"op": rec.get("op"),
                             "algo": rec.get("algo"),
                             "seq": rec.get("key"),
                             "nbytes": rec.get("nbytes"),
                             "world": rec.get("world"),
                             "chunks_sent": rec.get("sent"),
                             "chunks_recv": rec.get("recv"),
                             "error": rec.get("error")},
                })
    return trace


def _request_trace_events() -> List[dict]:
    """Serve request traces as Chrome-trace X events (``cat:
    "request"``): every span belonging to a trace that contains a
    ``request::`` span — the force-traced ingress/queue-wait/batch-
    assembly/replica-execute spans AND any nested ``task::``/
    ``actor_call::`` spans the deployment's own ``.remote()`` calls
    produced (they share the request's trace id) — grouped one pid row
    per request id, so one request reads as one timeline lane."""
    from ..util import tracing
    try:
        tracing.flush()
        spans = _query("spans") or []
    except Exception:   # noqa: BLE001 — timeline degrades, never dies
        return []
    by_trace: Dict[str, List[dict]] = defaultdict(list)
    for span in spans:
        tid = span.get("trace_id")
        if tid:
            by_trace[tid].append(span)
    trace: List[dict] = []
    for tid, members in by_trace.items():
        rid = None
        is_request = False
        for span in members:
            if str(span.get("name", "")).startswith("request::"):
                is_request = True
                rid = rid or (span.get("attributes")
                              or {}).get("request_id")
        if not is_request:
            continue                    # not a request trace
        pid = f"request:{rid or tid[:8]}"
        for span in members:
            if span.get("end_time") is None:
                continue
            trace.append({
                "name": span["name"],
                "cat": "request",
                "ph": "X",
                "ts": span["start_time"] * 1e6,
                "dur": max(span["end_time"] - span["start_time"],
                           1e-6) * 1e6,
                "pid": pid,
                "tid": f"pid:{span.get('pid', '?')}",
                "args": {"trace_id": tid,
                         "span_id": span.get("span_id"),
                         "parent_id": span.get("parent_id"),
                         "status": span.get("status"),
                         **(span.get("attributes") or {})},
            })
    return trace


def lifecycle_trace_events(rows: List[dict]) -> List[dict]:
    """Retained node/actor/PG state transitions as Chrome instant
    events (``ph: "i"``, one lane per subject kind) — pure, shared by
    ``timeline(lifecycle=True)`` and the offline autopsy replay."""
    trace = []
    for r in rows or []:
        trace.append({
            "name": f"{r.get('kind')}:{r.get('state')}",
            "cat": "lifecycle",
            "ph": "i",
            "s": "g",       # global-scope instant marker
            "ts": (r.get("ts") or 0) * 1e6,
            "pid": f"lifecycle:{r.get('kind')}",
            "tid": str(r.get("id"))[:12],
            "args": {k: v for k, v in r.items()
                     if k not in ("ts", "kind")},
        })
    return trace


def timeline(filename: Optional[str] = None,
             lifecycle: bool = False) -> Any:
    """Chrome-trace JSON of task execution (reference: ``ray.timeline``,
    ``_private/state.py:865``), plus one span per completed collective
    call from the flight recorder (``cat: collective``, one row per
    rank), plus one lane per traced serve request (``cat: request`` —
    ingress/queue-wait/batch-assembly/replica-execute and the
    request's nested task spans, keyed by request id).
    ``lifecycle=True`` adds instant markers for retained node/actor/PG
    state transitions (``cat: lifecycle``) so the trailing window shows
    what the cluster was doing around each death. Load the output in
    chrome://tracing or Perfetto."""
    events = _query("tasks") or []
    # pair RUNNING -> FINISHED/FAILED per task
    runs: Dict[Any, dict] = {}
    trace = []
    for ev in sorted(events, key=lambda e: e["timestamp"]):
        tid = ev["task_id"]
        node = (ev["node_id"].hex()[:8]
                if hasattr(ev["node_id"], "hex") else str(ev["node_id"]))
        if ev["state"] == "RUNNING":
            runs[tid] = ev
        elif ev["state"] in ("FINISHED", "FAILED") and tid in runs:
            start = runs.pop(tid)
            trace.append({
                "name": ev["name"],
                "cat": "actor_task" if ev.get("is_actor_task") else "task",
                "ph": "X",
                "ts": start["timestamp"] * 1e6,
                "dur": (ev["timestamp"] - start["timestamp"]) * 1e6,
                "pid": f"node:{node}",
                "tid": (tid.hex()[:8] if hasattr(tid, "hex")
                        else str(tid)),
                "args": {"state": ev["state"]},
            })
    trace.extend(_collective_trace_events())
    trace.extend(_request_trace_events())
    if lifecycle:
        try:
            trace.extend(lifecycle_trace_events(_query("lifecycle")))
        except Exception:   # noqa: BLE001 — timeline degrades, never dies
            pass
    if filename is not None:
        with open(filename, "w") as f:
            json.dump(trace, f)
        return filename
    return trace
