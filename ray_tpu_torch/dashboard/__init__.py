"""Cluster dashboard: JSON API + single-page HTML overview on the head.

Reference analogue: ``dashboard/`` (dashboard head + its api modules —
nodes, actors, jobs, state). Scope here is the observability core:
cluster/node/actor/task/object/PG state, task+actor summaries, and a
Chrome-trace timeline export, served as `/api/*` JSON the same way the
reference's dashboard API serves its SPA — plus a dependency-free HTML
page instead of a React bundle.

Runs inside the head node process reading GCS/node state directly (no
client connection), so it keeps answering while drivers come and go.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from .._private.http_util import HttpServerBase, JsonHandler
from ..state import api as state_api


class _HistoryCollector:
    """Ring-buffer time series of cluster utilization (reference:
    the dashboard's metrics time series, scoped to the capability: a
    bounded in-head history instead of a Prometheus+Grafana stack).
    Samples every ``period_s``; 600 samples x 2s = 20 minutes."""

    def __init__(self, node, period_s: float = 2.0, maxlen: int = 600):
        self._node = node
        self._period = period_s
        self.samples: deque = deque(maxlen=maxlen)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-dash-history")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            try:
                self.samples.append(self._sample())
            except Exception:   # noqa: BLE001 — a bad sample is a gap
                pass

    def _sample(self) -> dict:
        node = self._node
        total = node._cluster_info("resources_total") or {}
        avail = node._cluster_info("resources_available") or {}
        tasks = state_api.shape_tasks(node._state_query("tasks", None))
        by_state: dict = {}
        for t in tasks:
            by_state[t.get("state", "?")] =                 by_state.get(t.get("state", "?"), 0) + 1
        actors = state_api.shape_actors(
            node._state_query("actors", None))
        store = node.node_stats("store") or {}
        return {
            "ts": time.time(),
            "cpu_total": total.get("CPU", 0.0),
            "cpu_used": (total.get("CPU", 0.0)
                         - avail.get("CPU", 0.0)),
            "gpu_total": total.get("GPU", 0.0),
            "gpu_used": (total.get("GPU", 0.0)
                         - avail.get("GPU", 0.0)),
            "tasks_running": by_state.get("RUNNING", 0),
            "tasks_pending": (by_state.get("PENDING", 0)
                              + by_state.get("QUEUED", 0)),
            "tasks_finished": by_state.get("FINISHED", 0),
            "actors_alive": sum(1 for a in actors
                                if a.get("state") == "ALIVE"),
            "store_used_bytes": store.get("used_bytes", 0),
        }

_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 1.5rem; color: #222; }
 h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.4rem; }
 table { border-collapse: collapse; margin-top: .4rem; font-size: .85rem; }
 th, td { border: 1px solid #ccc; padding: .25rem .6rem; text-align: left; }
 th { background: #f3f3f3; }
 .pill { display: inline-block; padding: 0 .5rem; border-radius: 999px;
         background: #eef; margin-right: .4rem; }
 #err { color: #a00; }
</style></head>
<body>
<h1>ray_tpu_torch dashboard</h1>
<div id="cluster"></div><div id="err"></div>
<h2>Utilization history</h2>
<canvas id="hist" width="860" height="160"
 style="border:1px solid #ccc"></canvas>
<div id="histlegend" style="font-size:.8rem"></div>
<h2>Task drill-down</h2>
<input id="tid" placeholder="task id (hex or prefix)" size="36">
<button onclick="drill()">show timeline</button>
<table id="taskevents"></table>
<h2>Runtime metrics</h2>
<div style="font-size:.8rem">merged telemetry table
 (<a href="api/metrics">JSON</a> &middot;
  <a href="metrics">Prometheus</a>)</div>
<table id="metrics"></table>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Tasks (latest state)</h2><table id="tasks"></table>
<h2>Jobs</h2><table id="jobs"></table>
<script>
// all cluster-supplied strings (task/actor names, labels, entrypoints)
// are attacker-controlled: never reach innerHTML unescaped
function esc(s) {
  return String(s).replace(/[&<>"']/g, ch => ({"&": "&amp;", "<": "&lt;",
    ">": "&gt;", '"': "&quot;", "'": "&#39;"}[ch]));
}
function fill(id, rows, cols) {
  const t = document.getElementById(id);
  if (!rows || !rows.length) { t.innerHTML = "<tr><td>none</td></tr>"; return; }
  cols = cols || Object.keys(rows[0]);
  let h = "<tr>" + cols.map(c => `<th>${esc(c)}</th>`).join("") + "</tr>";
  for (const r of rows.slice(-50))
    h += "<tr>" + cols.map(
      c => `<td>${esc(JSON.stringify(r[c]) ?? "")}</td>`).join("") + "</tr>";
  t.innerHTML = h;
}
async function refresh() {
  try {
    const c = await (await fetch("api/cluster")).json();
    document.getElementById("cluster").innerHTML =
      Object.entries(c.resources_total || {}).map(
        ([k, v]) => `<span class="pill">${esc(k)}: ` +
          `${esc((c.resources_available||{})[k] ?? "?")} / ` +
          `${esc(v)}</span>`).join("") +
      `<span class="pill">nodes: ${esc(c.num_nodes)}</span>` +
      `<span class="pill">mem used: ` +
      `${esc(((c.memory||{}).usage_fraction*100).toFixed(0))}%</span>`;
    fill("nodes", (await (await fetch("api/nodes")).json()).nodes);
    fill("actors", (await (await fetch("api/actors")).json()).actors);
    fill("tasks", (await (await fetch("api/tasks")).json()).tasks);
    fill("jobs", (await (await fetch("api/jobs")).json()).jobs);
    document.getElementById("err").textContent = "";
  } catch (e) { document.getElementById("err").textContent = String(e); }
}
function drawHistory(samples) {
  const cv = document.getElementById("hist"), ctx = cv.getContext("2d");
  ctx.clearRect(0, 0, cv.width, cv.height);
  if (!samples.length) return;
  const series = [
    ["cpu_used", "#c33", s => s.cpu_total ? s.cpu_used / s.cpu_total : 0],
    ["tasks_running", "#36c",
     s => s.tasks_running / Math.max(1, ...samples.map(
       x => x.tasks_running))],
    ["store_used", "#390",
     s => s.store_used_bytes / Math.max(1, ...samples.map(
       x => x.store_used_bytes))],
  ];
  for (const [name, color, f] of series) {
    ctx.strokeStyle = color; ctx.beginPath();
    samples.forEach((s, i) => {
      const x = i / Math.max(1, samples.length - 1) * (cv.width - 8) + 4;
      const y = cv.height - 6 - f(s) * (cv.height - 12);
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    });
    ctx.stroke();
  }
  const span = ((samples[samples.length-1].ts - samples[0].ts) / 60)
    .toFixed(1);
  document.getElementById("histlegend").innerHTML =
    `<span style="color:#c33">cpu utilization</span> &middot; ` +
    `<span style="color:#36c">tasks running (rel)</span> &middot; ` +
    `<span style="color:#390">store used (rel)</span> &middot; ` +
    `window: ${esc(span)} min`;
}
async function drill() {
  const tid = document.getElementById("tid").value.trim();
  if (!tid) return;
  const r = await (await fetch("api/task/" +
    encodeURIComponent(tid))).json();
  fill("taskevents", r.events,
       ["timestamp", "state", "name", "node_id", "task_id"]);
}
async function refreshHist() {
  try {
    const h = await (await fetch("api/history")).json();
    drawHistory(h.samples || []);
  } catch (e) {}
}
async function refreshMetrics() {
  try {
    const m = await (await fetch("api/metrics")).json();
    const rows = (m.metrics || []).map(r => ({
      name: r.name, kind: r.kind,
      tags: Object.entries(r.tags || {}).map(
        ([k, v]) => `${k}=${v}`).join(","),
      value: r.kind === "histogram"
        ? `count=${r.count} mean=${r.count
            ? (r.sum / r.count).toFixed(4) : "-"}`
        : r.kind === "digest"
        ? `count=${r.count} p50=${(r.quantiles||{}).p50?.toFixed(4)
            } p99=${(r.quantiles||{}).p99?.toFixed(4)}`
        : r.value,
    }));
    fill("metrics", rows, ["name", "kind", "tags", "value"]);
  } catch (e) {}
}
refresh(); setInterval(refresh, 2000);
refreshHist(); setInterval(refreshHist, 4000);
refreshMetrics(); setInterval(refreshMetrics, 4000);
</script></body></html>
"""


class _Handler(JsonHandler):
    node = None           # NodeService, set by server factory
    job_manager = None    # optional JobManager
    history = None        # _HistoryCollector, set by server factory

    def do_GET(self):   # noqa: C901 — flat route table
        path = self.path.split("?", 1)[0].rstrip("/")
        node = self.node
        try:
            if path in ("", "/", "/index.html"):
                return self._html(_HTML)
            if path == "/api/cluster":
                mem = node.node_stats("memory") or {}
                nodes = node._cluster_info("nodes") or []
                return self._json(200, {
                    "num_nodes": sum(1 for n in nodes if n["alive"]),
                    "resources_total": node._cluster_info("resources_total"),
                    "resources_available":
                        node._cluster_info("resources_available"),
                    "memory": mem,
                })
            if path == "/api/nodes":
                return self._json(200, {"nodes": state_api.shape_nodes(
                    node._cluster_info("nodes"))})
            if path == "/api/workers":
                return self._json(200,
                                  {"workers": node._cluster_info("workers")})
            if path == "/api/actors":
                return self._json(200, {"actors": state_api.shape_actors(
                    node._state_query("actors", None))})
            if path == "/api/tasks":
                return self._json(200, {"tasks": state_api.shape_tasks(
                    node._state_query("tasks", None))})
            if path == "/api/objects":
                return self._json(200, {"objects": state_api.shape_objects(
                    node._state_query("objects", None))})
            if path == "/api/memory":
                # memory introspection plane: per-object provenance +
                # ref types, grouped callsite rollup, leak findings
                mem = node._state_query("memory", None) or {}
                rows = state_api.shape_objects(mem.get("objects"))
                return self._json(200, {
                    "summary": state_api.summarize_memory_rows(rows),
                    "objects": rows[:200],
                    "leaks": state_api.shape_leaks(mem.get("leaks")),
                    "stores": mem.get("stores") or {},
                })
            if path == "/api/placement_groups":
                return self._json(200, {
                    "placement_groups": state_api.shape_placement_groups(
                        node._state_query("placement_groups", None))})
            if path == "/api/summary":
                tasks = state_api.shape_tasks(
                    node._state_query("tasks", None))
                actors = state_api.shape_actors(
                    node._state_query("actors", None))
                return self._json(200, {
                    "tasks": state_api.summarize_task_rows(tasks),
                    "actors": state_api.summarize_actor_rows(actors)})
            if path == "/api/history":
                hist = getattr(self, "history", None)
                return self._json(200, {
                    "samples": list(hist.samples) if hist else []})
            if path == "/api/metrics":
                snap = node._state_query("metrics", None) or {}
                return self._json(200, {
                    "metrics": state_api.shape_metrics(snap),
                    "dropped_series": snap.get("dropped_series", 0)})
            if path == "/api/metrics/history":
                # windowed retention-ring series (?name=&window=&step=)
                from urllib.parse import parse_qs
                qs = parse_qs(self.path.split("?", 1)[1]
                              if "?" in self.path else "")

                def _num(key):
                    try:
                        return float(qs[key][0]) if key in qs else None
                    except (ValueError, IndexError):
                        return None

                return self._json(200, {
                    "history": node._state_query("metrics_history", {
                        "name": (qs.get("name") or [None])[0],
                        "window": _num("window"),
                        "step": _num("step"),
                    }) or {}})
            if path == "/api/lifecycle":
                # node/actor/PG state transitions retained past death
                return self._json(200, {
                    "lifecycle": node._state_query("lifecycle", None)
                    or [],
                    "events_stats": node._state_query("events_stats",
                                                      None) or {}})
            if path == "/metrics":
                # Prometheus scrape surface on the dashboard port (same
                # merged table the JSON endpoint serves)
                from ..util.metrics import format_prometheus
                body = format_prometheus(
                    node._state_query("metrics", None) or {},
                    include_exemplars=False).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            if path == "/api/serve":
                # serving health plane: per-deployment latency/queue
                # percentiles (streaming digests), queue depth, error
                # rate and the replica table — shaped from the head's
                # merged metrics table (no client needed)
                return self._json(200, {
                    "serve": state_api.shape_serve_health(
                        node._state_query("metrics", None))})
            if path == "/api/stacks":
                # on-demand cluster thread dump (the `rtpu stack`
                # surface); handler threads may block for the fan-out
                return self._json(200,
                                  {"stacks": node.cluster_stacks(3.0)})
            if path == "/api/collectives":
                # flight-recorder surface (the `rtpu coll-debug`
                # equivalent): in-flight watermarks + hang verdicts;
                # handler threads may block for the fan-out
                return self._json(
                    200, {"collectives": node.collective_health(2.0)})
            if path.startswith("/api/task/"):
                # drill-down: every recorded state transition of one
                # task (id or unique hex prefix), time-ordered
                tid = path.rsplit("/", 1)[1]
                events = []
                for ev in node._state_query("tasks", None) or []:
                    ev_hex = getattr(ev.get("task_id"), "hex",
                                     lambda: str(ev.get("task_id")))()
                    if ev_hex.startswith(tid):
                        events.append({
                            "task_id": ev_hex,
                            "name": ev.get("name"),
                            "state": ev.get("state"),
                            "node_id": (ev["node_id"].hex()
                                        if ev.get("node_id") else None),
                            "timestamp": ev.get("timestamp"),
                        })
                events.sort(key=lambda e: e["timestamp"] or 0)
                return self._json(200, {"task_id": tid,
                                        "events": events})
            if path == "/api/jobs":
                if self.job_manager is None:
                    return self._json(200, {"jobs": []})
                return self._json(200,
                                  {"jobs": self.job_manager.list_jobs()})
            return self._json(404, {"error": f"no route {self.path}"})
        except Exception as e:   # noqa: BLE001 — API surface
            return self._json(500, {"error": str(e)})


class DashboardServer(HttpServerBase):
    """HTTP server bound to a NodeService (start on the head)."""

    thread_name = "rtpu-dashboard"

    # loopback by default: full cluster state should not be readable by
    # any network peer without an explicit opt-in (--http-host=0.0.0.0)
    def __init__(self, node, job_manager=None, host: str = "127.0.0.1",
                 port: int = 0):
        self.history = _HistoryCollector(node)
        super().__init__(_Handler, host=host, port=port,
                         node=node, job_manager=job_manager,
                         history=self.history)

    def stop(self) -> None:
        self.history.stop()
        super().stop()
