"""User-facing metrics API: Counter / Gauge / Histogram.

Reference: ``python/ray/util/metrics.py`` (same three types, tag
support) + the per-node ``MetricsAgent`` → Prometheus pipeline
(``_private/metrics_agent.py:416``). The transport underneath is
``_private/telemetry.py``: every record call is a process-local
sharded-dict update (no RPC on the sample path); a background flusher
batch-pushes deltas to the control plane, where runtime and user
metrics merge into one cluster-wide table. Export is Prometheus text
format via ``export_prometheus()`` / ``start_metrics_http()``, the
dashboard's ``/api/metrics`` JSON endpoint, and
``state.api.summarize_metrics()``.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence

from .._private import telemetry

_DEFAULT_BUCKETS = telemetry.DEFAULT_BUCKETS


class _Metric:
    KIND = ""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        # Histogram sets its buckets before delegating here; one define
        # covers all kinds so bucket/kind conflicts are caught centrally
        self._buckets = getattr(self, "_buckets", None)
        telemetry.define(self.KIND, name, description, self._buckets)

    def set_default_tags(self, tags: Dict[str, str]) -> "_Metric":
        self._default_tags = dict(tags)
        return self

    def _tags_tuple(self, tags: Optional[Dict[str, str]]) -> tuple:
        merged = {**self._default_tags, **(tags or {})}
        return tuple(sorted(merged.items()))


class Counter(_Metric):
    KIND = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        telemetry.counter_inc(self._name, float(value),
                              self._tags_tuple(tags))


class Gauge(_Metric):
    KIND = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        telemetry.gauge_set(self._name, float(value),
                            self._tags_tuple(tags))


class Histogram(_Metric):
    KIND = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = _DEFAULT_BUCKETS,
                 tag_keys: Sequence[str] = ()):
        self._buckets = tuple(boundaries)
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        telemetry.hist_observe(self._name, float(value),
                               self._tags_tuple(tags), self._buckets)


# ------------------------------------------------------------- exposition

def _fmt_tags(tags: tuple) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in tags)
    return "{" + inner + "}"


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def format_prometheus(snap: dict, include_exemplars: bool = True) -> str:
    """Prometheus text exposition of one metrics snapshot (the merged
    control-plane table or a process-local one). ``# HELP``/``# TYPE``
    are emitted once per metric NAME (exposition-format requirement),
    with every tagged series grouped under its header. Histogram
    exemplars (trace ids captured while tracing was enabled) ride the
    matching bucket line in OpenMetrics syntax — pass
    ``include_exemplars=False`` for surfaces that advertise the classic
    ``text/plain; version=0.0.4`` content type, whose parsers reject
    the exemplar token (the HTTP scrape endpoints do)."""
    meta = snap.get("meta") or {}
    by_name: Dict[str, dict] = {}

    def series_of(name: str) -> dict:
        ent = by_name.get(name)
        if ent is None:
            ent = by_name[name] = {"counters": [], "gauges": [],
                                   "hists": [], "digests": []}
        return ent

    for (name, tags), value in (snap.get("counters") or {}).items():
        series_of(name)["counters"].append((tags, value))
    for (name, tags), (value, _ts) in (snap.get("gauges") or {}).items():
        series_of(name)["gauges"].append((tags, value))
    for (name, tags), h in (snap.get("hists") or {}).items():
        series_of(name)["hists"].append((tags, h))
    for (name, tags), d in (snap.get("digests") or {}).items():
        series_of(name)["digests"].append((tags, d))
    if snap.get("dropped_series"):
        series_of("rtpu_telemetry_dropped_series_total")["counters"].append(
            ((), float(snap["dropped_series"])))
        meta = {**meta, "rtpu_telemetry_dropped_series_total": {
            "kind": "counter",
            "description": "Metric series dropped by the control plane "
                           "(cardinality cap or bucket conflicts)"}}

    lines: List[str] = []
    for name in sorted(by_name):
        ent = by_name[name]
        m = meta.get(name) or {}
        kind = m.get("kind") or ("histogram" if ent["hists"] else
                                 "summary" if ent["digests"] else
                                 "gauge" if ent["gauges"] else "counter")
        # quantile digests export as the Prometheus summary type
        # (quantile-labelled gauge lines + _sum/_count)
        if kind == "digest":
            kind = "summary"
        desc = m.get("description") or ""
        if desc:
            lines.append(f"# HELP {name} {_escape_help(desc)}")
        lines.append(f"# TYPE {name} {kind}")
        for tags, value in sorted(ent["counters"]) + sorted(ent["gauges"]):
            lines.append(f"{name}{_fmt_tags(tags)} {float(value)}")
        for tags, h in sorted(ent["hists"], key=lambda kv: kv[0]):
            buckets = tuple(h.get("buckets") or _DEFAULT_BUCKETS)
            counts = list(h.get("counts") or [0] * (len(buckets) + 1))
            ex = h.get("exemplar") if include_exemplars else None
            ex_idx = (min(bisect_left(buckets, ex["value"]), len(buckets))
                      if ex else -1)
            cumulative = 0
            for i, b in enumerate(buckets):
                cumulative += counts[i] if i < len(counts) else 0
                line = (f"{name}_bucket"
                        f"{_fmt_tags(tags + (('le', str(b)),))} "
                        f"{cumulative}")
                if i == ex_idx:
                    line += (f' # {{trace_id="{ex["trace_id"]}"}} '
                             f'{ex["value"]} {ex["ts"]}')
                lines.append(line)
            total = int(h.get("count", sum(counts)))
            inf_line = (f"{name}_bucket"
                        f"{_fmt_tags(tags + (('le', '+Inf'),))} {total}")
            if ex_idx == len(buckets):
                inf_line += (f' # {{trace_id="{ex["trace_id"]}"}} '
                             f'{ex["value"]} {ex["ts"]}')
            lines.append(inf_line)
            lines.append(f"{name}_sum{_fmt_tags(tags)} "
                         f"{float(h.get('sum', 0.0))}")
            lines.append(f"{name}_count{_fmt_tags(tags)} {total}")
        for tags, d in sorted(ent["digests"], key=lambda kv: kv[0]):
            for q in (0.5, 0.9, 0.95, 0.99):
                lines.append(
                    f"{name}{_fmt_tags(tags + (('quantile', str(q)),))} "
                    f"{telemetry.digest_quantile(d, q)}")
            lines.append(f"{name}_sum{_fmt_tags(tags)} "
                         f"{float(d.get('sum', 0.0))}")
            lines.append(f"{name}_count{_fmt_tags(tags)} "
                         f"{int(d.get('count', 0))}")
    return "\n".join(lines) + ("\n" if lines else "")


def metrics_snapshot() -> dict:
    """The merged cluster-wide metrics table (this process's shards are
    flushed first). Falls back to the process-local view when no
    runtime is connected."""
    telemetry.flush()
    from .._private import context as _ctx
    client = _ctx.current_client
    if client is not None:
        try:
            snap = client.state_query("metrics", None)
            if snap is not None:
                return snap
        except Exception:   # noqa: BLE001 — export must not raise
            pass
    return telemetry.snapshot_local()


def export_prometheus() -> str:
    """Prometheus text exposition of all recorded metrics (head scrape
    surface; reference: the per-node agent's scrape endpoint)."""
    return format_prometheus(metrics_snapshot())


_http_server = None


def start_metrics_http(host: str = "127.0.0.1", port: int = 0) -> str:
    """Serve GET /metrics in Prometheus format (reference: the per-node
    agent's scrape endpoint)."""
    global _http_server
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            # classic 0.0.4 content type: no exemplar tokens
            body = format_prometheus(metrics_snapshot(),
                                     include_exemplars=False).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    _http_server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=_http_server.serve_forever,
                     daemon=True).start()
    return f"http://{host}:{_http_server.server_address[1]}/metrics"
