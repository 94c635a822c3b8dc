"""Control-plane metrics history: fixed-memory multi-resolution rings.

The merge table in ``gcs.py`` answers "what is true right now"; this
module gives it a time axis (reference analogue: the dashboard's
Prometheus-backed time series and the GCS task-event time dimension,
scoped to the capability — a bounded in-head retention ring instead of
an external TSDB). Every history tick the plane appends one compact
*frame* — cumulative counter values, latest gauges, histogram
count/sum, and the *interval* quantile digest accumulated since the
previous frame — into a ladder of resolution levels (e.g. 1s×120 /
10s×180 / 60s×240): recent history is fine-grained, older history
coarsens instead of vanishing. Memory is doubly bounded: per-level slot
caps plus a hard byte cap (oldest finest frames evict first).

Counters are stored cumulatively, so downsampling is sampling and
``rate()``/``delta()`` shaping is an exact diff at any resolution.
Interval digests merge losslessly (t-digest payload fold), so a coarse
frame's p95 is the true p95 of its whole interval, not a quantile of
quantiles.

Everything here is pure data structure + pure functions: the plane
calls it under its own lock, and the SAME query/shaping/trend code runs
offline against a bundle dump (``rtpu autopsy``) with no live cluster.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

from . import fieldsan
from . import telemetry

M_HISTORY_BYTES = telemetry.define(
    "gauge", "rtpu_metrics_history_bytes",
    "Estimated bytes held by the control-plane metrics-history rings "
    "(sampled at each history tick; bounded by "
    "metrics_history_max_bytes)")

# centroid cap of the per-frame interval digests: coarser than the live
# digests' cap — history trades tail precision for 120+ retained frames
_FRAME_DIGEST_CENTROIDS = 32

# per-entry byte estimates for the hard cap (key tuples are shared with
# the live merge table, so a frame's marginal cost is the value cells)
_B_FRAME = 96
_B_SCALAR = 56          # dict entry + float
_B_PAIR = 72            # dict entry + 2-tuple of floats
_B_DIGEST_BASE = 120
_B_CENTROID = 18


class _Frame:
    __slots__ = ("ts", "counters", "gauges", "hists", "digests", "nbytes")

    def __init__(self, ts: float, counters: dict, gauges: dict,
                 hists: dict, digests: dict):
        self.ts = ts
        self.counters = counters        # key -> cumulative float
        self.gauges = gauges            # key -> float
        self.hists = hists              # key -> (count, sum)
        self.digests = digests          # key -> interval digest payload
        self.nbytes = (_B_FRAME
                       + _B_SCALAR * (len(counters) + len(gauges))
                       + _B_PAIR * len(hists)
                       + sum(_B_DIGEST_BASE + _B_CENTROID
                             * len(d.get("centroids") or ())
                             for d in digests.values()))


@fieldsan.guarded
class _Level:
    __slots__ = ("step", "capacity", "frames", "last_ts",
                 "pending_digests")

    def __init__(self, step: float, capacity: int):
        self.step = float(step)
        self.capacity = int(capacity)
        self.frames: deque = deque()
        self.last_ts = 0.0
        # interval digest payloads merged since this level's last frame
        self.pending_digests: Dict[tuple, dict] = {}


def _parse_resolutions(steps: str, capacity: int) -> List[Tuple[float, int]]:
    """``metrics_history_steps`` x ``metrics_history_capacity`` -> the
    level ladder. Level i keeps ``capacity * (2 + i) / 2`` slots, so the
    shipped 120 with steps 1,10,60 yields the 1s×120 / 10s×180 / 60s×240
    ladder; malformed knobs degrade to the default ladder rather than
    disabling retention."""
    try:
        parsed = [float(s) for s in steps.split(",") if s.strip()]
        parsed = [s for s in parsed if s > 0]
    except ValueError:
        parsed = []
    if not parsed:
        parsed = [1.0, 10.0, 60.0]
    parsed.sort()
    return [(s, max(1, capacity * (2 + i) // 2))
            for i, s in enumerate(parsed)]


@fieldsan.guarded
class MetricsHistory:
    """Multi-resolution frame rings. NOT internally locked — the owning
    control plane serializes access under its own lock."""

    def __init__(self, capacity: int, steps: str, max_bytes: int):
        self.enabled = capacity > 0
        self.max_bytes = int(max_bytes)
        self.levels = [(_Level(s, c))
                       for s, c in _parse_resolutions(steps, capacity)]
        self.total_bytes = 0
        self.frames_evicted = 0

    # ------------------------------------------------------------ record
    # concurrency: requires(gcs.plane)
    def record(self, ts: float, counters: dict, gauges: dict,
               hists: dict, interval_digests: dict) -> int:
        """Append one snapshot instant. ``counters``/``gauges``/``hists``
        are the merge table's CURRENT values (cumulative — sampling them
        at any cadence is exact); ``interval_digests`` are the digest
        deltas folded since the previous record call (each level merges
        them until its own frame is due). Returns the estimated total
        bytes after the append."""
        if not self.enabled:
            return 0
        for level in self.levels:
            for key, payload in interval_digests.items():
                cur = level.pending_digests.get(key)
                level.pending_digests[key] = (
                    telemetry.merge_digest_payloads(cur, payload)
                    if cur else dict(payload))
            if ts - level.last_ts < level.step:
                continue
            level.last_ts = ts
            digests = {
                key: _recompress(payload)
                for key, payload in level.pending_digests.items()
                if payload.get("count")}
            level.pending_digests = {}
            frame = _Frame(ts, dict(counters), dict(gauges),
                           dict(hists), digests)
            level.frames.append(frame)
            self.total_bytes += frame.nbytes
            while len(level.frames) > level.capacity:
                self._evict(level)
        # hard byte cap: evict oldest FINEST frames first (most
        # numerous, cheapest loss), walking coarser only when a level
        # runs dry — retention degrades, it never blows the budget
        while self.total_bytes > self.max_bytes:
            level = next((lv for lv in self.levels if lv.frames), None)
            if level is None:
                break
            self._evict(level)
        return self.total_bytes

    # concurrency: requires(gcs.plane)
    def _evict(self, level: _Level) -> None:
        frame = level.frames.popleft()
        self.total_bytes -= frame.nbytes
        self.frames_evicted += 1

    # ------------------------------------------------------------- query
    def level_snapshot(self) -> List[tuple]:
        """Cheap ``(step, capacity, [frame refs])`` copy — take this
        under the OWNER'S lock, then run ``query_levels``/``dump_levels``
        outside it: frames are immutable once appended, so the only
        thing the lock must protect is the deque itself. Converting/
        filtering hundreds of frames under the control-plane lock would
        stall scheduling for every dashboard/doctor query."""
        return [(lv.step, lv.capacity, list(lv.frames))
                for lv in self.levels]

    def query(self, name: Optional[str] = None,
              tags: Optional[dict] = None,
              window: Optional[float] = None,
              step: Optional[float] = None) -> dict:
        """Aligned windowed series (see ``query_frames``), picking the
        finest level that covers ``window`` (or honors ``step``)."""
        return query_levels(self.level_snapshot(), self.enabled,
                            name=name, tags=tags, window=window,
                            step=step)

    # -------------------------------------------------------------- dump
    def dump(self) -> dict:
        """Whole-ring JSON-able dump for debug bundles (see
        ``dump_levels`` for the lock-free half)."""
        return dump_levels(self.level_snapshot(), self.enabled,
                           self.total_bytes, self.frames_evicted)


def query_levels(snapshot: List[tuple], enabled: bool,
                 name: Optional[str] = None,
                 tags: Optional[dict] = None,
                 window: Optional[float] = None,
                 step: Optional[float] = None) -> dict:
    """Pure windowed query over a ``level_snapshot``: pick the finest
    level covering ``window`` (or honoring ``step``), then convert ONLY
    the matching entries of the in-window frames."""
    if not enabled or not snapshot:
        return {"series": [], "step_s": 0.0, "window_s": window or 0.0,
                "enabled": False}
    now = max((frames[-1].ts for _s, _c, frames in snapshot if frames),
              default=0.0)
    window = float(window) if window else snapshot[0][0] * snapshot[0][1]
    pick = None
    for lstep, cap, frames in snapshot:
        if step:
            # honor an explicit step: the finest level at/above it
            if lstep >= step:
                pick = (lstep, cap, frames)
                break
            continue
        if frames and now - frames[0].ts >= window * 0.8:
            pick = (lstep, cap, frames)
            break
        if lstep * cap >= window:
            pick = (lstep, cap, frames)
            break
    if pick is None:
        pick = snapshot[-1]
    lstep, _cap, frames = pick
    in_window = [f for f in frames if f.ts >= now - window]
    out = query_frames(_frames_jsonable(in_window, name=name),
                       name=name, tags=tags)
    out.update({"step_s": lstep, "window_s": window, "now": now,
                "enabled": True})
    return out


def dump_levels(snapshot: List[tuple], enabled: bool,
                total_bytes: int, frames_evicted: int) -> dict:
    """JSON-able whole-ring dump from a ``level_snapshot`` (run outside
    the owner's lock), replayed offline by ``query_dump``."""
    return {
        "enabled": enabled,
        "total_bytes": total_bytes,
        "frames_evicted": frames_evicted,
        "levels": [{
            "step_s": lstep,
            "capacity": cap,
            "frames": _frames_jsonable(frames),
        } for lstep, cap, frames in snapshot],
    }


def _recompress(payload: dict) -> dict:
    cents = payload.get("centroids") or []
    if len(cents) <= 2 * _FRAME_DIGEST_CENTROIDS:
        return dict(payload)
    out = dict(payload)
    out["centroids"] = telemetry.compress_centroids(
        [list(c) for c in cents], _FRAME_DIGEST_CENTROIDS)
    return out


def _frames_jsonable(frames, name: Optional[str] = None) -> List[dict]:
    """Tuple-keyed frames -> JSON-able rows ({"name", "tags"} keyed).
    ``name`` filters DURING conversion: a single-metric query over a
    full window must not materialize every other series' rows."""
    out = []
    for f in frames:
        out.append({
            "ts": f.ts,
            "counters": [[k[0], list(k[1]), v]
                         for k, v in f.counters.items()
                         if name is None or k[0] == name],
            "gauges": [[k[0], list(k[1]), v] for k, v in f.gauges.items()
                       if name is None or k[0] == name],
            "hists": [[k[0], list(k[1]), list(v)]
                      for k, v in f.hists.items()
                      if name is None or k[0] == name],
            "digests": [[k[0], list(k[1]), dict(d)]
                        for k, d in f.digests.items()
                        if name is None or k[0] == name],
        })
    return out


# --------------------------------------------------------------- queries
# Pure functions over JSON-able frame lists: the live plane AND the
# offline bundle replay (``rtpu autopsy``) share them verbatim.

def _tags_match(row_tags: list, want: Optional[dict]) -> bool:
    if not want:
        return True
    have = {str(k): str(v) for k, v in row_tags}
    return all(have.get(str(k)) == str(v) for k, v in want.items())


def query_frames(frames: List[dict], name: Optional[str] = None,
                 tags: Optional[dict] = None) -> dict:
    """Frames -> per-series point lists. Digest points carry derived
    quantiles (p50/p95/p99), count and mean of the frame's INTERVAL;
    histogram points carry (count, sum); counter/gauge points the
    value."""
    series: Dict[tuple, dict] = {}

    def ent(metric: str, row_tags: list, kind: str) -> Optional[dict]:
        if name is not None and metric != name:
            return None
        if not _tags_match(row_tags, tags):
            return None
        key = (metric, tuple(tuple(p) for p in row_tags))
        s = series.get(key)
        if s is None:
            s = series[key] = {"name": metric,
                               "tags": {str(k): str(v)
                                        for k, v in row_tags},
                               "kind": kind, "points": []}
        return s

    for f in frames:
        ts = f["ts"]
        for metric, row_tags, value in f.get("counters") or ():
            s = ent(metric, row_tags, "counter")
            if s is not None:
                s["points"].append([ts, value])
        for metric, row_tags, value in f.get("gauges") or ():
            s = ent(metric, row_tags, "gauge")
            if s is not None:
                s["points"].append([ts, value])
        for metric, row_tags, cs in f.get("hists") or ():
            s = ent(metric, row_tags, "histogram")
            if s is not None:
                s["points"].append([ts, {"count": cs[0], "sum": cs[1]}])
        for metric, row_tags, d in f.get("digests") or ():
            s = ent(metric, row_tags, "digest")
            if s is not None:
                cnt = d.get("count") or 0
                s["points"].append([ts, {
                    "p50": telemetry.digest_quantile(d, 0.50),
                    "p95": telemetry.digest_quantile(d, 0.95),
                    "p99": telemetry.digest_quantile(d, 0.99),
                    "count": cnt,
                    "mean": (d.get("sum", 0.0) / cnt) if cnt else 0.0,
                }])
    return {"series": sorted(series.values(),
                             key=lambda s: (s["name"],
                                            sorted(s["tags"].items())))}


def query_dump(dump: dict, name: Optional[str] = None,
               tags: Optional[dict] = None,
               window: Optional[float] = None,
               step: Optional[float] = None) -> dict:
    """Offline twin of ``MetricsHistory.query`` over a bundle dump."""
    levels = dump.get("levels") or []
    if not levels:
        return {"series": [], "step_s": 0.0, "window_s": window or 0.0,
                "enabled": bool(dump.get("enabled"))}
    now = max((lv["frames"][-1]["ts"] for lv in levels if lv["frames"]),
              default=0.0)
    window = float(window) if window else (levels[0]["step_s"]
                                           * levels[0]["capacity"])
    pick = None
    for lv in levels:
        if step and lv["step_s"] >= step:
            pick = lv
            break
        if not step:
            frames = lv["frames"]
            if frames and now - frames[0]["ts"] >= window * 0.8:
                pick = lv
                break
            if lv["step_s"] * lv["capacity"] >= window:
                pick = lv
                break
    if pick is None:
        pick = levels[-1]
    frames = [f for f in pick["frames"] if f["ts"] >= now - window]
    out = query_frames(frames, name=name, tags=tags)
    out.update({"step_s": pick["step_s"], "window_s": window, "now": now,
                "enabled": bool(dump.get("enabled", True))})
    return out


# --------------------------------------------------------------- shaping

def shape_points(points: List[list], shape: str,
                 field: Optional[str] = None) -> List[list]:
    """``rate`` / ``delta`` shaping so cumulative counters become
    usable throughput curves. ``field`` picks a sub-field of dict-valued
    points (histogram count/sum, digest count). ``value`` returns the
    (sub-)values unchanged. Rates clamp negative diffs to 0 — a counter
    reset (plane restart) must not render as negative throughput."""
    vals = []
    for ts, v in points:
        if isinstance(v, dict):
            v = v.get(field or "count", 0.0)
        vals.append([ts, float(v)])
    if shape in (None, "value"):
        return vals
    out = []
    for (t0, v0), (t1, v1) in zip(vals, vals[1:]):
        d = max(0.0, v1 - v0)
        if shape == "delta":
            out.append([t1, d])
        else:   # rate
            dt = max(t1 - t0, 1e-9)
            out.append([t1, d / dt])
    return out


def _head_tail(points: List[list], frac: float = 1.0 / 3.0
               ) -> Tuple[float, float]:
    """Mean of the first vs last ``frac`` of a numeric point list."""
    if not points:
        return 0.0, 0.0
    n = max(1, int(len(points) * frac))
    head = [p[1] for p in points[:n]]
    tail = [p[1] for p in points[-n:]]
    return sum(head) / len(head), sum(tail) / len(tail)


def _num_points(s: dict, field: Optional[str] = None) -> List[list]:
    out = []
    for ts, v in s["points"]:
        if isinstance(v, dict):
            v = v.get(field or "count", 0.0)
        out.append([ts, float(v)])
    return out


# ---------------------------------------------------------------- trends
# The doctor's watchlist: curated movements with cluster meaning. Each
# record: {"metric", "tags", "kind", "head", "tail", "ratio",
# "window_s", "severity", "message"}.

_RISING_GAUGES = {
    "rtpu_object_leaked_objects":
        "leaked objects rising — see `rtpu memory` / state.memory_summary()",
    "rtpu_scheduler_pending_tasks":
        "pending-task queue deepening",
    "rtpu_serve_replica_queue_depth":
        "serve replica queue depth rising",
    "rtpu_object_store_fill_ratio":
        "object store filling",
    "rtpu_collective_inflight_chunks":
        "undelivered collective chunks accumulating",
}

_RISING_DIGEST_P95 = {
    "rtpu_serve_queue_wait_digest_seconds": "queue_wait p95",
    "rtpu_serve_request_latency_digest_seconds": "latency p95",
}


def _fmt_tags(tags: dict) -> str:
    if not tags:
        return ""
    inner = ",".join(f"{k}={v}" for k, v in sorted(tags.items()))
    return "{" + inner + "}"


def compute_trends(result: dict, min_ratio: float = 2.0) -> List[dict]:
    """Head-vs-tail movement detection over one windowed query result
    (ALL series). Pure — the live doctor and the offline autopsy feed
    it the same shape. Conservative by design: only the curated
    watchlist plus the idle-node-while-queueing join can fire, each
    with a ratio floor AND an absolute floor, so a quiet cluster yields
    an empty list rather than noise."""
    out: List[dict] = []
    window = round(float(result.get("window_s") or 0.0))
    series = result.get("series") or []
    for s in series:
        name, tags = s["name"], s["tags"]
        if s["kind"] == "gauge" and name in _RISING_GAUGES:
            head, tail = _head_tail(_num_points(s))
            floor = 0.005 if name.endswith("_ratio") else 0.5
            if tail < floor or tail < min_ratio * max(head, floor / 10):
                continue
            ratio = tail / max(head, 1e-9)
            out.append({
                "metric": name, "tags": tags, "kind": "rising",
                "head": round(head, 4), "tail": round(tail, 4),
                "ratio": round(min(ratio, 999.0), 2),
                "window_s": window, "severity": "warn",
                "message": (f"{name}{_fmt_tags(tags)} "
                            f"{_RISING_GAUGES[name]}: "
                            f"{head:g} -> {tail:g} over {window}s"),
            })
        elif s["kind"] == "digest" and name in _RISING_DIGEST_P95:
            pts = [[ts, v.get("p95", 0.0)] for ts, v in s["points"]
                   if isinstance(v, dict) and v.get("count")]
            head, tail = _head_tail(pts)
            if tail < 0.001 or head <= 0 or tail < min_ratio * head:
                continue
            label = _RISING_DIGEST_P95[name]
            where = tags.get("deployment")
            out.append({
                "metric": name, "tags": tags, "kind": "rising",
                "head": round(head, 5), "tail": round(tail, 5),
                "ratio": round(tail / head, 2),
                "window_s": window, "severity": "warn",
                "message": (f"{label} {tail / head:.1f}x over {window}s"
                            + (f" on deployment {where!r}" if where
                               else "")
                            + f" ({head * 1000:.1f}ms -> "
                              f"{tail * 1000:.1f}ms)"),
            })
        elif (s["kind"] == "counter"
              and name == "rtpu_serve_requests_total"
              and tags.get("status") == "error"):
            rate_pts = shape_points(s["points"], "rate")
            head, tail = _head_tail(rate_pts)
            if tail < 0.2 or tail < min_ratio * max(head, 0.02):
                continue
            out.append({
                "metric": name, "tags": tags, "kind": "rising",
                "head": round(head, 3), "tail": round(tail, 3),
                "ratio": round(tail / max(head, 1e-9), 2),
                "window_s": window, "severity": "warn",
                "message": (f"serve error rate rising on deployment "
                            f"{tags.get('deployment')!r}: "
                            f"{head:.2f}/s -> {tail:.2f}/s over "
                            f"{window}s"),
            })
    out.extend(_idle_node_trends(series, window))
    out.sort(key=lambda r: (-r.get("ratio", 0.0), r["metric"]))
    return out


def _idle_node_trends(series: List[dict], window: int) -> List[dict]:
    """Cross-series join: a node that dispatched NOTHING over the
    window while tasks sit queued somewhere is wasted capacity worth a
    name ("node N idle Ns while tasks queue")."""
    pending_tail = 0.0
    dispatched: Dict[str, Tuple[float, int]] = {}
    for s in series:
        if s["name"] == "rtpu_scheduler_pending_tasks":
            _h, t = _head_tail(_num_points(s))
            pending_tail += t
        elif s["name"] == "rtpu_scheduler_tasks_dispatched_total":
            node = s["tags"].get("node", "?")
            pts = shape_points(s["points"], "delta")
            dispatched[node] = (sum(p[1] for p in pts), len(pts))
    if pending_tail < 1.0:
        return []
    out = []
    for node, (total, n) in sorted(dispatched.items()):
        if n >= 3 and total == 0.0:
            out.append({
                "metric": "rtpu_scheduler_tasks_dispatched_total",
                "tags": {"node": node}, "kind": "idle_node",
                "head": 0.0, "tail": 0.0, "ratio": 0.0,
                "window_s": window, "severity": "warn",
                "message": (f"node {node} dispatched no tasks over "
                            f"{window}s while ~{pending_tail:.0f} "
                            "task(s) sit queued — idle capacity or a "
                            "wedged dispatcher"),
            })
    return out
