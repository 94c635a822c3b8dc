"""In-process runtime telemetry core: the record path is a sharded-lock
dict update — never an RPC.

Equivalent role to the reference's per-node ``MetricsAgent`` →
Prometheus pipeline (``_private/metrics_agent.py``): every process
records into process-local shards; a background flusher batch-pushes
*deltas* to the control plane (direct plane call in node processes, one
fire-and-forget ``PROFILE_EVENT`` frame in workers/drivers), where they
merge into the cluster-wide table served by ``export_prometheus()``,
the dashboard ``/api/metrics`` endpoint and
``state.api.summarize_metrics()``.

Three layers:

1. record  — ``counter_inc`` / ``gauge_set`` / ``hist_observe``:
   lock-cheap shard update, histogram stored as cumulative bucket
   counts + sum/count (bounded memory, unlike raw-observation lists).
2. flush   — ``flush()`` collects per-shard deltas since the last
   flush and ships one batch; runs on a timer, after each worker task,
   and synchronously before an export.
3. sample  — a per-node sampler thread records host stats (RSS, load,
   object-store fill) and CUDA device memory (``torch.cuda.memory_stats``
   and ``mem_get_info``), degrading to a no-op where torch has not
   initialised CUDA.

When tracing is enabled, histogram observations carry the current
``trace_id`` as an exemplar so slow outliers link back to spans.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import warnings
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import fieldsan
from . import locksan
from .config import CONFIG

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0)

_N_SHARDS = 8

# ------------------------------------------------------- quantile digest
# Fixed-memory streaming quantile sketch (small merging t-digest): a
# sorted list of (mean, weight) centroids capped at _DIGEST_CENTROIDS,
# with raw observations staged in a short buffer and folded in by a
# single merge pass whose per-centroid weight limit follows the t-digest
# k1 scale (4·total·q·(1-q)/K) — tails stay near-singleton, the middle
# coarsens, so p50/p95/p99 stay accurate without retaining samples.
# Digests ship through the same delta flusher as histograms: the record
# path keeps a cumulative digest (local snapshots) AND a since-last-
# flush digest (the shipped delta); the control plane merges deltas by
# centroid concatenation + the same compress pass, which is exactly the
# t-digest merge operation — so per-process sketches combine into one
# cluster-wide per-series quantile view.

_DIGEST_CENTROIDS = 64
_DIGEST_BUF = 32


def _digest_merge_pass(items: List[list], k: int) -> List[list]:
    """One merging pass over sorted (mean, weight) pairs: cluster
    weights bounded by the t-digest k1 scale 4·total·q·(1-q)/k, so the
    middle coarsens while the tails stay near-singleton."""
    total = sum(c[1] for c in items)
    out: List[list] = []
    cum = 0.0
    cur_mean, cur_w = items[0]
    for mean, w in items[1:]:
        q = (cum + cur_w / 2.0) / total
        limit = max(1.0, 4.0 * total * q * (1.0 - q) / k)
        if cur_w + w <= limit:
            cur_mean += (mean - cur_mean) * (w / (cur_w + w))
            cur_w += w
        else:
            out.append([cur_mean, cur_w])
            cum += cur_w
            cur_mean, cur_w = mean, w
    out.append([cur_mean, cur_w])
    return out


def _digest_compress(items: List[list], k: int) -> List[list]:
    """Compress (mean, weight) pairs to at most ~2k centroids. The k1
    pass alone converges to O(k·ln n) clusters (the weight limit keeps
    shrinking toward the tails), so re-run it with a halved k until the
    hard cap holds — memory stays FIXED regardless of stream length."""
    if not items:
        return []
    items.sort(key=lambda c: c[0])
    out = _digest_merge_pass(items, k)
    kk = k
    while len(out) > 2 * k and kk > 1:
        kk //= 2
        out = _digest_merge_pass(out, kk)
    return out


class _Digest:
    """One digest series: compressed centroids + a small staging buffer
    (bounded memory; no sample retention beyond the buffer)."""

    __slots__ = ("cents", "buf", "count", "sum", "min", "max")

    def __init__(self):
        self.cents: List[list] = []
        self.buf: List[float] = []
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, value: float) -> None:
        self.buf.append(value)
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if len(self.buf) >= _DIGEST_BUF:
            self._fold()

    def add_many(self, values: List[float], lazy: bool = False) -> None:
        """Bulk fold: ONE compress pass for the whole batch (the
        record path stages raw values and drains them here at flush
        cadence — per-observation cost stays an append). ``lazy``
        defers even that compress by parking the batch in the staging
        buffer until it hits ~_DIGEST_STAGE — the cumulative digest
        (read only by local snapshots) folds on a much coarser cadence
        than the per-flush delta, halving the flush-path cost."""
        if not values:
            return
        self.count += len(values)
        self.sum += sum(values)
        mn, mx = min(values), max(values)
        if mn < self.min:
            self.min = mn
        if mx > self.max:
            self.max = mx
        if lazy:
            self.buf.extend(values)
            if len(self.buf) >= _DIGEST_STAGE:
                self._fold()
            return
        self.cents = _digest_compress(
            self.cents + [[v, 1.0] for v in self.buf]
            + [[v, 1.0] for v in values], _DIGEST_CENTROIDS)
        self.buf = []

    def _fold(self) -> None:
        if self.buf:
            self.cents = _digest_compress(
                self.cents + [[v, 1.0] for v in self.buf],
                _DIGEST_CENTROIDS)
            self.buf = []

    def merge_payload(self, payload: dict) -> None:
        if not payload or not payload.get("count"):
            return
        self._fold()
        self.cents = _digest_compress(
            self.cents + [list(c) for c in payload.get("centroids") or ()],
            _DIGEST_CENTROIDS)
        self.count += int(payload["count"])
        self.sum += float(payload.get("sum", 0.0))
        self.min = min(self.min, float(payload.get("min", self.min)))
        self.max = max(self.max, float(payload.get("max", self.max)))

    def to_payload(self) -> dict:
        self._fold()
        return {"centroids": [list(c) for c in self.cents],
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}


def compress_centroids(items: List[list], k: int) -> List[list]:
    """Public fold for OTHER holders of digest centroid lists (the
    metrics-history rings recompress frame payloads to a coarser cap):
    same k1 merge pass the live digests use."""
    return _digest_compress(items, k)


def merge_digest_payloads(cur: Optional[dict], new: dict) -> dict:
    """Merge two shipped digest payloads (the control-plane fold)."""
    if not cur or not cur.get("count"):
        return {"centroids": [list(c) for c in new.get("centroids") or ()],
                "count": int(new.get("count", 0)),
                "sum": float(new.get("sum", 0.0)),
                "min": float(new.get("min", float("inf"))),
                "max": float(new.get("max", float("-inf")))}
    if not new.get("count"):
        return cur
    d = _Digest()
    d.merge_payload(cur)
    d.merge_payload(new)
    return d.to_payload()


def digest_quantile(payload: Optional[dict], q: float) -> float:
    """Estimate quantile ``q`` (0..1) from a shipped digest payload
    (midpoint interpolation between centroid means, clamped to the
    exact observed min/max)."""
    if not payload or not payload.get("count"):
        return 0.0
    cents = sorted((list(c) for c in payload.get("centroids") or ()),
                   key=lambda c: c[0])
    lo = float(payload.get("min", cents[0][0] if cents else 0.0))
    hi = float(payload.get("max", cents[-1][0] if cents else 0.0))
    if not cents:
        return lo
    total = sum(c[1] for c in cents)
    target = q * total
    cum = 0.0
    prev_mean, prev_mid = lo, 0.0
    for mean, w in cents:
        mid = cum + w / 2.0
        if target <= mid:
            if mid == prev_mid:
                return max(lo, min(hi, mean))
            frac = (target - prev_mid) / (mid - prev_mid)
            return max(lo, min(hi, prev_mean + (mean - prev_mean) * frac))
        prev_mean, prev_mid = mean, mid
        cum += w
    return hi


class _Hist:
    __slots__ = ("buckets", "counts", "sum", "count", "exemplar",
                 "f_counts", "f_sum", "f_count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)      # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        self.exemplar: Optional[dict] = None
        self.f_counts = [0] * (len(buckets) + 1)    # flushed watermark
        self.f_sum = 0.0
        self.f_count = 0


@fieldsan.guarded
class _Shard:
    def __init__(self):
        self.lock = locksan.lock("telemetry.shard")
        self.counters: Dict[tuple, list] = {}       # key -> [live, flushed]
        self.gauges: Dict[tuple, tuple] = {}        # key -> (value, ts)
        self.gauges_dirty: set = set()              # keys set since flush
        self.hists: Dict[tuple, _Hist] = {}
        # key -> [cumulative _Digest, since-last-flush _Digest, raw
        # staging buffer]. The record path ONLY appends to the staging
        # buffer; values drain into both digests (one bulk compress
        # each) at flush/snapshot time, or when the buffer hits
        # _DIGEST_STAGE cap under a burst — so the per-observation cost
        # is a list append, like counters.
        self.digests: Dict[tuple, list] = {}


_shards = [_Shard() for _ in range(_N_SHARDS)]

# metric metadata, keyed by NAME (Prometheus requires one kind and one
# bucket layout per name); conflicting re-definitions warn and keep the
# first definition instead of silently clobbering buckets
_meta: Dict[str, dict] = {}
_meta_lock = locksan.lock("telemetry.meta")
_conflict_warned: set = set()

# per-process node registry: NodeService instances sampled by the
# sampler thread and used as the preferred flush transport (direct
# plane call — no socket hop for node/head processes)
_nodes: List[Any] = []
_runtime_lock = locksan.lock("telemetry.runtime")
_flusher_started = False
_sampler_started = False
_last_flush = 0.0


def _shard(key: tuple) -> _Shard:
    return _shards[hash(key) & (_N_SHARDS - 1)]


# bumped by reset(): pinned digest_series handles re-resolve into the
# fresh shard tables instead of writing to orphaned entries
_digest_gen = 0


def define(kind: str, name: str, description: str = "",
           buckets: Optional[Sequence[float]] = None) -> str:
    """Register metric metadata once; returns ``name`` so module-level
    constants read naturally (no side effects beyond the registry —
    importing an instrumented module must not spawn threads). Kind/
    bucket conflicts warn and keep the first definition."""
    b = tuple(buckets) if buckets else (tuple(DEFAULT_BUCKETS)
                                        if kind == "histogram" else None)
    with _meta_lock:
        existing = _meta.get(name)
        if existing is None:
            _meta[name] = {"kind": kind, "description": description,
                           "buckets": b}
        elif (existing["kind"] != kind
              or (kind == "histogram" and existing["buckets"] != b)):
            if name not in _conflict_warned:
                _conflict_warned.add(name)
                warnings.warn(
                    f"metric {name!r} re-defined with conflicting "
                    f"kind/buckets ({existing['kind']}/"
                    f"{existing['buckets']} vs {kind}/{b}); keeping the "
                    "first definition", stacklevel=2)
        elif description and not existing["description"]:
            existing["description"] = description
    return name


def enabled() -> bool:
    return bool(CONFIG.telemetry_enabled)


# ------------------------------------------------------------ record path

def counter_inc(name: str, value: float = 1.0, tags: tuple = ()) -> None:
    if not CONFIG.telemetry_enabled:
        return
    if not _flusher_started:
        _ensure_flusher()
    key = (name, tags)
    sh = _shard(key)
    with sh.lock:
        ent = sh.counters.get(key)
        if ent is None:
            sh.counters[key] = [value, 0.0]
        else:
            ent[0] += value


def gauge_set(name: str, value: float, tags: tuple = ()) -> None:
    if not CONFIG.telemetry_enabled:
        return
    if not _flusher_started:
        _ensure_flusher()
    key = (name, tags)
    sh = _shard(key)
    with sh.lock:
        sh.gauges[key] = (value, time.time())
        sh.gauges_dirty.add(key)


def gauge_delete(name: str, tags: tuple = ()) -> None:
    """Retire one gauge SERIES cluster-wide: ships a NaN marker through
    the normal delta flush; the control plane (and the local snapshot)
    drop the series instead of exporting the marker. For series whose
    identity dies with its subject — a stopped serve replica's queue
    depth must not read as a live value (or a sentinel) forever on
    Prometheus/dashboard/summary surfaces. Best-effort under races: a
    straggling publish from the dying process can resurrect the series
    until its next delete."""
    gauge_set(name, float("nan"), tags)


def hist_observe(name: str, value: float, tags: tuple = (),
                 boundaries: Optional[Tuple[float, ...]] = None) -> None:
    if not CONFIG.telemetry_enabled:
        return
    if not _flusher_started:
        _ensure_flusher()
    if boundaries is None:
        m = _meta.get(name)
        boundaries = (m["buckets"] if m and m.get("buckets")
                      else DEFAULT_BUCKETS)
    key = (name, tags)
    sh = _shard(key)
    exemplar = None
    if CONFIG.tracing_enabled:
        from ..util import tracing
        ctx = tracing.get_current_context()
        if ctx and ctx.get("trace_id"):
            exemplar = {"trace_id": ctx["trace_id"], "value": value,
                        "ts": time.time()}
    idx = bisect_left(boundaries, value)
    with sh.lock:
        h = sh.hists.get(key)
        if h is None:
            h = sh.hists[key] = _Hist(tuple(boundaries))
        h.counts[min(idx, len(h.counts) - 1)] += 1
        h.sum += value
        h.count += 1
        if exemplar is not None:
            h.exemplar = exemplar


_DIGEST_STAGE = 512


def _drain_digest(ent: list) -> None:
    """Fold a series' staged raw values into both its cumulative and
    its since-last-flush digest (caller holds the shard lock). The
    cumulative side folds LAZILY — it is only read by local snapshots,
    so the per-flush compress cost is one pass (the shipped delta),
    not two."""
    if ent[2]:
        ent[0].add_many(ent[2], lazy=True)
        ent[1].add_many(ent[2])
        ent[2] = []


def digest_observe(name: str, value: float, tags: tuple = ()) -> None:
    """Record one observation into a streaming quantile digest (fixed
    memory, same sharded no-RPC record path as histograms; the delta
    flusher ships centroids and the plane t-digest-merges them). The
    record path is a list append — compression runs at flush cadence
    (or at the staging cap under a burst), never per observation."""
    if not CONFIG.telemetry_enabled:
        return
    if not _flusher_started:
        _ensure_flusher()
    _digest_record((name, tags), float(value))


def digest_series(name: str, tags: tuple = ()):
    """Prebind one digest series for per-call-site hot paths (serve
    replicas record two digests per request): returns a mutable handle
    for ``digest_record`` that caches the resolved shard + entry, so
    the per-observation cost is one lock + one list append — no key
    hash, no dict lookup. Handles survive ``reset()`` via a generation
    check (the next record re-resolves into the fresh shard tables)."""
    return [(name, tags), None, None, -1]


def digest_record(series, value: float) -> None:
    """Record into a ``digest_series`` handle (hot-path variant of
    ``digest_observe`` — same semantics, fewer per-observation costs)."""
    # direct _values read: __getattr__ dispatch costs ~0.4µs/read and
    # this runs twice per serve request
    if not CONFIG._values["telemetry_enabled"]:
        return
    if not _flusher_started:
        _ensure_flusher()
    sh = series[1]
    if series[3] != _digest_gen:
        key = series[0]
        sh = _shard(key)
        with sh.lock:
            ent = sh.digests.get(key)
            if ent is None:
                ent = [_Digest(), _Digest(), []]
                sh.digests[key] = ent
        series[1], series[2], series[3] = sh, ent, _digest_gen
    ent = series[2]
    with sh.lock:
        ent[2].append(float(value))
        if len(ent[2]) >= _DIGEST_STAGE:
            _drain_digest(ent)


def _digest_record(key: tuple, value: float) -> None:
    sh = _shard(key)
    with sh.lock:
        ent = sh.digests.get(key)
        if ent is None:
            ent = sh.digests[key] = [_Digest(), _Digest(), []]
        ent[2].append(value)
        if len(ent[2]) >= _DIGEST_STAGE:
            _drain_digest(ent)


# --------------------------------------------------------------- flushing

_last_digest_ship = 0.0
_DIGEST_SHIP_INTERVAL_S = 1.0


def _collect_deltas() -> Optional[dict]:
    """Per-shard deltas since the last collect; None when nothing moved.
    Advances the flushed watermark, so call only with a transport in
    hand. Digest deltas ship on their own coarser cadence (~1s):
    counters/gauges are cheap to ship per flush, but a digest delta
    costs a compress pass here AND a merge pass on the plane — at the
    0.2s task-boundary flush rate that CPU competes with the serving
    path itself on small boxes, for freshness nothing consumes."""
    global _last_digest_ship
    counters: Dict[tuple, float] = {}
    gauges: Dict[tuple, tuple] = {}
    hists: Dict[tuple, dict] = {}
    digests: Dict[tuple, dict] = {}
    now = time.monotonic()
    ship_digests = now - _last_digest_ship >= _DIGEST_SHIP_INTERVAL_S
    for sh in _shards:
        with sh.lock:
            for key, ent in sh.counters.items():
                d = ent[0] - ent[1]
                if d:
                    counters[key] = d
                    ent[1] = ent[0]
            for key in sh.gauges_dirty:
                if key in sh.gauges:
                    gauges[key] = sh.gauges[key]
                    if sh.gauges[key][0] != sh.gauges[key][0]:
                        # NaN delete marker: ship it once, then drop
                        # the local series too
                        del sh.gauges[key]
            sh.gauges_dirty.clear()
            for key, h in sh.hists.items():
                dc = [a - b for a, b in zip(h.counts, h.f_counts)]
                if h.count - h.f_count or h.exemplar is not None:
                    hists[key] = {"buckets": h.buckets, "counts": dc,
                                  "sum": h.sum - h.f_sum,
                                  "count": h.count - h.f_count,
                                  "exemplar": h.exemplar}
                    h.f_counts = list(h.counts)
                    h.f_sum = h.sum
                    h.f_count = h.count
                    h.exemplar = None
            if ship_digests:
                for key, dent in sh.digests.items():
                    _drain_digest(dent)
                    if dent[1].count:
                        digests[key] = dent[1].to_payload()
                        dent[1] = _Digest()
    if digests:
        _last_digest_ship = now
    if not (counters or gauges or hists or digests):
        return None
    with _meta_lock:
        meta = {name: dict(m) for name, m in _meta.items()}
    return {"counters": counters, "gauges": gauges, "hists": hists,
            "digests": digests, "meta": meta}


def _transport():
    """Preferred delta sink: a registered node's control plane (direct,
    no socket), else this process's connected client (one
    fire-and-forget PROFILE_EVENT frame)."""
    with _runtime_lock:
        nodes = list(_nodes)
    for node in nodes:
        if not getattr(node, "dead", False):
            return lambda payload, _g=node.gcs: _g.record_metrics(payload)
    from . import context as _ctx
    client = _ctx.current_client
    if client is not None and not client._closed.is_set():
        return lambda payload, _c=client: _c.send_profile_event(
            "metrics", payload)
    return None


def _restore_deltas(payload: dict) -> None:
    """A send failed after the watermark advanced: roll the watermark
    back so the deltas ship with the next flush instead of vanishing."""
    for key, d in payload.get("counters", {}).items():
        sh = _shard(key)
        with sh.lock:
            ent = sh.counters.get(key)
            if ent is not None:
                ent[1] -= d
    for key, vt in payload.get("gauges", {}).items():
        sh = _shard(key)
        with sh.lock:
            if key in sh.gauges:
                sh.gauges_dirty.add(key)
            elif vt[0] != vt[0]:
                # a NaN delete marker was dropped at collect time; the
                # failed send must re-queue it or the plane never
                # forgets the series
                sh.gauges[key] = tuple(vt)
                sh.gauges_dirty.add(key)
    for key, hd in payload.get("hists", {}).items():
        sh = _shard(key)
        with sh.lock:
            h = sh.hists.get(key)
            if h is None or h.buckets != tuple(hd["buckets"]):
                continue
            h.f_counts = [a - b for a, b in zip(h.f_counts, hd["counts"])]
            h.f_sum -= hd["sum"]
            h.f_count -= hd["count"]
            if h.exemplar is None:
                h.exemplar = hd.get("exemplar")
    for key, dd in payload.get("digests", {}).items():
        sh = _shard(key)
        with sh.lock:
            ent = sh.digests.get(key)
            if ent is None:
                ent = sh.digests[key] = [_Digest(), _Digest(), []]
                ent[0].merge_payload(dd)
            ent[1].merge_payload(dd)


def flush() -> None:
    """Ship accumulated deltas to the control plane. Never raises; with
    no transport available (or a failed send) the deltas keep
    accumulating locally for the next attempt."""
    global _last_flush
    sink = _transport()
    if sink is None:
        return
    payload = _collect_deltas()
    if payload is None:
        return
    _last_flush = time.monotonic()
    try:
        sink(payload)
    except Exception:   # noqa: BLE001 — telemetry must never break work
        _restore_deltas(payload)


def maybe_flush(min_interval_s: float = 0.2) -> None:
    """Rate-limited flush for per-task-completion call sites: frequent
    enough for freshness, bounded so a storm of tiny tasks doesn't pay
    one control-plane frame each."""
    if time.monotonic() - _last_flush >= min_interval_s:
        flush()


def _ensure_flusher() -> None:
    global _flusher_started
    if _flusher_started:
        return
    with _runtime_lock:
        if _flusher_started:
            return
        _flusher_started = True
    t = threading.Thread(target=_flush_loop, daemon=True,
                         name="rtpu-telemetry-flush")
    t.start()


def _flush_loop() -> None:
    while True:
        time.sleep(max(CONFIG.metrics_report_interval_ms, 250) / 1000.0)
        try:
            flush()
        except Exception:   # noqa: BLE001
            pass


# ------------------------------------------------------------- snapshots

def snapshot_local() -> dict:
    """Merged totals of this process's shards (fallback export surface
    when no runtime is connected; also what unit tests inspect)."""
    counters: Dict[tuple, float] = {}
    gauges: Dict[tuple, tuple] = {}
    hists: Dict[tuple, dict] = {}
    digests: Dict[tuple, dict] = {}
    for sh in _shards:
        with sh.lock:
            for key, ent in sh.counters.items():
                counters[key] = counters.get(key, 0.0) + ent[0]
            gauges.update((k, v) for k, v in sh.gauges.items()
                          if v[0] == v[0])    # skip NaN delete markers
            for key, h in sh.hists.items():
                hists[key] = {"buckets": h.buckets,
                              "counts": list(h.counts),
                              "sum": h.sum, "count": h.count,
                              "exemplar": h.exemplar}
            for key, dent in sh.digests.items():
                _drain_digest(dent)
                digests[key] = dent[0].to_payload()
    with _meta_lock:
        meta = {name: dict(m) for name, m in _meta.items()}
    return {"counters": counters, "gauges": gauges, "hists": hists,
            "digests": digests, "meta": meta}


def reset() -> None:
    """Drop all local series and node registrations (session teardown:
    the next init() must not inherit this session's samples)."""
    global _digest_gen
    _digest_gen += 1
    for sh in _shards:
        with sh.lock:
            sh.counters.clear()
            sh.gauges.clear()
            sh.gauges_dirty.clear()
            sh.hists.clear()
            sh.digests.clear()
    with _runtime_lock:
        _nodes.clear()


# ----------------------------------------------------- node runtime hooks

M_TASKS_SUBMITTED = define(
    "counter", "rtpu_scheduler_tasks_submitted_total",
    "Tasks submitted to this node's scheduler (incl. actor calls)")
M_TASKS_DISPATCHED = define(
    "counter", "rtpu_scheduler_tasks_dispatched_total",
    "Tasks assigned to a worker by the local dispatcher")
M_TASKS_FINISHED = define(
    "counter", "rtpu_scheduler_tasks_finished_total",
    "Tasks completed on this node, tagged status=ok|error")
M_QUEUE_WAIT = define(
    "histogram", "rtpu_scheduler_queue_wait_seconds",
    "Pending-queue wait between task arrival and worker assignment")
M_PENDING_TASKS = define(
    "gauge", "rtpu_scheduler_pending_tasks",
    "Tasks in the local ready-to-dispatch queue")
M_LEASE_REUSED = define(
    "counter", "rtpu_scheduler_lease_reused_total",
    "Completions whose worker lease was handed straight to the next "
    "pipelined task (no scheduler round trip)")
M_PIPELINE_DEPTH = define(
    "gauge", "rtpu_scheduler_pipeline_depth",
    "Tasks currently leased onto busy workers beyond their running "
    "task, summed over the node's workers (sampled)")
M_SUBMIT_BATCH = define(
    "histogram", "rtpu_scheduler_submit_batch_specs",
    "Task/actor-call specs per coalesced SUBMIT_BATCH frame admitted "
    "by the dispatcher as one scheduling pass",
    buckets=(2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0))
M_STORE_PUTS = define(
    "counter", "rtpu_object_store_puts_total",
    "Objects sealed into the local object store")
M_STORE_PUT_BYTES = define(
    "counter", "rtpu_object_store_put_bytes_total",
    "Bytes sealed into the local object store")
M_STORE_GET_BYTES = define(
    "counter", "rtpu_object_store_get_bytes_total",
    "Bytes served to get() callers from this node")
M_STORE_HITS = define(
    "counter", "rtpu_object_store_hits_total",
    "get() lookups resolved immediately from the directory/store")
M_STORE_MISSES = define(
    "counter", "rtpu_object_store_misses_total",
    "get() lookups that had to wait for the object to appear")
M_STORE_USED = define(
    "gauge", "rtpu_object_store_used_bytes",
    "Object store bytes in use (sampled)")
M_STORE_CAPACITY = define(
    "gauge", "rtpu_object_store_capacity_bytes",
    "Object store capacity (sampled)")
M_STORE_FILL = define(
    "gauge", "rtpu_object_store_fill_ratio",
    "used_bytes / capacity_bytes of the local store (sampled)")
M_STORE_OBJECTS = define(
    "gauge", "rtpu_object_store_objects",
    "Live objects in the local store (sampled)")
M_STORE_SPILLED = define(
    "gauge", "rtpu_object_store_spilled_objects",
    "Objects spilled to disk since node start (sampled)")
M_STORE_SHM_BYTES = define(
    "gauge", "rtpu_object_store_shm_bytes",
    "Bytes resident in shared memory (arena blocks + POSIX segments) "
    "for this node's store (sampled)")
M_STORE_ARENA_FILL = define(
    "gauge", "rtpu_object_store_arena_fill_ratio",
    "arena_used_bytes / arena_capacity_bytes of the node's shm arena "
    "(sampled; 0 when the native arena is unavailable)")
M_OBJ_SPILLED_BYTES = define(
    "counter", "rtpu_object_spilled_bytes_total",
    "Bytes written to spill files under memory pressure")
M_OBJ_RESTORED = define(
    "counter", "rtpu_object_restored_total",
    "Spilled objects restored on demand (get/task-arg/pull)")
M_OBJ_CALLSITES = define(
    "counter", "rtpu_object_callsites_recorded_total",
    "Creation callsites captured for puts / task returns / actor "
    "creations (object_callsite_enabled provenance plane)")
M_OBJ_LEAKED = define(
    "gauge", "rtpu_object_leaked_objects",
    "Objects the control-plane leak sweep currently flags: every ref "
    "holder lives on a dead node, or pinned with zero holders past "
    "memory_leak_pinned_ttl_s")
M_GCS_RPC_LATENCY = define(
    "histogram", "rtpu_gcs_rpc_latency_seconds",
    "Round-trip latency of synchronous control-plane RPCs, tagged by "
    "method")
M_GCS_RPC_TOTAL = define(
    "counter", "rtpu_gcs_rpc_total",
    "Control-plane RPCs issued, tagged method and kind=call|cast")
M_NODE_RSS = define(
    "gauge", "rtpu_node_rss_bytes",
    "Resident set size of the node service process (sampled)")
M_NODE_LOAD = define(
    "gauge", "rtpu_node_cpu_load_1m",
    "Host 1-minute load average (sampled)")
M_NODE_WORKERS = define(
    "gauge", "rtpu_node_workers",
    "Worker processes attached to this node (sampled)")
M_HBM_USED = define(
    "gauge", "rtpu_device_hbm_bytes_in_use",
    "GPU memory allocated by torch per CUDA device (sampled; absent "
    "until torch initialises CUDA)")
M_HBM_LIMIT = define(
    "gauge", "rtpu_device_hbm_bytes_limit",
    "Total memory per CUDA device (sampled; absent until torch "
    "initialises CUDA)")
M_DROPPED_SERIES = define(
    "counter", "rtpu_telemetry_dropped_series_total",
    "Metric series dropped by the control plane (cardinality cap or "
    "histogram bucket conflicts); synthesized at export from the "
    "plane's drop counter")
# wire transport (``protocol.Connection``): recorded per writer flush /
# receive wakeup, never per message — the hot path stays lock-cheap
_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
M_TRANSPORT_FLUSH_FRAMES = define(
    "histogram", "rtpu_transport_flush_frames",
    "Messages coalesced per connection-writer flush",
    buckets=_BATCH_BUCKETS)
M_TRANSPORT_RECV_FRAMES = define(
    "histogram", "rtpu_transport_recv_frames",
    "Messages decoded per receive wakeup (burst dispatch)",
    buckets=_BATCH_BUCKETS)
M_TRANSPORT_SEND_BYTES = define(
    "counter", "rtpu_transport_send_bytes_total",
    "Bytes written to control-plane sockets (frames incl. headers)")
M_TRANSPORT_OOB_BYTES = define(
    "counter", "rtpu_transport_oob_bytes_total",
    "Payload bytes shipped out-of-band as zero-copy iovecs")
M_TRANSPORT_QUEUE_STALLS = define(
    "counter", "rtpu_transport_queue_stalls_total",
    "Producer blocks on a full connection send queue (backpressure)")


def attach_node(node) -> None:
    """Register a NodeService for host/store sampling and direct-plane
    flushing; starts the per-process sampler thread on first call."""
    global _sampler_started
    with _runtime_lock:
        if node not in _nodes:
            _nodes.append(node)
        start = not _sampler_started
        _sampler_started = True
    _ensure_flusher()
    if start:
        t = threading.Thread(target=_sample_loop, daemon=True,
                             name="rtpu-telemetry-sampler")
        t.start()


def detach_node(node) -> None:
    with _runtime_lock:
        if node in _nodes:
            _nodes.remove(node)


def _sample_loop() -> None:
    while True:
        time.sleep(max(CONFIG.telemetry_sample_interval_ms, 250) / 1000.0)
        try:
            sample_once()
            flush()
        except Exception:   # noqa: BLE001 — a bad sample is a gap
            pass


def sample_once() -> None:
    """One host + store + device sampling pass (called by the sampler
    thread; separately callable for tests)."""
    with _runtime_lock:
        nodes = [n for n in _nodes if not getattr(n, "dead", False)]
    for node in nodes:
        tags = (("node", node.node_id.hex()[:12]),)
        try:
            stats = node.store.stats()
            used = stats.get("used_bytes", 0)
            cap = stats.get("capacity_bytes", 0) or 1
            gauge_set(M_STORE_USED, float(used), tags)
            gauge_set(M_STORE_CAPACITY, float(cap), tags)
            gauge_set(M_STORE_FILL, used / cap, tags)
            gauge_set(M_STORE_OBJECTS, float(stats.get("num_objects", 0)),
                      tags)
            gauge_set(M_STORE_SPILLED, float(stats.get("num_spilled", 0)),
                      tags)
            gauge_set(M_STORE_SHM_BYTES, float(stats.get("shm_bytes", 0)),
                      tags)
            gauge_set(M_STORE_ARENA_FILL,
                      (stats.get("arena_used_bytes", 0)
                       / (stats.get("arena_capacity_bytes", 0) or 1)),
                      tags)
        except Exception:   # noqa: BLE001
            pass
        try:
            gauge_set(M_PENDING_TASKS, float(len(node._pending)), tags)
            gauge_set(M_NODE_WORKERS, float(len(node._workers)), tags)
            gauge_set(M_PIPELINE_DEPTH,
                      float(sum(len(w.pipeline)
                                for w in list(node._workers.values()))),
                      tags)
        except Exception:   # noqa: BLE001
            pass
        _sample_host(tags)
    sample_devices()


def _sample_host(tags: tuple) -> None:
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        gauge_set(M_NODE_RSS, float(rss_pages * os.sysconf("SC_PAGE_SIZE")),
                  tags)
    except (OSError, ValueError, IndexError):
        pass
    try:
        gauge_set(M_NODE_LOAD, os.getloadavg()[0], tags)
    except OSError:
        pass


def sample_devices() -> int:
    """Record per-device memory gauges for each CUDA device this process
    sees: ``torch.cuda.memory_stats(i)["allocated_bytes.all.current"]`` as
    in use and the device's total from ``torch.cuda.mem_get_info(i)`` as
    the limit, tagged ``cuda:<i>``. Returns the number of devices that
    reported; 0 (and records nothing) unless torch is already imported
    and has initialised CUDA in this process — sampling never imports
    torch and never initialises CUDA. Never raises."""
    torch = sys.modules.get("torch")
    reported = 0
    try:
        if torch is None or not torch.cuda.is_initialized():
            return 0
        for i in range(torch.cuda.device_count()):
            tags = (("device", f"cuda:{i}"),)
            used = torch.cuda.memory_stats(i).get(
                "allocated_bytes.all.current")
            if used is not None:
                gauge_set(M_HBM_USED, float(used), tags)
                reported += 1
            gauge_set(M_HBM_LIMIT, float(torch.cuda.mem_get_info(i)[1]),
                      tags)
    except Exception:   # noqa: BLE001 — sampling must never raise
        return reported
    return reported


# guarded-by plane: wrap the declared module-level registries in
# checking proxies (no-op when RTPU_FIELDSAN is off)
fieldsan.instrument_module(globals(), "telemetry")
