"""Black-box post-mortem bundles: capture everything a session knows
into one portable tar, replay it offline.

``rtpu debug-bundle`` (or an auto-capture on a terminal failure —
collective reform budget exhaustion, a memory-monitor OOM kill, driver
shutdown on an uncaught error) snapshots every observability surface
the runtime has — metrics + their retention history, cluster events,
lifecycle transitions, stacks, flight-recorder rings, access logs,
spans, the memory/provenance ledger, config + versions — as JSON
sections inside a ``.tar.gz`` with a versioned manifest. ``rtpu
autopsy <bundle>`` then rebuilds the doctor / coll-debug / serve-status
/ memory surfaces from the captured sections through the SAME pure
builders the live CLI uses, with no cluster running: a chaos casualty
leaves a corpse worth reading.

Reference analogue: the flight-recorder style "cluster state dump"
workflows around ``ray cluster-dump`` — scoped here to the surfaces
this runtime actually has, and made replayable instead of just
archived.

The section list is a REGISTRY: ``BUNDLE_SECTIONS`` (a pure literal)
must match the ``_capture_<name>`` functions below both ways —
``scripts/check_metrics.py`` lints the pairing exactly like the config
knob and metric registries, so a new surface can't silently miss the
bundle (or a dead section linger in the manifest).
"""

from __future__ import annotations

import io
import json
import os
import platform
import sys
import tarfile
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from . import locksan
from . import telemetry
from .config import CONFIG

BUNDLE_FORMAT_VERSION = 1
BUNDLE_KIND = "rtpu-debug-bundle"

# every surface a bundle captures, in manifest order (one <name>.json
# per section). Keep this a pure tuple literal: the lint reads it.
BUNDLE_SECTIONS = (
    "config",
    "nodes",
    "resources",
    "tasks",
    "actors",
    "objects",
    "memory",
    "jobs",
    "placement_groups",
    "events",
    "lifecycle",
    "spans",
    "metrics",
    "metrics_history",
    "stacks",
    "collectives",
    "flight_records",
    "serve",
    "serve_requests",
    "reconstruct_stats",
)

M_BUNDLES = telemetry.define(
    "counter", "rtpu_debug_bundles_total",
    "Post-mortem debug bundles captured, tagged by trigger reason "
    "(manual | oom_kill | collective_reform_exhausted | driver_error)")


class ClientSource:
    """Capture adapter over a connected ``CoreClient`` (driver/worker/
    CLI processes)."""

    kind = "client"

    def __init__(self, client):
        self._client = client

    def state_query(self, what: str, filters=None):
        return self._client.state_query(what, filters)

    def cluster_info(self, what: str):
        return self._client.cluster_info(what)

    def cluster_stacks(self, timeout_s: float):
        return self._client.cluster_stacks(timeout_s)

    def collective_health(self, timeout_s: float):
        return self._client.collective_health(timeout_s)

    def flight_records(self, timeout_s: float):
        return self._client.flight_records(timeout_s)

    def serve_requests(self, limit: int):
        from ..state import api as state_api
        return state_api.serve_requests(limit=limit, timeout_s=5.0)

    def emit_event(self, payload: dict) -> None:
        # the node's EventLogger owns the literal DEBUG_BUNDLE emit
        # (statically lintable); this process only relays
        self._client.send_profile_event("debug_bundle", payload)


class NodeSource:
    """Capture adapter over an in-process ``NodeService`` (the OOM-kill
    auto-capture runs on the node's own surfaces — no client needed)."""

    kind = "node"

    def __init__(self, node):
        self._node = node

    def state_query(self, what: str, filters=None):
        return self._node._state_query(what, filters)

    def cluster_info(self, what: str):
        return self._node._cluster_info(what)

    def cluster_stacks(self, timeout_s: float):
        return self._node.cluster_stacks(timeout_s)

    def collective_health(self, timeout_s: float):
        return self._node.collective_health(timeout_s)

    def flight_records(self, timeout_s: float):
        return self._node.collect_flight_records(timeout_s)

    def serve_requests(self, limit: int):
        return []       # access logs need a live actor client; skip

    def emit_event(self, payload: dict) -> None:
        rec = dict(payload)
        msg = str(rec.pop("message", "debug bundle captured"))
        self._node.events.info("DEBUG_BUNDLE", msg, **rec)


# ------------------------------------------------------- section capture

def _capture_config(src, timeout_s: float, ctx: dict):
    return {
        "config": CONFIG.dump(),
        "versions": {
            "python": sys.version.split()[0],
            "platform": platform.platform(),
            "ray_tpu": _pkg_version(),
        },
        "pid": os.getpid(),
        "argv": list(sys.argv),
    }


def _pkg_version() -> str:
    try:
        import importlib.metadata as _md
        return _md.version("ray-tpu")
    except Exception:   # noqa: BLE001 — dev checkout
        return "dev"


def _capture_nodes(src, timeout_s: float, ctx: dict):
    from ..state import api as state_api
    return state_api.shape_nodes(src.cluster_info("nodes") or [])


def _capture_resources(src, timeout_s: float, ctx: dict):
    return {"total": src.cluster_info("resources_total") or {},
            "available": src.cluster_info("resources_available") or {}}


def _capture_tasks(src, timeout_s: float, ctx: dict):
    from ..state import api as state_api
    return state_api.shape_tasks(src.state_query("tasks") or [])


def _capture_actors(src, timeout_s: float, ctx: dict):
    from ..state import api as state_api
    return state_api.shape_actors(src.state_query("actors") or [])


def _capture_objects(src, timeout_s: float, ctx: dict):
    from ..state import api as state_api
    return state_api.shape_objects(src.state_query("objects") or [])


def _capture_memory(src, timeout_s: float, ctx: dict):
    from ..state import api as state_api
    mem = src.state_query("memory") or {}
    return {"objects": state_api.shape_objects(mem.get("objects")),
            "leaks": state_api.shape_leaks(mem.get("leaks")),
            "stores": mem.get("stores") or {}}


def _capture_jobs(src, timeout_s: float, ctx: dict):
    rows = src.state_query("jobs") or []
    return [{**r, "job_id": (r["job_id"].hex()
                             if hasattr(r.get("job_id"), "hex")
                             else str(r.get("job_id")))}
            for r in rows]


def _capture_placement_groups(src, timeout_s: float, ctx: dict):
    from ..state import api as state_api
    return state_api.shape_placement_groups(
        src.state_query("placement_groups") or [])


def _capture_events(src, timeout_s: float, ctx: dict):
    return {"rows": src.state_query("cluster_events") or [],
            "stats": src.state_query("events_stats") or {}}


def _capture_lifecycle(src, timeout_s: float, ctx: dict):
    return src.state_query("lifecycle") or []


def _capture_spans(src, timeout_s: float, ctx: dict):
    return src.state_query("spans") or []


def _capture_metrics(src, timeout_s: float, ctx: dict):
    from ..state import api as state_api
    rows = state_api.shape_metrics(src.state_query("metrics") or {})
    # stash for later sections (serve) — ONE metrics fetch per capture
    ctx["metrics_rows"] = rows
    return rows


def _capture_metrics_history(src, timeout_s: float, ctx: dict):
    return src.state_query("metrics_history_dump") or {}


def _capture_stacks(src, timeout_s: float, ctx: dict):
    return src.cluster_stacks(timeout_s) or {}


def _capture_collectives(src, timeout_s: float, ctx: dict):
    return src.collective_health(timeout_s) or {}


def _capture_flight_records(src, timeout_s: float, ctx: dict):
    return src.flight_records(timeout_s) or {}


def _capture_serve(src, timeout_s: float, ctx: dict):
    from ..state import api as state_api
    rows = ctx.get("metrics_rows")
    if rows is None:    # metrics section failed: one fallback fetch
        rows = state_api.shape_metrics(src.state_query("metrics") or {})
    return state_api.serve_health_from_rows(rows)


def _capture_serve_requests(src, timeout_s: float, ctx: dict):
    return src.serve_requests(200) or []


def _capture_reconstruct_stats(src, timeout_s: float, ctx: dict):
    return src.state_query("reconstruct_stats") or {}


_CAPTURERS = {
    "config": _capture_config,
    "nodes": _capture_nodes,
    "resources": _capture_resources,
    "tasks": _capture_tasks,
    "actors": _capture_actors,
    "objects": _capture_objects,
    "memory": _capture_memory,
    "jobs": _capture_jobs,
    "placement_groups": _capture_placement_groups,
    "events": _capture_events,
    "lifecycle": _capture_lifecycle,
    "spans": _capture_spans,
    "metrics": _capture_metrics,
    "metrics_history": _capture_metrics_history,
    "stacks": _capture_stacks,
    "collectives": _capture_collectives,
    "flight_records": _capture_flight_records,
    "serve": _capture_serve,
    "serve_requests": _capture_serve_requests,
    "reconstruct_stats": _capture_reconstruct_stats,
}


# --------------------------------------------------------------- capture

def capture(path: str, source, reason: str = "manual",
            timeout_s: float = 2.0,
            fields: Optional[dict] = None) -> str:
    """Write one post-mortem bundle to ``path`` (a ``.tar.gz``). Every
    section is captured best-effort — a half-dead cluster yields a
    bundle with per-section error markers, never no bundle — and the
    manifest (sorted keys, sections in registry order) makes the
    schema byte-deterministic for the golden pin."""
    created = time.time()
    sections: List[dict] = []
    blobs: Dict[str, bytes] = {}
    ctx: Dict[str, Any] = {}     # shared between sections: the serve
    for name in BUNDLE_SECTIONS:     # shaper reuses the metrics fetch
        try:
            payload = _CAPTURERS[name](source, timeout_s, ctx)
            ok = True
        except Exception as e:   # noqa: BLE001 — capture is best-effort
            payload = {"capture_error": str(e)}
            ok = False
        blob = json.dumps(payload, default=str, sort_keys=True).encode()
        blobs[name] = blob
        sections.append({"name": name, "file": f"{name}.json",
                         "ok": ok, "bytes": len(blob)})
    manifest = {
        "kind": BUNDLE_KIND,
        "format_version": BUNDLE_FORMAT_VERSION,
        "reason": reason,
        "created_ts": created,
        "source": getattr(source, "kind", "unknown"),
        "sections": sections,
        **({"fields": fields} if fields else {}),
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with tarfile.open(tmp, "w:gz") as tar:
        _add_member(tar, "manifest.json",
                    json.dumps(manifest, default=str,
                               sort_keys=True).encode(), created)
        for name in BUNDLE_SECTIONS:
            _add_member(tar, f"{name}.json", blobs[name], created)
    os.replace(tmp, path)
    telemetry.counter_inc(M_BUNDLES, 1.0, (("reason", reason),))
    try:
        source.emit_event({
            "message": f"debug bundle captured ({reason}): {path}",
            "path": path, "reason": reason,
            "sections_ok": sum(1 for s in sections if s["ok"]),
            "sections": len(sections),
        })
    except Exception:   # noqa: BLE001 — the bundle is already on disk
        pass
    return path


def _add_member(tar: tarfile.TarFile, name: str, blob: bytes,
                mtime: float) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(blob)
    info.mtime = int(mtime)
    tar.addfile(info, io.BytesIO(blob))


_auto_captured: set = set()
_auto_lock = locksan.lock("debug.bundle")


def default_bundle_dir() -> str:
    if CONFIG.debug_bundle_dir:
        return CONFIG.debug_bundle_dir
    try:
        from .. import _session_dir as session
        if session:
            return session
    except Exception:   # noqa: BLE001 — early startup
        pass
    return tempfile.gettempdir()


def auto_capture(reason: str, node=None, fields: Optional[dict] = None,
                 background: bool = False) -> Optional[str]:
    """Terminal-failure hook: capture one bundle per (process, reason)
    when ``debug_bundle_on_failure`` is on. Uses the given node's own
    surfaces, else the process's connected client. Never raises; with
    ``background=True`` the capture runs on a daemon thread (the
    OOM-kill path must not stall the node tick) and the chosen path is
    returned immediately."""
    if not CONFIG.debug_bundle_on_failure:
        return None
    with _auto_lock:
        if reason in _auto_captured:
            return None
        _auto_captured.add(reason)
    source = None
    if node is not None:
        source = NodeSource(node)
    else:
        from . import context as _ctx
        client = _ctx.current_client
        if client is None or client._closed.is_set():
            return None
        source = ClientSource(client)
    path = os.path.join(
        default_bundle_dir(),
        f"rtpt_bundle_{reason}_{os.getpid()}_{int(time.time())}.tar.gz")

    def run() -> Optional[str]:
        try:
            capture(path, source, reason=reason, fields=fields)
            print(f"[rtpu] post-mortem debug bundle captured ({reason}): "
                  f"{path} — inspect with `rtpu autopsy {path}`",
                  file=sys.stderr)
            return path
        except Exception as e:   # noqa: BLE001 — must not mask the
            print(f"[rtpu] debug bundle capture failed ({reason}): {e}",
                  file=sys.stderr)          # original failure
            return None

    if background:
        threading.Thread(target=run, daemon=True,
                         name="rtpu-debug-bundle").start()
        return path
    return run()


# ------------------------------------------------------------------ load

def load(path: str) -> Dict[str, Any]:
    """Read a bundle back: ``{"manifest": {...}, "<section>": payload}``.
    Verifies the kind/format version so an autopsy of the wrong tar
    fails with a clear error instead of nonsense."""
    out: Dict[str, Any] = {}
    with tarfile.open(path, "r:*") as tar:
        for member in tar.getmembers():
            if not member.name.endswith(".json"):
                continue
            f = tar.extractfile(member)
            if f is None:
                continue
            try:
                payload = json.loads(f.read().decode())
            except ValueError:
                continue
            out[member.name[:-len(".json")]] = payload
    manifest = out.get("manifest") or {}
    if manifest.get("kind") != BUNDLE_KIND:
        raise ValueError(f"{path} is not a {BUNDLE_KIND} "
                         "(missing/foreign manifest)")
    if manifest.get("format_version", 0) > BUNDLE_FORMAT_VERSION:
        raise ValueError(
            f"bundle format v{manifest.get('format_version')} is newer "
            f"than this build understands (v{BUNDLE_FORMAT_VERSION})")
    return out


# --------------------------------------------------------------- autopsy

def build_autopsy(bundle: Dict[str, Any],
                  trend_window: Optional[float] = None) -> Dict[str, Any]:
    """Rebuild the investigable surfaces from a loaded bundle — the
    doctor report (with trends), serve health (+trend), the collective
    verdicts, and the memory rollup — through the SAME pure builders
    the live CLI uses. No cluster is consulted."""
    from . import history as history_mod
    from ..state import api as state_api

    mem = bundle.get("memory") or {}
    hist_dump = bundle.get("metrics_history") or {}
    window = trend_window or state_api._DOCTOR_TREND_WINDOW_S
    hist_q = history_mod.query_dump(hist_dump, window=window)
    data = {
        "nodes": bundle.get("nodes") or [],
        "resources": bundle.get("resources") or {},
        "tasks": bundle.get("tasks") or [],
        "actors": bundle.get("actors") or [],
        "events": (bundle.get("events") or {}).get("rows") or [],
        "collectives": bundle.get("collectives") or {},
        "memory": {"objects": mem.get("objects") or [],
                   "leaks": mem.get("leaks") or []},
        "metrics": bundle.get("metrics") or [],
        "history": hist_q,
    }
    doctor = state_api.build_health_report(data)
    serve = bundle.get("serve") or state_api.serve_health_from_rows(
        data["metrics"])
    serve["trend"] = state_api.shape_serve_trends(hist_q)
    memory_summary = state_api.summarize_memory_rows(
        mem.get("objects") or [])
    memory_summary["leaks"] = mem.get("leaks") or []
    memory_summary["stores"] = mem.get("stores") or {}
    manifest = bundle.get("manifest") or {}
    return {
        "manifest": manifest,
        # what killed the session, verbatim from the capture site (the
        # dead-rank verdict of an exhausted reform, the OOM victim):
        # the collective op itself is already retired by capture time,
        # so the trigger carries the verdict the survivors saw
        "trigger": {"reason": manifest.get("reason"),
                    **(manifest.get("fields") or {})},
        "doctor": doctor,
        "trends": doctor.get("trends") or [],
        "serve": serve,
        "collectives": bundle.get("collectives") or {},
        "flight_records": bundle.get("flight_records") or {},
        "memory": memory_summary,
        "history": hist_q,
        "events_stats": (bundle.get("events") or {}).get("stats") or {},
    }
