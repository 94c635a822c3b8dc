"""rtpt CLI — cluster inspection & ops for ``ray_tpu_torch``.

Reference: ``python/ray/scripts/scripts.py`` (``ray status`` :1963,
``ray memory``, ``ray timeline``, ``ray list ...`` via the state CLI,
``experimental/state/state_cli.py``). argparse instead of click (no
extra deps); attaches to a live session by connecting a driver client
to its node unix socket (default: the most recent ``rtpt_session_*`` in
the temporary directory).

Usage:
    python -m ray_tpu_torch.scripts.cli status
    python -m ray_tpu_torch.scripts.cli list tasks|actors|objects|pgs|nodes|workers
    python -m ray_tpu_torch.scripts.cli summary tasks|actors
    python -m ray_tpu_torch.scripts.cli memory
    python -m ray_tpu_torch.scripts.cli timeline -o trace.json
    python -m ray_tpu_torch.scripts.cli start --head --num-gpus 0
    python -m ray_tpu_torch.scripts.cli submit --address HOST:PORT -- cmd
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
from typing import Optional


def _find_session(session: Optional[str]) -> str:
    if session:
        return session
    candidates = sorted(glob.glob(os.path.join(tempfile.gettempdir(),
                                               "rtpt_session_*")),
                        key=os.path.getmtime, reverse=True)
    for c in candidates:
        if glob.glob(os.path.join(c, "node_*.sock")):
            return c
    raise SystemExit("no live rtpt session found (pass --session)")


def _connect(session_dir: str):
    from .._private import context as ctx
    from .._private import protocol as P
    from .._private.client import CoreClient
    from .._private.ids import JobID, WorkerID

    socks = sorted(glob.glob(os.path.join(session_dir, "node_*.sock")))
    if not socks:
        raise SystemExit(f"no node socket in {session_dir}")
    conn = P.connect_unix(socks[0])
    client = CoreClient(conn, JobID.from_random(), WorkerID.from_random(),
                        P.KIND_DRIVER)
    conn.send((P.REGISTER, (P.KIND_DRIVER, client.worker_id.binary(),
                            os.getpid())))
    client.start_reader()
    ctx.current_client = client
    return client


def _print_table(rows, columns) -> None:
    if not rows:
        print("(empty)")
        return
    widths = [max(len(str(r.get(c, ""))) for r in rows + [{c: c}])
              for c in columns]
    header = "  ".join(c.ljust(w) for c, w in zip(columns, widths))
    print(header)
    print("-" * len(header))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(w)
                        for c, w in zip(columns, widths)))


def cmd_status(client, args) -> None:
    total = client.cluster_info("resources_total") or {}
    avail = client.cluster_info("resources_available") or {}
    nodes = client.cluster_info("nodes") or []
    alive = sum(1 for n in nodes if n.get("alive"))
    print(f"Nodes: {alive} alive / {len(nodes)} total")
    print("Resources:")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0.0):g} / {total[k]:g} available")


def cmd_list(client, args) -> None:
    from ..state import (list_actors, list_jobs, list_nodes, list_objects,
                         list_placement_groups, list_tasks, list_workers)
    what = args.what
    if what == "tasks":
        rows = list_tasks(limit=args.limit)
        cols = ["task_id", "name", "state", "is_actor_task"]
    elif what == "actors":
        rows = list_actors(limit=args.limit)
        cols = ["actor_id", "class_name", "name", "state", "num_restarts"]
    elif what == "objects":
        rows = list_objects(limit=args.limit)
        cols = ["object_id", "node_id", "size", "callsite", "creator"]
    elif what in ("pgs", "placement_groups"):
        rows = list_placement_groups(limit=args.limit)
        cols = ["pg_id", "strategy", "bundles"]
    elif what == "nodes":
        rows = [{**n, "node_id": n["node_id"].hex()
                 if hasattr(n["node_id"], "hex") else n["node_id"]}
                for n in list_nodes()]
        cols = ["node_id", "alive", "resources"]
    elif what == "workers":
        rows = list_workers()
        cols = ["worker_id", "pid", "state", "actor_id"]
    elif what == "jobs":
        rows = list_jobs()
        cols = ["job_id", "driver_pid", "start_time", "end_time"]
    else:
        raise SystemExit(f"unknown list target {what!r}")
    if args.format == "json":
        print(json.dumps(rows, default=str, indent=2))
    else:
        _print_table(rows, cols)


def cmd_summary(client, args) -> None:
    from ..state import summarize_actors, summarize_tasks
    summary = (summarize_tasks() if args.what == "tasks"
               else summarize_actors())
    print(json.dumps(summary, indent=2, default=str))


def cmd_metrics(client, args) -> None:
    """Cluster-wide runtime metrics: Prometheus text (default) or the
    per-metric summary rollup."""
    if args.format == "summary":
        from ..state import summarize_metrics
        print(json.dumps(summarize_metrics(), indent=2, default=str))
    else:
        from ..util.metrics import export_prometheus
        print(export_prometheus(), end="")


def _fmt_bytes(n) -> str:
    if n is None:
        return "?"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def _fmt_ref_types(rt: dict) -> str:
    return ",".join(f"{k}:{v}" for k, v in sorted((rt or {}).items())) \
        or "-"


def cmd_memory(client, args) -> None:
    """Object ownership & memory introspection (reference: ``ray
    memory``): grouped byte totals by creation callsite / creator /
    node, per-object rows with ref types, leak findings, and per-node
    store stats."""
    from ..state import list_objects, memory_summary
    summary = memory_summary(group_by=args.group_by, top_k=args.limit,
                             sort_by=args.sort_by)
    objects = None
    if args.objects:
        objects = list_objects(limit=10**9)
        objects.sort(key=lambda r: -(r.get("size") or 0))
        objects = objects[:args.limit]
    if args.format == "json":
        if objects is not None:
            summary = {**summary, "objects": objects}
        print(json.dumps(summary, default=str, indent=2))
        return
    _render_memory_summary(summary, args.group_by, args.limit,
                           args.sort_by)
    if objects is not None:
        print("\nObjects (largest first):")
        _print_table(
            [{**o, "size": _fmt_bytes(o.get("size")),
              "ref_types": _fmt_ref_types(o.get("ref_types"))}
             for o in objects],
            ["object_id", "size", "callsite", "creator", "ref_types",
             "pinned_in_store", "spilled"])
    _render_memory_leaks(summary)


def _render_memory_summary(summary, group_by, limit, sort_by) -> None:
    """Memory rollup renderer — live (`rtpt memory`) or from a bundle
    (`rtpt autopsy`)."""
    print(f"{summary['total_objects']} tracked object(s), "
          f"{_fmt_bytes(summary['total_bytes'])} cluster-wide")
    for node_hex, st in sorted((summary.get("stores") or {}).items()):
        print(f"  store {node_hex[:12]}: "
              f"{_fmt_bytes(st.get('used_bytes'))} / "
              f"{_fmt_bytes(st.get('capacity_bytes'))} used, "
              f"{st.get('num_objects', 0)} object(s), "
              f"{st.get('num_spilled', 0)} spilled")
    order = ("most objects" if sort_by == "count" else "most bytes")
    print(f"\nBy {group_by} (top {limit}, {order} first):")
    _print_table(
        [{group_by: g["key"], "objects": g["objects"],
          "bytes": _fmt_bytes(g["bytes"]),
          "ref_types": _fmt_ref_types(g["ref_types"])}
         for g in summary["groups"]],
        [group_by, "objects", "bytes", "ref_types"])
    if summary.get("dropped_groups"):
        print(f"  (+{summary['dropped_groups']} more group(s); raise "
              "--limit)")


def _render_memory_leaks(summary) -> None:
    for leak in summary.get("leaks") or []:
        print(f"  ! LEAK [{leak.get('cause')}] object "
              f"{str(leak.get('object_id'))[:12]} "
              f"size={_fmt_bytes(leak.get('size'))} "
              f"callsite={leak.get('callsite')}")


def cmd_timeline(client, args) -> None:
    from ..state import timeline
    out = args.output or os.path.join(tempfile.gettempdir(),
                                      "rtpt_timeline.json")
    timeline(out)
    print(f"wrote {out} (open in chrome://tracing or ui.perfetto.dev)")


def cmd_stack(client, args) -> None:
    """Cluster-wide thread dump (reference: ``ray stack``): every
    node/worker/driver process, deduplicated by identical stacks."""
    from ..state import cluster_stacks
    result = cluster_stacks(timeout_s=args.timeout)
    if args.format == "json":
        print(json.dumps(result, default=str, indent=2))
        return
    groups = result.get("groups") or []
    n_procs = sum(len(d) for d in (result.get("nodes") or {}).values())
    print(f"{n_procs} process(es) on {len(result.get('nodes') or {})} "
          f"node(s), {len(groups)} distinct stack(s)\n")
    for g in groups:
        where = ", ".join(
            f"{t.get('kind')}:{str(t.get('worker_id') or t.get('node'))[:8]}"
            f"/{t.get('thread')}" for t in g["threads"][:6])
        more = len(g["threads"]) - 6
        if more > 0:
            where += f", +{more} more"
        print(f"=== {g['count']} thread(s): {where}")
        for fr in g["frames"]:
            print(f"    {fr}")
        print()


def cmd_profile(client, args) -> None:
    """Cluster-wide sampling wall-clock profiler; prints the hottest
    collapsed stacks and optionally writes flamegraph / Chrome files."""
    from .._private import debugging
    from ..state import profile
    report = profile(duration_s=args.duration,
                     interval_ms=args.interval_ms,
                     task_filter=args.task_filter,
                     collapsed_file=args.output,
                     chrome_trace_file=args.chrome)
    collapsed = report.get("collapsed") or {}
    if args.format == "json":
        print(json.dumps(report, default=str, indent=2))
        return
    print(f"sampled {report.get('num_samples', 0)} ticks over "
          f"{report.get('duration_s')}s; {len(collapsed)} distinct "
          "stack(s)\n")
    for count, frames in debugging.top_stacks(collapsed, n=args.top):
        print(f"--- {count} sample(s):")
        for fr in frames:
            print(f"    {fr}")
        print()
    if args.output:
        print(f"wrote collapsed stacks to {args.output} "
              "(feed to flamegraph.pl / speedscope)")
    if args.chrome:
        print(f"wrote Chrome trace to {args.chrome}")


def cmd_coll_debug(client, args) -> None:
    """Collective flight-recorder surface: in-flight op watermarks
    across every rank, hang verdicts (dead rank / lost chunk / lagging
    rank), and optionally the raw recent event ring per process."""
    from ..state import collective_health, flight_records
    report = collective_health(timeout_s=args.timeout)
    records = flight_records(args.timeout) if args.records else None
    if args.format == "json":
        if records is not None:
            report = {**report, "records": records}
        print(json.dumps(report, default=str, indent=2))
        return
    _render_coll(report)
    if records is not None:
        _render_coll_records(records, args.limit)


def _render_coll(report) -> None:
    """Collective-health renderer — live or from a bundle."""
    ops = report.get("ops") or []
    verdicts = report.get("verdicts") or []
    print(f"{report.get('processes', 0)} process(es) replied, "
          f"{len(ops)} collective op(s) observed, "
          f"{len(verdicts)} stuck")
    for op in ops:
        state = "STUCK" if op.get("stuck_ranks") else "done"
        print(f"\n=== {op.get('op')} group={op.get('group')} "
              f"seq={op.get('seq')} algo={op.get('algo')} "
              f"nbytes={op.get('nbytes')} [{state}] "
              f"({len(op.get('done_ranks') or [])}/{op.get('world')} "
              "ranks finished)")
        for rank, mark in sorted((op.get("stuck_ranks") or {}).items()):
            print(f"    rank {rank}: {mark}")
    for v in verdicts:
        print(f"\n!!! [{v.get('verdict')}] {v.get('message')}")
        for fr in v.get("stack") or []:
            print(f"        {fr}")


def _render_coll_records(recs, limit: int) -> None:
    for node_hex, snaps in sorted((recs.get("nodes") or {}).items()):
        for snap in snaps or []:
            recent = snap.get("recent") or []
            if not recent:
                continue
            print(f"\n--- {snap.get('kind')} "
                  f"{str(snap.get('worker_id'))[:12]} on "
                  f"{node_hex}: last {len(recent)} event(s)")
            for ev in recent[-limit:]:
                print(f"    {ev.get('ts'):.6f} {str(ev.get('kind')):8s} "
                      f"{ev.get('key')} ({ev.get('info')})")


def cmd_serve_status(client, args) -> None:
    """Serving health plane: per-deployment latency/queue-wait
    percentiles (streaming digests), queue depth, error rate, replica
    table — the autoscaling signal tuple. ``--trend N`` adds head/tail
    movement over the trailing N seconds of retained history."""
    from ..state import serve_health
    health = serve_health(trend=args.trend)
    if args.format == "json":
        print(json.dumps(health, default=str, indent=2))
        return
    _render_serve(health)


def _render_serve(health) -> None:
    """Serve table renderer — live or from a bundle (`rtpt autopsy`)."""
    deps = health.get("deployments") or {}
    if not deps:
        print("no serve deployments observed")
        return

    def ms(d, q):
        v = (d or {}).get(q)
        return f"{v * 1000:.1f}ms" if v is not None else "-"

    rows = []
    for name in sorted(deps):
        d = deps[name]
        rows.append({
            "deployment": name,
            "replicas": len(d.get("replicas") or []),
            "queue": f"{d.get('queue_depth', 0):g}",
            "reqs": f"{d.get('requests_total', 0):g}",
            "err_rate": f"{d.get('error_rate', 0.0):.1%}",
            "p50": ms(d.get("latency"), "p50"),
            "p95": ms(d.get("latency"), "p95"),
            "p99": ms(d.get("latency"), "p99"),
            "qwait_p99": ms(d.get("queue_wait"), "p99"),
            "batch_p50": (f"{(d.get('batch_size') or {}).get('p50', 0):.1f}"
                          if d.get("batch_size") else "-"),
        })
    _print_table(rows, ["deployment", "replicas", "queue", "reqs",
                        "err_rate", "p50", "p95", "p99", "qwait_p99",
                        "batch_p50"])
    for name, tr in sorted((health.get("trend") or {}).items()):
        parts = []
        for field in ("queue_depth", "latency_p95", "queue_wait_p95",
                      "request_rate"):
            p = tr.get(field)
            if p:
                ratio = (f" ({p['ratio']}x)"
                         if p.get("ratio") is not None else "")
                parts.append(f"{field} {p['head']:g}->{p['tail']:g}"
                             f"{ratio}")
        if parts:
            print(f"  trend[{tr.get('window_s')}s] {name}: "
                  + ", ".join(parts))
    if health.get("worst"):
        print(f"\nworst deployment: {health['worst']}")


def cmd_requests(client, args) -> None:
    """Recent serve access-log rows gathered from every replica's ring
    (request_id, deployment, route, status, latency, queue wait)."""
    from ..state import serve_requests
    rows = serve_requests(limit=args.limit, slow=args.slow,
                          errors=args.errors)
    if args.format == "json":
        print(json.dumps(rows, default=str, indent=2))
        return
    if not rows:
        print("no request rows (serve idle, or request_log_capacity=0)")
        return
    _print_table(
        [{**r,
          "latency": f"{r.get('latency_s', 0) * 1000:.1f}ms",
          "queue_wait": f"{r.get('queue_wait_s', 0) * 1000:.1f}ms",
          "batch": r.get("batch_size") or "-",
          "error": (str(r.get("error"))[:40] if r.get("error") else "")}
         for r in rows],
        ["request_id", "deployment", "replica", "route", "proto",
         "status", "latency", "queue_wait", "batch", "error"])


def cmd_doctor(client, args) -> None:
    """Correlated cluster health report: nodes, resources, task/actor
    rollups, stall diagnoses, trend movements, recent alerts,
    telemetry highlights."""
    from ..state import health_report
    rep = health_report()
    if args.format == "json":
        print(json.dumps(rep, default=str, indent=2))
        return
    _render_doctor(rep)


def _render_doctor(rep) -> None:
    """Text renderer of one doctor report — live (`rtpt doctor`) or
    replayed from a bundle (`rtpt autopsy`)."""
    verdict = "HEALTHY" if rep["healthy"] else "UNHEALTHY"
    print(f"cluster: {verdict}")
    for p in rep["problems"]:
        print(f"  ! {p}")
    nodes = rep["nodes"]
    print(f"nodes: {nodes['alive']} alive, {nodes['dead']} dead")
    res = rep["resources"]
    for k in sorted(res["total"]):
        print(f"  {k}: {res['available'].get(k, 0.0):g} / "
              f"{res['total'][k]:g} available")
    print(f"tasks: {json.dumps(rep['tasks'].get('by_state', {}))}")
    print(f"actors: {json.dumps(rep['actors'].get('by_state', {}))}")
    if rep["metrics"]:
        print(f"telemetry: {json.dumps(rep['metrics'])}")
    for t in rep.get("trends") or []:
        ratio = (f"{t['ratio']}x " if t.get("ratio") else "")
        print(f"  TREND [{t.get('kind')}] {ratio}{t.get('message')}")
    for ev in rep["stalls"]:
        print(f"  STALL [{ev.get('cause')}] {ev.get('message')}")
    for v in (rep.get("collectives") or {}).get("verdicts", []):
        print(f"  COLLECTIVE [{v.get('verdict')}] {v.get('message')}")
    srv = rep.get("serve") or {}
    if srv.get("deployments"):
        worst = srv.get("worst")
        wd = (srv["deployments"].get(worst) or {}) if worst else {}
        lat = wd.get("latency") or {}
        print(f"serve: {len(srv['deployments'])} deployment(s); "
              f"worst: {worst} "
              f"(err_rate={wd.get('error_rate', 0.0):.1%}, "
              f"p99={(lat.get('p99') or 0.0) * 1000:.1f}ms)")
    rec = rep.get("recovery") or {}
    if any((rec.get("collective_reforms"), rec.get("actor_restores"),
            rec.get("actor_checkpoints"),
            rec.get("exhausted_restart_budgets"))):
        print("recovery: "
              f"{rec.get('collective_reforms', 0):g} group reform(s), "
              f"{rec.get('actor_checkpoints', 0):g} checkpoint(s), "
              f"{rec.get('actor_restores', 0):g} actor restore(s)")
        for ev in rec.get("recent_reforms", []):
            print(f"  REFORM {ev.get('message')}")
        for a in rec.get("exhausted_restart_budgets", []):
            print(f"  ! actor {str(a.get('actor_id'))[:12]} "
                  f"({a.get('class_name')}) dead after "
                  f"{a.get('num_restarts')} restart(s) — budget "
                  "exhausted")
    for ev in rep["alerts"]:
        print(f"  {ev.get('severity')} [{ev.get('label')}] "
              f"{ev.get('message')}")


def _parse_when(spec, now: float):
    """``--since/--until`` forms: epoch seconds (float), or relative
    ``30s``/``5m``/``2h`` meaning that long before now."""
    if spec is None:
        return None
    s = str(spec).strip()
    try:
        mult = {"s": 1.0, "m": 60.0, "h": 3600.0}.get(s[-1:])
        if mult is not None:
            return now - float(s[:-1]) * mult
        return float(s)
    except ValueError:
        raise SystemExit(f"bad time spec {spec!r} (epoch seconds, or "
                         "relative like 120s / 5m / 1h)")


def cmd_events(client, args) -> None:
    """Structured cluster events with time-window filtering
    (``--since/--until``); the ring's eviction counter says whether
    older rows were lost to retention."""
    import time as _time

    from ..state import events_stats, list_events
    now = _time.time()
    filters = {}
    if args.label:
        filters["label"] = args.label
    if args.severity:
        filters["severity"] = args.severity
    rows = list_events(filters or None, limit=args.limit,
                       since=_parse_when(args.since, now),
                       until=_parse_when(args.until, now))
    if args.format == "json":
        print(json.dumps(rows, default=str, indent=2))
        return
    for r in rows:
        ts = _time.strftime("%H:%M:%S",
                            _time.localtime(r.get("timestamp") or 0))
        print(f"{ts} {r.get('severity', '?'):7s} "
              f"[{r.get('label')}] {r.get('message')}")
    stats = events_stats()
    if stats.get("evicted"):
        print(f"({stats['evicted']} older event(s) evicted from the "
              f"{stats.get('capacity')}-slot ring — see "
              "rtpu_events_evicted_total)")


def cmd_history(client, args) -> None:
    """Windowed metric time series from the retention ring
    (``state.metrics_history``): aligned points per series, with
    rate/delta shaping for counters."""
    from ..state import metrics_history
    res = metrics_history(name=args.metric, window=args.window,
                          step=args.step, shape=args.shape)
    if args.format == "json":
        print(json.dumps(res, default=str, indent=2))
        return
    series = res.get("series") or []
    print(f"{len(series)} series, step {res.get('step_s')}s, "
          f"window {res.get('window_s')}s")
    for s in series[:args.limit]:
        tags = ",".join(f"{k}={v}" for k, v in sorted(s["tags"].items()))
        pts = s["points"]
        shown = pts[-8:]

        def fmt(v):
            if isinstance(v, dict):
                return (f"p95={v.get('p95'):.4g}" if "p95" in v
                        else str(v))
            return f"{v:.6g}"

        print(f"  {s['name']}{{{tags}}} [{s['kind']}"
              + (f", {s.get('shape')}" if s.get("shape") else "")
              + f"] {len(pts)} pt(s): "
              + " ".join(fmt(v) for _ts, v in shown))


def cmd_debug_bundle(client, args) -> None:
    """Capture a black-box post-mortem bundle of everything the session
    knows (metrics history, events, stacks, flight recorder, access
    logs, spans, memory ledger, config) into one portable tar."""
    import time as _time

    from .._private import debug_bundle
    out = args.output or os.path.abspath(
        f"rtpt_bundle_manual_{int(_time.time())}.tar.gz")
    path = debug_bundle.capture(out, debug_bundle.ClientSource(client),
                                reason="manual",
                                timeout_s=args.timeout)
    print(f"wrote {path} (inspect with `rtpt autopsy {path}`)")


def cmd_autopsy(args) -> None:
    """Offline post-mortem: replay a captured bundle through the
    doctor/serve/coll-debug/memory surfaces with NO live cluster."""
    from .._private import debug_bundle
    bundle = debug_bundle.load(args.bundle)
    rep = debug_bundle.build_autopsy(bundle,
                                     trend_window=args.trend)
    if args.format == "json":
        print(json.dumps(rep, default=str, indent=2))
        return
    man = rep["manifest"]
    import time as _time
    created = _time.strftime("%Y-%m-%d %H:%M:%S", _time.localtime(
        man.get("created_ts") or 0))
    print(f"bundle: {args.bundle}")
    print(f"  captured {created} (reason: {man.get('reason')}, "
          f"format v{man.get('format_version')}, "
          f"{len(man.get('sections') or [])} section(s))")
    bad = [s["name"] for s in man.get("sections") or []
           if not s.get("ok")]
    if bad:
        print(f"  ! sections that failed capture: {', '.join(bad)}")
    trigger = rep.get("trigger") or {}
    extra = {k: v for k, v in trigger.items() if k != "reason"}
    if extra:
        print("  trigger: " + ", ".join(f"{k}={v}"
                                        for k, v in sorted(extra.items())))
    print("\n== doctor (replayed offline) ==")
    _render_doctor(rep["doctor"])
    coll = rep.get("collectives") or {}
    if coll.get("ops") or coll.get("verdicts"):
        print("\n== collectives ==")
        _render_coll(coll)
    serve = rep.get("serve") or {}
    if serve.get("deployments"):
        print("\n== serve ==")
        _render_serve(serve)
    mem = rep.get("memory") or {}
    if mem.get("total_objects"):
        print("\n== memory ==")
        _render_memory_summary(mem, mem.get("group_by", "callsite"),
                               20, mem.get("sort_by", "bytes"))
        _render_memory_leaks(mem)
    stats = rep.get("events_stats") or {}
    if stats.get("evicted"):
        print(f"\n({stats['evicted']} event(s) had already been evicted "
              "from the ring before capture)")


# the port's own pid file: `rtpu stop` and `rtpt stop` never signal each
# other's node
_DEFAULT_PID_FILE = os.path.join(tempfile.gettempdir(), "rtpt_node.pid")


def cmd_start(args) -> None:
    """Start a node process: ``rtpt start --head [--gcs-port N]`` or
    ``rtpt start --address HOST:PORT`` (reference: ``ray start``,
    ``python/ray/scripts/scripts.py``). Runs in the foreground unless
    --daemon; kill with SIGTERM / ``rtpt stop``. ``--num-gpus`` (or
    ``--num-tpus``) sets the node's GPU slots; without it the node
    counts the cards its process sees."""
    import subprocess

    from .._private import main as node_main

    fwd = []
    if args.head:
        fwd += ["--head", "--gcs-port", str(args.gcs_port)]
    else:
        fwd += ["--address", args.address]
    fwd += ["--node-port", str(args.node_port),
            "--advertise-host", args.advertise_host]
    if args.num_cpus is not None:
        fwd += ["--num-cpus", str(args.num_cpus)]
    if args.num_gpus is not None:
        fwd += ["--num-gpus", str(args.num_gpus)]
    if args.resources:
        fwd += ["--resources", args.resources]
    if args.daemon:
        pid_file = args.pid_file or _DEFAULT_PID_FILE
        proc = subprocess.Popen([sys.executable, "-m",
                                 "ray_tpu_torch._private.main"] + fwd,
                                start_new_session=True)
        with open(pid_file, "w") as f:
            f.write(str(proc.pid))
        print(f"node started pid={proc.pid} (pid file {pid_file})")
        return
    raise SystemExit(node_main.main(fwd))


def cmd_stop(args) -> None:
    import signal

    pid_file = args.pid_file or _DEFAULT_PID_FILE
    try:
        with open(pid_file) as f:
            pid = int(f.read().strip())
    except OSError:
        raise SystemExit(f"no pid file at {pid_file}")
    try:
        os.kill(pid, signal.SIGTERM)
        print(f"sent SIGTERM to {pid}")
    except ProcessLookupError:
        print(f"process {pid} already gone")
    os.unlink(pid_file)


def _job_client(args):
    from ..job.client import JobSubmissionClient
    address = getattr(args, "job_address", None)
    if not address and getattr(args, "address", None):
        # resolve the REST endpoint through the cluster's GCS
        from .._private.gcs_service import RemoteControlPlane
        gcs = RemoteControlPlane(args.address)
        try:
            raw = gcs.kv_get(b"__rtpu_job_api")
        finally:
            gcs.close()
        if raw is None:
            raise SystemExit("cluster has no job API (head not started "
                             "with a job server?)")
        address = raw.decode()
    if not address:
        raise SystemExit("pass --address (cluster GCS) or --job-address")
    return JobSubmissionClient(address)


def cmd_submit(args) -> None:
    client = _job_client(args)
    runtime_env = {}
    if args.working_dir:
        runtime_env["working_dir"] = args.working_dir
    if args.env:
        runtime_env["env_vars"] = dict(kv.split("=", 1) for kv in args.env)
    job_id = client.submit_job(
        entrypoint=" ".join(args.entrypoint),
        runtime_env=runtime_env or None,
        submission_id=args.submission_id)
    print(f"submitted {job_id}")
    if args.no_wait:
        return
    rec = client.wait_until_finished(job_id, timeout=args.timeout)
    sys.stdout.write(client.get_job_logs(job_id))
    print(f"job {job_id} {rec['status']} (rc={rec.get('return_code')})")
    if rec["status"] != "SUCCEEDED":
        raise SystemExit(1)


def cmd_job(args) -> None:
    client = _job_client(args)
    if args.job_command == "status":
        print(json.dumps(client.get_job_status(args.job_id), indent=2))
    elif args.job_command == "logs":
        sys.stdout.write(client.get_job_logs(args.job_id))
    elif args.job_command == "stop":
        print(json.dumps({"stopped": client.stop_job(args.job_id)}))
    elif args.job_command == "list":
        _print_table(client.list_jobs(),
                     ["job_id", "status", "entrypoint", "return_code"])


def cmd_lint(args) -> None:
    """Run the repo's static lints: the observability-registry lint
    (check_metrics) and the concurrency lint (check_concurrency) —
    the same pair tier-1 gates on."""
    from . import check_concurrency, check_metrics
    an = check_concurrency.analyze()   # one package analysis, reused
    rc = 0
    for name, problems in (
            ("metric-lint", check_metrics.check()),
            ("concurrency-lint", check_concurrency.check(an=an))):
        for p in problems:
            print(f"{name}: {p}", file=sys.stderr)
        if problems:
            print(f"{name}: {len(problems)} problem(s)", file=sys.stderr)
            rc = 1
        else:
            print(f"{name}: ok")
    for kind, rel, lineno, reason in check_concurrency.waiver_report(
            an=an):
        print(f"concurrency-lint: waiver {kind} at {rel}:{lineno}: "
              f"{reason}")
    raise SystemExit(rc)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="rtpt",
                                     description="ray_tpu_torch cluster CLI")
    parser.add_argument("--session", help="session dir (default: latest)")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("status")
    sub.add_parser(
        "lint", help="static lints: metric registry + concurrency/lock-order")
    p_list = sub.add_parser("list")
    p_list.add_argument("what")
    p_list.add_argument("--limit", type=int, default=100)
    p_list.add_argument("--format", choices=("table", "json"),
                        default="table")
    p_sum = sub.add_parser("summary")
    p_sum.add_argument("what", choices=("tasks", "actors"))
    p_met = sub.add_parser("metrics",
                           help="runtime metrics (Prometheus or summary)")
    p_met.add_argument("--format", choices=("prom", "summary"),
                       default="prom")
    p_mem = sub.add_parser("memory",
                           help="object ownership & memory "
                           "introspection (ray memory)")
    p_mem.add_argument("--group-by",
                       choices=("callsite", "creator", "node"),
                       default="callsite")
    p_mem.add_argument("--sort-by", choices=("bytes", "count"),
                       default="bytes",
                       help="group ordering: byte total or object count")
    p_mem.add_argument("--objects", action="store_true",
                       help="also print per-object rows")
    p_mem.add_argument("--limit", type=int, default=20)
    p_mem.add_argument("--format", choices=("table", "json"),
                       default="table")
    p_tl = sub.add_parser("timeline")
    p_tl.add_argument("-o", "--output")
    p_stack = sub.add_parser("stack",
                             help="cluster-wide thread dump (ray stack)")
    p_stack.add_argument("--timeout", type=float, default=5.0)
    p_stack.add_argument("--format", choices=("text", "json"),
                         default="text")
    p_prof = sub.add_parser("profile",
                            help="sampling wall-clock profiler across "
                            "all workers")
    p_prof.add_argument("--duration", type=float, default=5.0)
    p_prof.add_argument("--interval-ms", type=float, default=None)
    p_prof.add_argument("--task-filter", default=None,
                        help="only sample while a task whose name "
                        "contains this substring is running")
    p_prof.add_argument("--top", type=int, default=10)
    p_prof.add_argument("-o", "--output", default=None,
                        help="write flamegraph collapsed stacks here")
    p_prof.add_argument("--chrome", default=None,
                        help="write a Chrome trace JSON here")
    p_prof.add_argument("--format", choices=("text", "json"),
                        default="text")
    p_doc = sub.add_parser("doctor",
                           help="correlated cluster health report")
    p_doc.add_argument("--format", choices=("text", "json"),
                       default="text")
    p_coll = sub.add_parser("coll-debug",
                            help="collective flight recorder: watermark"
                            " diff + hang/straggler verdicts")
    p_coll.add_argument("--timeout", type=float, default=3.0)
    p_coll.add_argument("--records", action="store_true",
                        help="also dump each process's recent "
                        "flight-recorder event ring")
    p_coll.add_argument("--limit", type=int, default=40,
                        help="ring events shown per process with "
                        "--records")
    p_coll.add_argument("--format", choices=("text", "json"),
                        default="text")

    p_srv = sub.add_parser("serve-status",
                           help="per-deployment serving health: "
                           "latency/queue percentiles, error rate, "
                           "replica table")
    p_srv.add_argument("--format", choices=("table", "json"),
                       default="table")
    p_srv.add_argument("--trend", type=float, default=None,
                       metavar="SECONDS",
                       help="attach head/tail movement over this "
                       "trailing history window")
    p_ev = sub.add_parser("events",
                          help="structured cluster events with "
                          "--since/--until time windows")
    p_ev.add_argument("--since", default=None,
                      help="epoch seconds or relative (120s / 5m / 1h)")
    p_ev.add_argument("--until", default=None,
                      help="epoch seconds or relative (120s / 5m / 1h)")
    p_ev.add_argument("--label", default=None)
    p_ev.add_argument("--severity", default=None,
                      choices=("DEBUG", "INFO", "WARNING", "ERROR"))
    p_ev.add_argument("--limit", type=int, default=100)
    p_ev.add_argument("--format", choices=("text", "json"),
                      default="text")
    p_hist = sub.add_parser("history",
                            help="windowed metric time series from the "
                            "retention ring (rate/delta shaping)")
    p_hist.add_argument("metric", nargs="?", default=None,
                        help="metric name (default: all retained)")
    p_hist.add_argument("--window", type=float, default=None,
                        help="trailing seconds (default: finest ring)")
    p_hist.add_argument("--step", type=float, default=None,
                        help="minimum seconds per point")
    p_hist.add_argument("--shape", choices=("value", "rate", "delta"),
                        default="value")
    p_hist.add_argument("--limit", type=int, default=40,
                        help="series shown (text format)")
    p_hist.add_argument("--format", choices=("text", "json"),
                        default="text")
    p_bundle = sub.add_parser("debug-bundle",
                              help="capture a black-box post-mortem "
                              "bundle (one portable tar)")
    p_bundle.add_argument("-o", "--output", default=None)
    p_bundle.add_argument("--timeout", type=float, default=2.0,
                          help="per-fan-out budget (stacks, "
                          "flight records)")
    p_autopsy = sub.add_parser("autopsy",
                               help="replay a captured bundle offline: "
                               "doctor/serve/coll-debug/memory with no "
                               "live cluster")
    p_autopsy.add_argument("bundle", help="path to a debug-bundle tar")
    p_autopsy.add_argument("--trend", type=float, default=None,
                           metavar="SECONDS",
                           help="trend window for the replayed doctor")
    p_autopsy.add_argument("--format", choices=("text", "json"),
                           default="text")
    p_req = sub.add_parser("requests",
                           help="recent serve access-log rows "
                           "(request ids, latency, queue wait)")
    p_req.add_argument("--slow", action="store_true",
                       help="only rows at/over the slow-request "
                       "threshold")
    p_req.add_argument("--errors", action="store_true",
                       help="only failed requests")
    p_req.add_argument("--limit", type=int, default=50)
    p_req.add_argument("--format", choices=("table", "json"),
                       default="table")

    p_start = sub.add_parser("start", help="start a cluster node process")
    p_start.add_argument("--head", action="store_true")
    p_start.add_argument("--address", default=None)
    p_start.add_argument("--gcs-port", type=int, default=6379)
    p_start.add_argument("--node-port", type=int, default=0)
    p_start.add_argument("--advertise-host", default="127.0.0.1",
                         help="address other hosts reach this node at "
                         "(set to this machine's network IP for "
                         "multi-host clusters)")
    p_start.add_argument("--num-cpus", type=float, default=None)
    p_start.add_argument("--num-gpus", "--num-tpus", dest="num_gpus",
                         type=float, default=None,
                         help="GPU slots (default: the cards the node's "
                         "process sees; --num-tpus means the same)")
    p_start.add_argument("--resources", default=None)
    p_start.add_argument("--daemon", action="store_true")
    p_start.add_argument("--pid-file", default=None)
    p_stop = sub.add_parser("stop", help="stop a daemonized node")
    p_stop.add_argument("--pid-file", default=None)

    p_sub = sub.add_parser("submit", help="submit a job to a cluster")
    p_sub.add_argument("--address", default=None,
                       help="cluster GCS host:port")
    p_sub.add_argument("--job-address", default=None,
                       help="job REST host:port (skips GCS lookup)")
    p_sub.add_argument("--working-dir", default=None)
    p_sub.add_argument("--env", action="append", default=[],
                       metavar="KEY=VALUE")
    p_sub.add_argument("--submission-id", default=None)
    p_sub.add_argument("--no-wait", action="store_true")
    p_sub.add_argument("--timeout", type=float, default=600.0)
    p_sub.add_argument("entrypoint", nargs=argparse.REMAINDER,
                       help="command to run (prefix with --)")

    p_job = sub.add_parser("job", help="job status/logs/stop/list")
    p_job.add_argument("job_command",
                       choices=("status", "logs", "stop", "list"))
    p_job.add_argument("job_id", nargs="?", default=None)
    p_job.add_argument("--address", default=None)
    p_job.add_argument("--job-address", default=None)
    p_job.set_defaults(needs_job_id=("status", "logs", "stop"))

    args = parser.parse_args(argv)
    if args.command == "lint":
        cmd_lint(args)
        return
    if args.command == "autopsy":
        # offline by design: reads only the bundle, never a session
        cmd_autopsy(args)
        return
    if args.command == "start":
        cmd_start(args)
        return
    if args.command == "stop":
        cmd_stop(args)
        return
    if args.command == "submit":
        if args.entrypoint and args.entrypoint[0] == "--":
            args.entrypoint = args.entrypoint[1:]
        if not args.entrypoint:
            raise SystemExit("no entrypoint given (rtpt submit ... -- cmd)")
        cmd_submit(args)
        return
    if args.command == "job":
        if args.job_command in args.needs_job_id and not args.job_id:
            raise SystemExit(f"rtpt job {args.job_command} needs a job id")
        cmd_job(args)
        return
    session = _find_session(args.session)
    client = _connect(session)
    try:
        {"status": cmd_status, "list": cmd_list, "summary": cmd_summary,
         "memory": cmd_memory, "timeline": cmd_timeline,
         "metrics": cmd_metrics, "stack": cmd_stack,
         "profile": cmd_profile, "doctor": cmd_doctor,
         "coll-debug": cmd_coll_debug,
         "serve-status": cmd_serve_status,
         "requests": cmd_requests,
         "events": cmd_events,
         "history": cmd_history,
         "debug-bundle": cmd_debug_bundle}[args.command](
             client, args)
    finally:
        try:
            client.close()
        except Exception:
            pass


if __name__ == "__main__":
    main()
