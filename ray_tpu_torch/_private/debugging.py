"""On-demand distributed debugging: thread dumps + sampling profiler.

Equivalent role to the reference's ``ray stack`` (``scripts.py`` shelling
out to py-spy over every worker pid) and its profiling hooks
(``_private/profiling.py``). Both capabilities here are pure-Python and
in-process: a worker/driver answers a ``STACK_DUMP`` frame with
``sys._current_frames()`` walked into faulthandler-style per-thread
traces, and a ``PROFILE_START`` frame starts a bounded background
sampler whose output is flamegraph-compatible collapsed stacks plus
per-thread leaf segments convertible to a Chrome trace. Collection fans
out over the existing node RPC plane (see ``node.collect_local_stacks``
/ ``node.cluster_stacks``); cross-node dedup lives in
``gcs.aggregate_stacks``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

# Runtime plumbing threads excluded from profiles by default: they sit
# in recv()/wait() and would drown task code in idle samples. Stack
# DUMPS always include them (a wedged flusher is exactly what a dump
# must show); only the sampler filters.
RUNTIME_THREADS = frozenset({
    "MainThread",               # worker main loop = socket reader
    "rtpu-client-reader",
    "rtpu-ref-flusher",
    "rtpu-telemetry-flush",
    "rtpu-telemetry-sampler",
    "rtpu-dash-history",
})


def _short_path(path: str) -> str:
    parts = path.replace(os.sep, "/").rsplit("/", 2)
    return "/".join(parts[-2:]) if len(parts) > 1 else path


def _format_stack(frame) -> List[str]:
    """Frames of one thread, outermost first (faulthandler order), each
    ``func (dir/file.py:line)``."""
    out: List[str] = []
    while frame is not None:
        code = frame.f_code
        out.append(f"{code.co_name} "
                   f"({_short_path(code.co_filename)}:{frame.f_lineno})")
        frame = frame.f_back
    out.reverse()
    return out


def thread_stacks() -> List[dict]:
    """All live threads of THIS process via ``sys._current_frames()``."""
    names: Dict[int, Tuple[str, bool]] = {
        t.ident: (t.name, t.daemon) for t in threading.enumerate()
        if t.ident is not None}
    out = []
    for tid, frame in sys._current_frames().items():
        name, daemon = names.get(tid, (f"tid-{tid}", True))
        out.append({"thread_id": tid, "thread_name": name,
                    "daemon": daemon, "frames": _format_stack(frame)})
    out.sort(key=lambda d: (d["thread_name"] != "MainThread",
                            d["thread_name"]))
    return out


def collect_stack_dump(kind: str = "process", **ids) -> dict:
    """One process's stack dump record (the ``STACK_DUMP`` reply body).
    ``ids`` carries identity tags (worker_id, node_id, ...). The dump
    also names the task currently executing in this process (best-
    effort read of the execution context from the reader thread) so a
    control-plane diagnosis — e.g. the stall detector's
    ``collective_stuck`` probe — can map a stalled task to its worker's
    stack without a worker registry round trip."""
    from . import context
    out = {"kind": kind, "pid": os.getpid(), "timestamp": time.time(),
           "threads": thread_stacks(), **ids}
    tid = getattr(context, "current_task_id", None)
    if tid is not None:
        try:
            out.setdefault("task_id", tid.hex())
            out.setdefault("task_name",
                           getattr(context, "current_task_name", None))
        except Exception:   # noqa: BLE001 — identity tags are optional
            pass
    return out


def format_stack_dump(dump: dict) -> str:
    """Human-readable rendering of one dump (CLI / logs)."""
    who = dump.get("worker_id") or dump.get("node_id") or "?"
    lines = [f"--- {dump.get('kind', 'process')} {str(who)[:12]} "
             f"pid={dump.get('pid')} ---"]
    for th in dump.get("threads", []):
        lines.append(f"  Thread {th['thread_name']} "
                     f"(id={th['thread_id']}"
                     f"{', daemon' if th.get('daemon') else ''}):")
        for fr in th.get("frames", []):
            lines.append(f"    {fr}")
    return "\n".join(lines)


# ------------------------------------------------------ sampling profiler

def run_profile(duration_s: float, interval_ms: float = 10,
                task_filter: Optional[str] = None,
                exclude_threads: frozenset = RUNTIME_THREADS) -> dict:
    """Sample this process's threads for ``duration_s`` at
    ``interval_ms``. Wall-clock sampling: a thread blocked in get() or a
    collective accrues samples exactly where it waits, which is the
    point. Output:

    - ``collapsed``: {"f1;f2;f3": count} — flamegraph collapsed-stack
      format (``flamegraph.pl``/speedscope-compatible once written as
      ``stack count`` lines).
    - ``segments``: [[thread_name, leaf_frame, start_ts, end_ts], ...] —
      consecutive same-leaf samples merged; feeds ``chrome_trace()``.

    ``task_filter`` only records samples taken while this worker's
    current task name contains the substring (best-effort for
    max_concurrency>1 actors: the marker is process-global).
    """
    from . import context

    interval = max(float(interval_ms), 1.0) / 1000.0
    deadline = time.monotonic() + max(float(duration_s), 0.05)
    collapsed: Dict[str, int] = {}
    open_segs: Dict[int, list] = {}      # tid -> [name, leaf, start, end]
    segments: List[list] = []
    own = threading.get_ident()
    num_samples = 0
    while time.monotonic() < deadline:
        ts = time.time()
        if task_filter is not None:
            current = getattr(context, "current_task_name", None)
            if not current or task_filter not in current:
                # close open segments: a matching task resuming later
                # with the same leaf must not extend a span across the
                # filtered-out gap in the Chrome trace
                segments.extend(open_segs.values())
                open_segs.clear()
                time.sleep(interval)
                continue
        names = {t.ident: t.name for t in threading.enumerate()
                 if t.ident is not None}
        for tid, frame in sys._current_frames().items():
            if tid == own:
                continue
            name = names.get(tid, f"tid-{tid}")
            if name in exclude_threads or name.startswith("rtpu-debug"):
                continue
            frames = _format_stack(frame)
            if not frames:
                continue
            key = ";".join(frames)
            collapsed[key] = collapsed.get(key, 0) + 1
            leaf = frames[-1]
            seg = open_segs.get(tid)
            if seg is not None and seg[1] == leaf:
                seg[3] = ts
            else:
                if seg is not None:
                    segments.append(seg)
                open_segs[tid] = [name, leaf, ts, ts]
        num_samples += 1
        time.sleep(interval)
    segments.extend(open_segs.values())
    return {"duration_s": float(duration_s),
            "interval_ms": float(interval_ms),
            "num_samples": num_samples,
            "task_filter": task_filter,
            "collapsed": collapsed,
            "segments": segments}


def profile_async(conn, token: int, opts: dict, **ids) -> None:
    """Worker-side ``PROFILE_START`` handler: run the sampler on a
    background thread and ship the report back as ``PROFILE_REPORT``.
    Never blocks the caller (the connection reader thread)."""
    from . import protocol as P

    def run():
        try:
            report = run_profile(
                float(opts.get("duration_s", 5.0)),
                float(opts.get("interval_ms", 10)),
                opts.get("task_filter"))
            report.update(ids)
        except Exception:   # noqa: BLE001 — debugging must not kill work
            report = None
        try:
            conn.send((P.PROFILE_REPORT, (token, report)))
        except OSError:
            pass

    threading.Thread(target=run, daemon=True,
                     name="rtpu-debug-profiler").start()


def merge_collapsed(reports: List[dict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for rep in reports or []:
        for stack, count in (rep.get("collapsed") or {}).items():
            out[stack] = out.get(stack, 0) + count
    return out


def top_stacks(collapsed: Dict[str, int], n: int = 10) -> List[tuple]:
    """Most-sampled stacks, (count, [frames]) descending."""
    ranked = sorted(collapsed.items(), key=lambda kv: -kv[1])[:n]
    return [(count, stack.split(";")) for stack, count in ranked]


def write_collapsed(collapsed: Dict[str, int], path: str) -> None:
    """``stack count`` lines — feed to flamegraph.pl / speedscope."""
    with open(path, "w") as f:
        for stack, count in sorted(collapsed.items(),
                                   key=lambda kv: -kv[1]):
            f.write(f"{stack} {count}\n")


def chrome_trace(reports: List[dict]) -> List[dict]:
    """Chrome-trace JSON (chrome://tracing / Perfetto) from per-worker
    sample segments: one X event per run of identical leaf frames."""
    trace = []
    for rep in reports or []:
        pid = (f"worker:{str(rep.get('worker_id', '?'))[:8]}"
               + (f"@{str(rep.get('node_id', ''))[:8]}"
                  if rep.get("node_id") else ""))
        interval_s = float(rep.get("interval_ms", 10)) / 1000.0
        for name, leaf, start, end in rep.get("segments", []):
            trace.append({
                "name": leaf, "cat": "sample", "ph": "X",
                "ts": start * 1e6,
                "dur": max(end - start, interval_s) * 1e6,
                "pid": pid, "tid": name, "args": {},
            })
    return trace
