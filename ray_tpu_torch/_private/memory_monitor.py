"""Node memory monitor and OOM worker-killing policy.

When system memory crosses a usage threshold the node kills a running
worker — preferring retriable work, newest first — instead of letting the
kernel OOM-killer take down the raylet or an arbitrary process.

Reference analogues: ``src/ray/common/memory_monitor.h:52`` (cgroup/proc
usage polling + threshold callback) and
``src/ray/raylet/worker_killing_policy.h:34`` (retriable-LIFO victim
selection). The detection here is the same /proc + cgroup-v2 reading the
reference does; the policy is the same retriable-first LIFO.

Tests (and single-host simulations) can force the reading with the
``RTPU_TEST_MEMORY_USAGE_FRACTION`` environment variable, which is
re-read on every probe so pressure can be raised and dropped mid-run.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

# cgroup v2 (container) limits take precedence over host totals: inside a
# container /proc/meminfo shows the HOST, and the kernel kills at the
# cgroup limit long before the host is full.
_CGROUP_CURRENT = "/sys/fs/cgroup/memory.current"
_CGROUP_MAX = "/sys/fs/cgroup/memory.max"


def _read_int_file(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            raw = f.read().strip()
    except OSError:
        return None
    if raw == "max":
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def _proc_meminfo() -> Tuple[Optional[int], Optional[int]]:
    """(total_bytes, available_bytes) from /proc/meminfo."""
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                if total is not None and avail is not None:
                    break
    except OSError:
        pass
    return total, avail


def process_rss_bytes(pid: int) -> int:
    """Resident set size of one process (0 if gone)."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return 0


class MemoryMonitor:
    """Polls system/cgroup memory; reports the used fraction."""

    def usage_fraction(self) -> float:
        forced = os.environ.get("RTPU_TEST_MEMORY_USAGE_FRACTION")
        if forced:
            try:
                return float(forced)
            except ValueError:
                pass
        cur, limit = (_read_int_file(_CGROUP_CURRENT),
                      _read_int_file(_CGROUP_MAX))
        if cur is not None and limit:
            return cur / limit
        total, avail = _proc_meminfo()
        if total and avail is not None:
            return 1.0 - avail / total
        return 0.0

    def snapshot(self) -> dict:
        """Usage fraction plus totals from the SAME source the fraction
        came from — inside a container the cgroup limit is the relevant
        total, not the host's /proc/meminfo."""
        frac = self.usage_fraction()
        limit = _read_int_file(_CGROUP_MAX)
        if (_read_int_file(_CGROUP_CURRENT) is not None and limit
                and not os.environ.get("RTPU_TEST_MEMORY_USAGE_FRACTION")):
            total = limit
        else:
            total = _proc_meminfo()[0] or 0
        return {
            "usage_fraction": round(frac, 4),
            "total_bytes": total,
            "available_bytes": max(0, int(total * (1.0 - frac))),
        }


def pick_oom_victim(workers: Iterable,
                    actor_restartable=lambda actor_id: False,
                    rss_of=lambda worker: 0,
                    ) -> Optional[object]:
    """Choose the worker to kill under memory pressure.

    Policy (reference ``worker_killing_policy.h:34`` RetriableLIFO):
    prefer workers whose in-flight work can be retried/restarted
    (retriable tasks first, then restartable actors); among equals kill
    the largest resident set (``rss_of``, the kill that actually
    relieves the pressure), and only then the most recently started —
    the oldest work has the most sunk cost. ``rss_of`` defaults to a
    constant so callers without pid access keep pure retriable-LIFO.
    Idle/starting workers are not considered (they hold no task to
    shed; idle eviction handles them separately).
    """
    best = None
    best_key = None
    for w in workers:
        if w.task is None and w.actor_id is None:
            continue
        if w.state not in ("BUSY", "ACTOR"):
            continue
        if w.actor_id is not None:
            # rank actors below plain tasks at equal retriability: an
            # actor restart loses its whole state, a task retry only
            # its own progress
            retriable = 1 if actor_restartable(w.actor_id) else 0
        else:
            rec = w.task
            retriable = 2 if (rec.retries_left > 0
                              or getattr(rec, "oom_retries_left", 0) > 0
                              ) else 0
        # newest *assignment* as the last tiebreak (pooled workers are
        # reused, so process start time would misrank sunk cost); fall
        # back to process start for workers predating assignment stamps
        key = (retriable, rss_of(w),
               getattr(w, "assigned_at", 0.0) or w.started_at)
        if best_key is None or key > best_key:
            best, best_key = w, key
    return best
