"""The traced slice of a run: ``torch.profiler`` over a stretch of the cell's
own work, reduced to a plain summary in the process that owns the card.

The device's busy time is the union of its operations' intervals (kernels,
copies and fills of every stream): summing kernel times would count the
overlap of two streams twice. Each idle gap of the device is named by what
the host was doing at its middle: the innermost of the benchmark's own
spans (``bench.*``, `span`) and the innermost of the program's operations
there. Attention's device time is that of every kernel launched under the
port's attention entry point (the autograd function ``FlashAttention``
and its backward node), found through the profiler's link from each host
operation to the kernels it launched, never by a kernel's name.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

SPAN_PREFIX = "bench."
ATTN_FWD = "FlashAttention"
ATTN_BWD = "FlashAttentionBackward"
TOP = 10


def span(name: str):
    """A host span of the benchmark's own (a no-op unless a profiler runs)."""
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def gaps(merged: Sequence[Sequence[float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no merged interval covers."""
    out, at = [], lo
    for a, b in merged:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def _innermost(ops: Sequence[dict], t: float, bench: bool) -> Optional[str]:
    best = None
    for op in ops:
        if (op["name"].startswith(SPAN_PREFIX) == bench
                and op["start"] <= t <= op["end"]
                and (best is None
                     or op["end"] - op["start"] < best["end"] - best["start"])):
            best = op
    return None if best is None else best["name"]


def name_gap(ops: Sequence[dict], a: float, b: float, outside: str) -> str:
    """`bench span>program op` at the gap's middle; `outside` where no span
    of the benchmark's is open (the host is in the program's own loop)."""
    mid = (a + b) / 2
    bench = _innermost(ops, mid, True)
    prog = _innermost(ops, mid, False)
    name = bench[len(SPAN_PREFIX):] if bench else outside
    return f"{name}>{prog}" if prog else name


def attention_calls(ops: Sequence[dict]) -> List[dict]:
    """Each outermost call of the attention entry point (forward or
    backward), with the device seconds of every kernel launched under it
    (by the host operations it contains on its thread)."""
    calls = []
    for op in sorted(ops, key=lambda o: (o["start"], -o["end"])):
        kind = ("fwd" if op["name"] == ATTN_FWD else
                "bwd" if op["name"].endswith(ATTN_BWD) else None)
        if kind is None:
            continue
        if calls and calls[-1]["thread"] == op["thread"] \
                and op["end"] <= calls[-1]["end"]:
            continue    # the node inside the autograd engine's record of it
        calls.append({"kind": kind, "start": op["start"], "end": op["end"],
                      "thread": op["thread"], "device_s": 0.0})
    for call in calls:
        call["device_s"] = sum(
            o["kernel_s"] for o in ops
            if o["thread"] == call["thread"] and o["start"] >= call["start"]
            and o["end"] <= call["end"])
    return calls


def summarize(kernels: Sequence[dict], ops: Sequence[dict], window_s: float,
              outside: str) -> dict:
    """The summary of a traced slice: `kernels` are the device's operations
    (start, end, name; seconds on the trace's clock), `ops` the host's
    (start, end, name, thread, kernel_s), `window_s` the slice's
    length by the host's clock."""
    merged = union([(k["start"], k["end"]) for k in kernels])
    busy = sum(b - a for a, b in merged)
    # gaps between the device's first and last operation: the profiler's
    # own start and stop are not the program's
    idle = sorted(gaps(merged, merged[0][0], merged[-1][1]) if merged
                  else [], key=lambda g: g[0] - g[1])[:TOP]
    by_name: Dict[str, float] = {}
    for k in kernels:
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["end"] - k["start"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy, "window_s": window_s,
        "device_ops": [[n[:64], s] for n, s in top],
        "idle_gaps": [[name_gap(ops, a, b, outside), b - a] for a, b in idle],
        "attention": [{k: c[k] for k in ("kind", "device_s")}
                      for c in attention_calls(ops)],
    }


class Tracer:
    """torch.profiler over a slice of work on this process's card."""

    def __init__(self, outside: str, cuda: bool = True):
        self.outside, self.cuda = outside, cuda
        self.prof = None
        self.t0 = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        kernels, ops = [], []
        for e in self.prof.events():
            start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type.name == "CUDA":
                # a host span's annotation on the device's timeline is no
                # device work
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(SPAN_PREFIX)):
                    kernels.append({"start": start, "end": end,
                                    "name": e.name})
            elif e.device_type.name == "CPU":
                ops.append({"start": start, "end": end, "name": e.name,
                            "thread": e.thread,
                            "kernel_s": sum(k.duration for k in e.kernels)
                            * 1e-6})
        return summarize(kernels, ops, self.window_s, self.outside)
