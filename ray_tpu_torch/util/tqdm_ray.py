"""Distributed-safe tqdm-compatible progress bars.

Reference: ``python/ray/experimental/tqdm_ray.py`` — worker-side bars
emit magic JSON lines on stdout; the driver's log pump recognizes them
and renders a single in-place progress line instead of interleaving
raw prints from many processes. Same protocol shape here: the magic
token rides the existing worker-log channel, so no extra RPC surface.
"""

from __future__ import annotations

import json
import sys
import time
import uuid
from typing import Any, Iterable, Optional

MAGIC = "__rtpu_tqdm__:"

from .._private import locksan

_render_lock = locksan.lock("tqdm.render")
_last_render: dict = {}            # bar_id -> state (driver side)


def _emit(state: dict) -> None:
    """Worker side: ship the bar state as one magic stdout line (the
    log tailer forwards it; the driver renders)."""
    sys.stdout.write(MAGIC + json.dumps(state) + "\n")
    sys.stdout.flush()


def render_magic_line(line: str) -> bool:
    """Driver side: if ``line`` is a bar update, render it in place and
    return True (the log pump then suppresses the raw line)."""
    if not line.startswith(MAGIC):
        return False
    try:
        state = json.loads(line[len(MAGIC):])
    except ValueError:
        return False
    _render(state)
    return True


def _render(state: dict) -> None:
    with _render_lock:
        if state.get("closed"):
            _last_render.pop(state.get("id"), None)
            sys.stderr.write("\n")
            sys.stderr.flush()
            return
        _last_render[state.get("id")] = state
        n, total = state.get("n", 0), state.get("total")
        desc = state.get("desc") or "progress"
        if total:
            frac = n / max(total, 1)
            width = 24
            bar = "#" * int(frac * width)
            txt = (f"\r{desc}: {n}/{total} "
                   f"[{bar:<{width}}] {frac * 100:5.1f}%")
        else:
            txt = f"\r{desc}: {n}it"
        sys.stderr.write(txt)
        sys.stderr.flush()


class tqdm:
    """tqdm-compatible surface: iterate, update(), close(),
    set_description(); safe inside remote tasks/actors."""

    def __init__(self, iterable: Optional[Iterable] = None, *,
                 desc: str = "", total: Optional[int] = None,
                 **_ignored: Any):
        self._iterable = iterable
        self.desc = desc
        if total is None and iterable is not None:
            try:
                total = len(iterable)       # type: ignore[arg-type]
            except TypeError:
                total = None
        self.total = total
        self.n = 0
        self._id = uuid.uuid4().hex[:12]
        self._last_emit = 0.0
        self._closed = False
        self._report(force=True)

    # ------------------------------------------------------------- tqdm API
    def __iter__(self):
        if self._iterable is None:
            raise TypeError("this tqdm was created without an iterable")
        try:
            for item in self._iterable:
                yield item
                self.update(1)
        finally:
            self.close()

    def update(self, n: int = 1) -> None:
        self.n += n
        self._report()

    def set_description(self, desc: str) -> None:
        self.desc = desc
        self._report()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._report(force=True, closed=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ reporting
    def _report(self, force: bool = False, closed: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_emit < 0.1:
            return                      # rate-limit: 10 updates/s max
        self._last_emit = now
        state = {"id": self._id, "desc": self.desc, "n": self.n,
                 "total": self.total, "closed": closed}
        from .._private import context
        if context.in_worker:
            _emit(state)                # rendered on the driver
        else:
            _render(state)
