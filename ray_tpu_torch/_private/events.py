"""Structured cluster event log.

Reference analogue: the event framework (``src/ray/util/event.h`` —
RAY_EVENT macros writing structured JSON event files per component,
surfaced by ``ray list cluster-events``). Here: every node appends
JSONL records to ``<session>/events/`` AND publishes them to the
control plane's bounded ring, where ``state.api.list_cluster_events()``
reads them back. Events cover lifecycle facts a timeline of task states
can't express: node up/down, OOM kills, worker-start failures, actor
deaths with causes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

from . import locksan

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")


class EventLogger:
    def __init__(self, session_dir: str, node_id_hex: str, gcs=None):
        self._dir = os.path.join(session_dir, "events")
        os.makedirs(self._dir, exist_ok=True)
        self._path = os.path.join(self._dir,
                                  f"events_{node_id_hex[:12]}.jsonl")
        self._node = node_id_hex
        self._gcs = gcs
        self._lock = locksan.lock("events.file")

    def emit(self, severity: str, label: str, message: str,
             local_only: bool = False, **fields: Any) -> None:
        """Append one structured event; never raises (observability must
        not take down the component it observes). ``local_only`` skips
        the control-plane publish — for facts every node observes
        simultaneously (a peer death), which would otherwise flood the
        bounded ring with N-1 duplicates."""
        rec = {
            "timestamp": time.time(),
            "severity": severity if severity in SEVERITIES else "INFO",
            "label": label,
            "message": message,
            "node_id": self._node,
            "pid": os.getpid(),
            **fields,
        }
        try:
            line = json.dumps(rec, default=str)
        except (TypeError, ValueError):
            return
        try:
            with self._lock, open(self._path, "a") as f:
                f.write(line + "\n")
        except OSError:
            pass
        if self._gcs is not None and not local_only:
            try:
                self._gcs.record_cluster_event(rec)
            except Exception:    # noqa: BLE001 — best-effort publish
                pass

    def info(self, label: str, message: str, **fields) -> None:
        self.emit("INFO", label, message, **fields)

    def warning(self, label: str, message: str, **fields) -> None:
        self.emit("WARNING", label, message, **fields)

    def error(self, label: str, message: str, **fields) -> None:
        self.emit("ERROR", label, message, **fields)
