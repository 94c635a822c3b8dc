"""Pluggable persistence for the control plane's durable tables.

Reference analogue: ``src/ray/gcs/store_client/`` — the GCS writes its
metadata through a storage client (in-memory or Redis) so a restarted
GCS process recovers cluster metadata. Here the durable backend is an
append-only journal file with snapshot compaction: every durable
mutation (KV, jobs, placement-group specs) is
appended as it commits; a restarted head replays the journal and
carries on. Volatile state (object directory, refcounts, heartbeats,
task events) is intentionally NOT journaled — it describes processes
that died with the old head.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Iterator, List, Optional, Tuple

from . import locksan

_LEN = struct.Struct("<I")

Entry = Tuple[str, str, Any]          # (table, op, payload)


class InMemoryStorage:
    """Default: nothing persists (matches the reference's in-memory
    store client)."""

    def append(self, entry: Entry) -> None:
        pass

    def load(self) -> List[Entry]:
        return []

    def compact(self, snapshot: List[Entry]) -> None:
        pass

    def close(self) -> None:
        pass


class FileStorage:
    """Append-only journal with atomic snapshot compaction.

    Layout: ``<path>`` is the journal; each record is a length-prefixed
    pickle of one Entry. ``compact()`` rewrites the file from a
    snapshot via rename, so a crash mid-compaction keeps the old
    journal intact. A torn final record (crash mid-append) is dropped
    at load.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = locksan.lock("gcs.journal")
        self._f = open(path, "ab")

    def append(self, entry: Entry) -> None:
        data = pickle.dumps(entry, protocol=5)
        with self._lock:
            self._f.write(_LEN.pack(len(data)) + data)
            self._f.flush()  # lint: allow-under-lock(the journal lock IS the append serializer; a flush outside it could interleave torn records)
            # fsync so an acknowledged durable mutation survives host
            # power loss, matching compact()'s guarantee. Appends are
            # rare (jobs/durable-KV/PGs only), so per-append cost is fine.
            os.fsync(self._f.fileno())

    def load(self) -> List[Entry]:
        out: List[Entry] = []
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return out
        off = 0
        while off + _LEN.size <= len(raw):
            (n,) = _LEN.unpack_from(raw, off)
            off += _LEN.size
            if off + n > len(raw):
                break                      # torn tail record: drop it
            try:
                out.append(pickle.loads(raw[off:off + n]))
            except Exception:              # noqa: BLE001 — corrupt record
                break
            off += n
        return out

    def compact(self, snapshot: List[Entry]) -> None:
        tmp = self.path + ".tmp"
        with self._lock:
            with open(tmp, "wb") as f:
                for entry in snapshot:
                    data = pickle.dumps(entry, protocol=5)
                    f.write(_LEN.pack(len(data)) + data)
                f.flush()  # lint: allow-under-lock(compaction must exclude appends for the whole rewrite+rename or committed entries vanish)
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "ab")

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


def open_storage(spec: Optional[str]):
    """``None``/"" -> in-memory; anything else -> journal file path
    (a directory gets ``gcs.journal`` inside it)."""
    if not spec:
        return InMemoryStorage()
    path = spec
    if os.path.isdir(spec) or spec.endswith(os.sep):
        path = os.path.join(spec, "gcs.journal")
    return FileStorage(path)
