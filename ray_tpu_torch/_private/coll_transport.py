"""Peer-to-peer collective chunk plane: per-process mailbox + routed sends.

The data plane under ``comm/collective.py``'s ring/tree schedules. A rank
is addressed by its **endpoint** ``(node_id_bytes, worker_id_bytes)``;
``send`` ships one ``COLL_ROUTE`` frame to this process's node, which
delivers it to the destination process's connection — directly when the
destination lives on the same node, across the node plane (``COLL_FWD``)
otherwise. Tensor payloads are numpy arrays, which ride each hop
out-of-band (pickle protocol-5 iovecs) once they clear
``transport_oob_threshold_bytes`` — zero-copy end to end.

Completion is driven by connection reader threads: an arriving
``COLL_DELIVER`` frame is deposited here (``deposit``) under a condition
variable that wakes the rank thread blocked in ``wait``. There is no
polling anywhere on this path — a waiter sleeps until its chunk arrives
or its deadline passes.

**Epoch fencing** (group self-healing): when a collective group reforms
after a rank death, the failing epoch is ``fence``d *before* the
survivors re-join — its undelivered chunks are dropped on the spot, and
any chunk of that epoch still in flight (a dead rank's last sends, a
survivor's pipelined traffic) is refused at ``deposit`` time instead of
parked. A stale-epoch chunk can therefore never be delivered into (or
accumulate beside) the reformed epoch's calls, and teardown never waits
on the TTL sweep.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from . import context
from . import fieldsan
from . import flight_recorder
from . import locksan
from . import telemetry
from .config import CONFIG

M_COLL_CHUNKS = telemetry.define(
    "counter", "rtpu_collective_chunks_total",
    "Peer-to-peer collective chunks sent by this rank")
M_COLL_WIRE_BYTES = telemetry.define(
    "counter", "rtpu_collective_wire_bytes_total",
    "Payload bytes this rank sent peer-to-peer for collectives (ring "
    "allreduce: ~2x tensor size per rank, independent of world size)")
M_COLL_INFLIGHT = telemetry.define(
    "gauge", "rtpu_collective_inflight_chunks",
    "Collective chunks delivered to this process but not yet consumed "
    "by a waiting rank thread")
M_COLL_HOP = telemetry.define(
    "histogram", "rtpu_collective_hop_seconds",
    "Time a rank thread spent blocked waiting for one collective chunk "
    "to arrive, tagged by schedule phase — per-rank hop-latency skew "
    "makes chronic stragglers visible before they become hangs")
M_COLL_FENCED = telemetry.define(
    "counter", "rtpu_collective_fenced_chunks_total",
    "Stale-epoch collective chunks dropped by the reform fence (swept "
    "from the mailbox at fence time, or refused on arrival) — traffic "
    "of a failed epoch that must never reach the reformed group's calls")

_lock = locksan.lock("coll.mailbox")
_cond = locksan.condition("coll.mailbox", _lock)
_slots: Dict[tuple, Any] = {}
# arrival time per undelivered chunk, for the stale sweep: a rank that
# timed out (or died) mid-collective leaves chunks addressed to keys no
# waiter will ever consume — without a TTL they'd sit here until
# destroy_collective_group, growing without bound across retried calls
_born: Dict[tuple, float] = {}
_next_sweep = [0.0]             # guarded by _lock
# fenced epochs per group (guarded by _lock): chunks keyed with a fenced
# (group, epoch) prefix are dropped instead of deposited. Bounded both
# ways — per group (a group that reformed more than maxlen times has
# long stopped receiving its oldest epochs' traffic) and across groups
# (destroy fences on every teardown, so per-job group-name churn must
# not grow the dict for the process lifetime; evicted groups' stale
# stragglers fall back to the TTL sweep)
_FENCED_PER_GROUP = 8
_FENCED_GROUPS = 64
_fenced: Dict[str, deque] = {}

# plain per-process counters for tests/diagnostics (no shard-lock cost);
# single-writer per field in practice (the rank thread / reader thread).
# sent_remote_* count only chunks addressed to a DIFFERENT node — the
# traffic that actually crosses the node plane (COLL_FWD), which is what
# hierarchical schedules and the quantized wire format exist to shrink.
_stats = {"sent_chunks": 0, "sent_bytes": 0, "recv_chunks": 0,
          "recv_bytes": 0, "sent_remote_chunks": 0,
          "sent_remote_bytes": 0, "fenced_chunks": 0}


def payload_nbytes(payload) -> int:
    """Wire-payload size of one chunk: ndarray / QuantChunk ``nbytes``,
    recursed through tuples/lists (hierarchical allgather ships bundles
    of per-rank arrays in one mailbox message)."""
    nbytes = getattr(payload, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    if isinstance(payload, (tuple, list)):
        return sum(payload_nbytes(v) for v in payload)
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return len(payload)
    return 0


def local_endpoint() -> Optional[Tuple[bytes, bytes]]:
    """This process's rank address, or None when no runtime client is
    connected (the group then degrades to the coordinator fallback)."""
    client = context.current_client
    if client is None or client.node_id is None:
        return None
    return (client.node_id.binary(), client.worker_id.binary())


def send(dest: Tuple[bytes, bytes], key: tuple, payload,
         group: str = "", op: str = "") -> None:
    """Route one chunk to ``dest``'s mailbox under ``key``. Fire and
    forget: delivery failures surface as the receiver's deadline."""
    from . import protocol as P
    client = context.require_client()
    nbytes = payload_nbytes(payload)
    flight_recorder.note_send(key, nbytes)
    client.conn.send((P.COLL_ROUTE, (dest[0], dest[1], key, payload)))
    _stats["sent_chunks"] += 1
    _stats["sent_bytes"] += nbytes
    if client.node_id is not None and dest[0] != client.node_id.binary():
        _stats["sent_remote_chunks"] += 1
        _stats["sent_remote_bytes"] += nbytes
    tags = (("group", group), ("op", op))
    telemetry.counter_inc(M_COLL_CHUNKS, 1.0, tags)
    if nbytes:
        telemetry.counter_inc(M_COLL_WIRE_BYTES, float(nbytes), tags)


def deposit(key: tuple, value) -> None:
    """Reader-thread side: park an arrived chunk and wake waiters.
    Chunks of a fenced (group, epoch) — traffic of an epoch a reform
    already superseded — are dropped here instead of parked: no waiter
    under the new epoch can ever key-match them, and without the fence
    they would sit in the mailbox until the TTL sweep."""
    now = time.monotonic()
    # ring-only recorder hook BEFORE taking the mailbox lock (lock-free
    # append; the reader thread must never nest another lock here)
    flight_recorder.note_deliver(key, payload_nbytes(value))
    with _cond:
        if len(key) >= 2:
            fenced = _fenced.get(key[0])
            if fenced is not None and key[1] in fenced:
                _stats["fenced_chunks"] += 1
                telemetry.counter_inc(M_COLL_FENCED, 1.0,
                                      (("group", str(key[0])),))
                return
        _slots[key] = value
        _born[key] = now
        if now >= _next_sweep[0]:
            ttl = CONFIG.collective_call_ttl_s
            _next_sweep[0] = now + max(1.0, ttl / 4)
            for k in [k for k, b in _born.items() if now - b > ttl]:
                _slots.pop(k, None)
                _born.pop(k, None)
        n = len(_slots)
        _cond.notify_all()
    _stats["recv_chunks"] += 1
    _stats["recv_bytes"] += payload_nbytes(value)
    telemetry.gauge_set(M_COLL_INFLIGHT, float(n))


def wait(key: tuple, deadline: float, what: str = "collective chunk"):
    """Block until ``key``'s chunk arrives; raises TimeoutError at the
    deadline (a dead peer must not hang the survivors)."""
    t0 = time.monotonic()
    flight_recorder.note_wait(key)
    with _cond:
        while key not in _slots:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"timed out waiting for {what} {key!r} — a group "
                    "member is dead, wedged, or running a mismatched "
                    "collective schedule")
            _cond.wait(remaining)
        value = _slots.pop(key)
        _born.pop(key, None)
        n = len(_slots)
    nbytes = payload_nbytes(value)
    flight_recorder.note_recv(key, nbytes)
    _okey, phase = flight_recorder.parse_key(key)
    telemetry.hist_observe(M_COLL_HOP, time.monotonic() - t0,
                           (("phase", phase),))
    telemetry.gauge_set(M_COLL_INFLIGHT, float(n))
    return value


def flush() -> None:
    """Block until every chunk this process queued on its node link has
    reached the socket. Schedules send ZERO-COPY views of caller-owned
    (and returned) arrays; under send-queue contention those views are
    pickled later by whichever thread drains the queue, so a collective
    only becomes safe to return from — letting the caller mutate its
    tensors — once the link is flushed. Uncontended (the common case)
    this is one try-lock."""
    client = context.current_client
    if client is not None:
        client.conn.flush()


def fence(group: str, epoch: str) -> int:
    """Fence one (group, epoch): drop its undelivered chunks NOW and
    refuse any further deposit keyed with it. Called by the reform path
    BEFORE the survivors re-join (so nothing of the failing epoch can
    cross into the new one) and by group teardown (so a dead member's
    stranded traffic never waits on the TTL sweep). Returns the number
    of chunks dropped at fence time; late arrivals count into
    ``stats()["fenced_chunks"]`` as they are refused."""
    dropped = 0
    with _cond:
        fenced = _fenced.get(group)
        if fenced is None:
            fenced = _fenced[group] = deque(maxlen=_FENCED_PER_GROUP)
            while len(_fenced) > _FENCED_GROUPS:
                _fenced.pop(next(iter(_fenced)))
        if epoch not in fenced:
            fenced.append(epoch)
        for k in [k for k in _slots if k[:2] == (group, epoch)]:
            del _slots[k]
            _born.pop(k, None)
            dropped += 1
        if dropped:
            _stats["fenced_chunks"] += dropped
            telemetry.counter_inc(M_COLL_FENCED, float(dropped),
                                  (("group", group),))
        telemetry.gauge_set(M_COLL_INFLIGHT, float(len(_slots)))
    return dropped


def fenced_epochs(group: str) -> Tuple[str, ...]:
    """Test/debug surface: the epochs currently fenced for a group."""
    with _lock:
        return tuple(_fenced.get(group) or ())


def pending_keys() -> Tuple[tuple, ...]:
    """Test/debug surface: keys of every undelivered chunk (the chaos
    tests assert no stale-epoch key survives a reform)."""
    with _lock:
        return tuple(_slots)


def drop_call(group: str, epoch: str, seq) -> None:
    """Discard undelivered chunks of ONE timed-out call (keys lead with
    (group, epoch, seq)): nothing will ever consume them, and without
    this the ``rtpu_collective_inflight_chunks`` gauge stays elevated
    for up to ``collective_call_ttl_s`` after every failed collective —
    the gauge must return to 0 when the failure is handled, not when
    the sweep happens by."""
    prefix = (group, epoch, seq)
    with _cond:
        for k in [k for k in _slots if k[:3] == prefix]:
            del _slots[k]
            _born.pop(k, None)
        telemetry.gauge_set(M_COLL_INFLIGHT, float(len(_slots)))


def drop_group(group: str, epoch: str) -> None:
    """Discard undelivered chunks of a destroyed group (keys lead with
    (group, epoch)) so name reuse can never consume stale traffic."""
    with _cond:
        for k in [k for k in _slots
                  if k[:2] == (group, epoch)]:
            del _slots[k]
            _born.pop(k, None)
        telemetry.gauge_set(M_COLL_INFLIGHT, float(len(_slots)))


def stats() -> Dict[str, int]:
    """Per-process wire counters (tests assert ring traffic is O(size)
    per rank, not O(world * size) through one process)."""
    out = dict(_stats)
    with _lock:
        out["pending"] = len(_slots)
    return out


# guarded-by plane: wrap the declared module-level mailbox state in
# checking proxies (no-op when RTPU_FIELDSAN is off)
fieldsan.instrument_module(globals(), "coll_transport")
