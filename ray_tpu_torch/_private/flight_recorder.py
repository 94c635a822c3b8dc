"""Collective flight recorder: always-on, per-process, lock-light.

Reference analogue: the NCCL flight recorder ("Collective Communication
for 100k+ GPUs": at scale the dominant operational cost of collectives
is diagnosing stragglers and hangs). Every schedule in
``comm/collective.py`` and every mailbox op in
``_private/coll_transport.py`` feeds two structures:

- a fixed-size **event ring** (``flight_recorder_capacity`` slots;
  0 disables recording). Appends are lock-free: an ``itertools.count``
  hands each writer a distinct slot and a CPython list-item store is
  atomic — no allocation beyond the event tuple, no RPC, cheap enough
  to stay on for every chunk of every collective.
- a per-(group, op-key) **watermark table** of in-flight ops: chunks
  sent/consumed, the last phase touched, and the exact mailbox key the
  rank is currently blocked waiting on. Ops run on one rank thread per
  group, so the per-op record needs no lock; the table itself takes a
  short lock only at op begin/end and snapshot time (never on the
  chunk path).

``progress_snapshot()`` is the body of a ``COLL_PROGRESS`` reply —
answered on connection reader threads like ``STACK_DUMP``, so a rank
wedged *inside* a collective still answers. ``diagnose()`` is the
cluster-wide half: given every rank's snapshot it diffs watermarks and
names the verdict — **dead rank** (its process answered nothing),
**lost chunk** (a sender logged the send, the receiver never saw the
delivery — naming the edge), or **lagging rank** (lowest watermark).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import locksan
from . import telemetry
from .config import CONFIG

M_INFLIGHT_OPS = telemetry.define(
    "gauge", "rtpu_collective_inflight_ops",
    "Collective calls this process has started but not finished "
    "(flight-recorder watermark table size)")

# event kinds in the ring
EV_SEND = "send"
EV_DELIVER = "deliver"
EV_RECV = "recv"
EV_BEGIN = "begin"
EV_END = "end"

_lock = locksan.lock("coll.recorder")
_ring: List[Any] = []                 # event tuples, overwritten in place
_idx = itertools.count()              # thread-safe slot allocator
_groups: Dict[Tuple[str, str], dict] = {}   # (group, epoch) -> membership
_inflight: Dict[tuple, dict] = {}     # (group, okey) -> op record
_done: deque = deque(maxlen=256)      # completed op records (timeline)

# how many sent/delivered keys per in-flight op a snapshot ships for
# the lost-chunk cross-reference
_SNAP_KEYS_PER_OP = 64
_SNAP_RING_EVENTS = 256


def enabled() -> bool:
    return CONFIG.flight_recorder_capacity > 0


def _record(ev: tuple) -> None:
    """Lock-free ring append (see module docstring)."""
    cap = CONFIG.flight_recorder_capacity
    if cap <= 0:
        return
    ring = _ring
    if len(ring) != cap:
        ring = _resize(cap)
    ring[next(_idx) % len(ring)] = ev


def _resize(cap: int) -> list:
    global _ring
    with _lock:
        if len(_ring) != cap:
            _ring = [None] * cap
        return _ring


def parse_key(key: tuple) -> Tuple[Optional[tuple], str]:
    """Map one transport mailbox key to its recorder op-key and phase.

    Schedule keys are ``(group, epoch, seq:int, *tail)`` where the tail
    mixes phase strings ("rs"/"ag"/"hx"/...) with segment/chunk ints;
    p2p send/recv keys are ``(group, epoch, "p2p", src, dst, tag, seq)``.
    Phase strings come from a small fixed literal set, so the joined
    phase label is bounded-cardinality (safe as a metric tag)."""
    try:
        if len(key) < 3:
            return None, "other"
        if key[2] == "p2p":
            return (key[0], ("p2p",) + tuple(key[3:7])), "p2p"
        phase = ".".join(s for s in key[3:] if isinstance(s, str))
        return (key[0], key[2]), phase or "op"
    except Exception:   # noqa: BLE001 — malformed key: never break sends
        return None, "other"


# ------------------------------------------------------------ op lifecycle

def register_group(group: str, epoch: str, rank: int, world: int,
                   endpoints: Optional[List[Any]]) -> None:
    """Membership registry: which rank of which group THIS process is,
    plus every rank's endpoint (hex) so a diagnosis can name a dead
    rank's home. Fed by ``init_collective_group``."""
    eps = None
    if endpoints is not None:
        eps = [[e[0].hex()[:12], e[1].hex()[:12]] if e is not None else None
               for e in endpoints]
    with _lock:
        _groups[(group, epoch)] = {"rank": rank, "world": world,
                                   "endpoints": eps}


def unregister_group(group: str, epoch: str) -> None:
    with _lock:
        _groups.pop((group, epoch), None)
        for k in [k for k in _inflight if k[0] == group]:
            del _inflight[k]
    telemetry.gauge_set(M_INFLIGHT_OPS, float(len(_inflight)))


def op_begin(group: str, epoch: str, okey, op: str, algo: str,
             nbytes: int, world: int, rank: int) -> None:
    """One public collective call starts. ``okey`` is the sequence
    number for schedule ops, or the ("p2p", src, dst, tag, seq) tuple
    for direct send/recv."""
    if not enabled():
        return
    now = time.monotonic()
    rec = {"group": group, "epoch": epoch, "key": okey, "op": op,
           "algo": algo, "nbytes": int(nbytes), "world": world,
           "rank": rank, "start": time.time(), "start_mono": now,
           "sent": 0, "sent_bytes": 0, "recv": 0, "recv_bytes": 0,
           "last_phase": "", "last_mono": now,
           "waiting": None, "waiting_since": 0.0,
           "done": False, "error": None}
    _record((now, EV_BEGIN, (group, okey), op, algo, int(nbytes)))
    with _lock:
        _inflight[(group, okey)] = rec
    telemetry.gauge_set(M_INFLIGHT_OPS, float(len(_inflight)))


def op_error(group: str, okey, error: str) -> None:
    """Mark an op failed but KEEP it in the watermark table: the
    diagnosis fan-out that follows a TimeoutError must still see this
    rank's record (both survivors time out near-simultaneously — if
    each dropped its record before querying, nobody would have
    evidence). ``op_end`` retires it after diagnosis."""
    rec = _inflight.get((group, okey))
    if rec is not None:
        rec["error"] = error


def op_end(group: str, okey, error: Optional[str] = None) -> None:
    now = time.monotonic()
    with _lock:
        rec = _inflight.pop((group, okey), None)
    if rec is None:
        return
    rec["done"] = True
    rec["end_mono"] = now
    rec["dur"] = max(now - rec["start_mono"], 1e-6)
    if error is not None:
        rec["error"] = error
    _record((now, EV_END, (group, okey), rec["op"],
             rec["error"] or "ok", rec["nbytes"]))
    _done.append(rec)
    telemetry.gauge_set(M_INFLIGHT_OPS, float(len(_inflight)))


# ------------------------------------------------- chunk-path hooks (hot)

def note_send(key: tuple, nbytes: int) -> None:
    """Rank thread queued one chunk onto the node link."""
    if not enabled():
        return
    okey, phase = parse_key(key)
    _record((time.monotonic(), EV_SEND, key, nbytes))
    rec = _inflight.get(okey) if okey is not None else None
    if rec is not None:
        rec["sent"] += 1
        rec["sent_bytes"] += nbytes
        rec["last_phase"] = phase
        rec["last_mono"] = time.monotonic()


def note_deliver(key: tuple, nbytes: int) -> None:
    """Reader thread deposited one chunk into the mailbox. Ring only —
    the reader must stay lean (threading-model rule 4), and consumption
    (the true watermark) is recorded by ``note_recv`` on the rank
    thread."""
    if not enabled():
        return
    _record((time.monotonic(), EV_DELIVER, key, nbytes))


def note_wait(key: tuple) -> None:
    """Rank thread is about to block on ``key``. The key stays in the
    record until the chunk arrives — on a hang it IS the watermark
    ('phase rs, waiting on chunk 7'), and the lost-chunk diagnosis
    cross-references it against senders' logs."""
    if not enabled():
        return
    okey, _phase = parse_key(key)
    rec = _inflight.get(okey) if okey is not None else None
    if rec is not None:
        rec["waiting"] = key
        rec["waiting_since"] = time.time()


def note_recv(key: tuple, nbytes: int) -> None:
    """Rank thread consumed the awaited chunk."""
    if not enabled():
        return
    okey, phase = parse_key(key)
    _record((time.monotonic(), EV_RECV, key, nbytes))
    rec = _inflight.get(okey) if okey is not None else None
    if rec is not None:
        rec["recv"] += 1
        rec["recv_bytes"] += nbytes
        rec["last_phase"] = phase
        rec["last_mono"] = time.monotonic()
        rec["waiting"] = None


# ------------------------------------------------------------- snapshots

def _key_list(key) -> Optional[list]:
    if key is None:
        return None
    if isinstance(key, tuple):
        return [_key_list(k) if isinstance(k, tuple) else k for k in key]
    return key


def _key_tuple(key) -> Optional[tuple]:
    if key is None:
        return None
    if isinstance(key, (list, tuple)):
        return tuple(_key_tuple(k) if isinstance(k, (list, tuple)) else k
                     for k in key)
    return key


def _shape_op(rec: dict) -> dict:
    out = dict(rec)
    out["key"] = _key_list(out["key"]) if isinstance(
        out["key"], tuple) else out["key"]
    out["waiting"] = _key_list(out.get("waiting"))
    return out


def watermark(rec: dict) -> str:
    """Human-readable high-water mark of one op record: 'phase rs,
    chunk 7 sent / 6 delivered, waiting on (...)'."""
    parts = [f"phase {rec.get('last_phase') or 'start'}",
             f"{rec.get('sent', 0)} chunk(s) sent",
             f"{rec.get('recv', 0)} delivered"]
    w = rec.get("waiting")
    if w:
        parts.append(f"waiting on {tuple(w)!r}")
    return ", ".join(parts)


def progress_snapshot(**ids) -> dict:
    """One process's COLL_PROGRESS reply body: group membership,
    in-flight op watermarks, recently completed ops, the recent event
    ring (bounded), and per-in-flight-op sent/delivered key lists for
    the lost-chunk cross-reference. ``ids`` carries identity tags."""
    with _lock:
        groups = [{"group": gk[0], "epoch": gk[1], **info}
                  for gk, info in _groups.items()]
        inflight = [_shape_op(rec) for rec in _inflight.values()]
        done = [_shape_op(rec) for rec in list(_done)[-64:]]
        live_keys = {(rec["group"], rec["key"])
                     for rec in _inflight.values()}
    # ring scan outside the lock: slots hold immutable tuples, and a
    # torn read across an overwrite just drops one event
    events = [e for e in _ring if e is not None]
    events.sort(key=lambda e: e[0])
    sent_keys: Dict[int, List[list]] = {}
    delivered_keys: Dict[int, List[list]] = {}
    okey_index = {k: i for i, k in enumerate(live_keys)}
    # NEWEST events first: the key a stuck receiver is blocked on pairs
    # with a sender's most RECENT sends, so when an op has issued more
    # than the per-op cap the tail — not the head — must survive
    for ev in reversed(events):
        if ev[1] not in (EV_SEND, EV_DELIVER):
            continue
        okey, _phase = parse_key(ev[2])
        idx = okey_index.get(okey)
        if idx is None:
            continue
        bucket = sent_keys if ev[1] == EV_SEND else delivered_keys
        lst = bucket.setdefault(idx, [])
        if len(lst) < _SNAP_KEYS_PER_OP:
            lst.append(_key_list(ev[2]))
    recent = [{"ts": e[0], "kind": e[1], "key": _key_list(e[2]),
               "info": _key_list(e[3]) if isinstance(e[3], tuple)
               else e[3],
               "extra": list(e[4:])} for e in events[-_SNAP_RING_EVENTS:]]
    return {"now": time.time(), "groups": groups, "inflight": inflight,
            "done": done, "recent": recent,
            "op_keys": [[g, _key_list(k)] for (g, k) in okey_index],
            "sent_keys": sent_keys, "delivered_keys": delivered_keys,
            **ids}


def reset() -> None:
    """Session teardown: the next init() must not inherit this session's
    records (the timeline golden test depends on a clean ring)."""
    global _ring
    with _lock:
        _ring = []
        _groups.clear()
        _inflight.clear()
        _done.clear()


# ------------------------------------------------------------- diagnosis

def _op_sort_key(okey) -> tuple:
    return (0, okey) if isinstance(okey, int) else (1, str(okey))


def diagnose(per_node: Dict[str, Any]) -> dict:
    """Cluster-wide hang diagnosis over every rank's progress snapshot
    (``per_node``: node hex -> [snapshot, ...] as collected by
    ``node.collective_health``). For each op some rank is still inside,
    name the verdict, most specific first:

    1. **dead_rank** — a member rank whose process answered nothing
       (no snapshot claims that rank of that group: SIGKILLed worker,
       closed endpoint conn, dead node).
    2. **lost_chunk** — a receiver has been blocked on a key some
       sender logged sending (and the receiver never logged a deliver):
       the edge src->dst dropped it.
    3. **lagging_rank** — the rank with the lowest watermark: hasn't
       started the op at all, or has consumed the fewest chunks.
    """
    snaps: List[dict] = []
    for dumps in (per_node or {}).values():
        for s in dumps or []:
            if isinstance(s, dict):
                snaps.append(s)

    present: Dict[tuple, set] = {}        # (group, epoch) -> ranks replied
    worlds: Dict[tuple, int] = {}
    endpoints: Dict[tuple, Any] = {}
    for s in snaps:
        for g in s.get("groups", ()):
            gk = (g["group"], g["epoch"])
            present.setdefault(gk, set()).add(g["rank"])
            worlds[gk] = max(worlds.get(gk, 0), g.get("world", 0))
            if g.get("endpoints"):
                endpoints[gk] = g["endpoints"]

    # (group, epoch, okey) -> {rank: (state, record)}, plus two key
    # indexes for the lost-chunk cross-reference: mailbox key -> ranks
    # that logged sending it / ranks whose reader logged its delivery
    ops: Dict[tuple, Dict[int, tuple]] = {}
    sender_of: Dict[tuple, List[int]] = {}
    delivered_to: Dict[tuple, set] = {}
    for s in snaps:
        for rec in s.get("inflight", ()):
            k = (rec["group"], rec["epoch"], _key_tuple(rec["key"]))
            ops.setdefault(k, {})[rec["rank"]] = ("inflight", rec)
        for rec in s.get("done", ()):
            k = (rec["group"], rec["epoch"], _key_tuple(rec["key"]))
            ops.setdefault(k, {}).setdefault(rec["rank"], ("done", rec))
        group_rank = {g["group"]: g["rank"] for g in s.get("groups", ())}
        op_keys = [(g, _key_tuple(k)) for g, k in s.get("op_keys", ())]

        def ranks_for(index_table, out, s_ranks=group_rank,
                      s_keys=op_keys):
            for idx, keys in (index_table or {}).items():
                idx = int(idx)
                if idx >= len(s_keys):
                    continue
                rank = s_ranks.get(s_keys[idx][0], -1)
                for key in keys:
                    out(_key_tuple(key), rank)

        ranks_for(s.get("sent_keys"),
                  lambda k, r: sender_of.setdefault(k, []).append(r))
        ranks_for(s.get("delivered_keys"),
                  lambda k, r: delivered_to.setdefault(k, set()).add(r))

    now = max([s.get("now", 0.0) for s in snaps], default=time.time())
    shaped_ops: List[dict] = []
    verdicts: List[dict] = []
    for (group, epoch, okey), by_rank in sorted(
            ops.items(), key=lambda kv: (kv[0][0],
                                         _op_sort_key(kv[0][2]))):
        stuck = {r: rec for r, (st, rec) in by_rank.items()
                 if st == "inflight"}
        sample = next(iter(by_rank.values()))[1]
        world = worlds.get((group, epoch)) or sample.get("world", 0)
        op_row = {
            "group": group, "epoch": epoch,
            "seq": okey if isinstance(okey, int) else list(okey),
            "op": sample.get("op"), "algo": sample.get("algo"),
            "nbytes": sample.get("nbytes"), "world": world,
            "done_ranks": sorted(r for r, (st, _rec)
                                 in by_rank.items() if st == "done"),
            "stuck_ranks": {r: watermark(rec)
                            for r, rec in sorted(stuck.items())},
        }
        shaped_ops.append(op_row)
        if not stuck:
            continue
        label = (f"collective {sample.get('op')!r} group={group!r} "
                 f"seq={op_row['seq']} ({sample.get('algo')}, "
                 f"{len(op_row['done_ranks'])}/{world} ranks finished)")
        member_ranks = set(range(world)) if world else set(by_rank)
        replied = present.get((group, epoch), set())
        dead = sorted(member_ranks - replied)
        verdict: Optional[dict] = None
        if dead:
            eps = endpoints.get((group, epoch))
            where = ""
            if eps and dead[0] < len(eps) and eps[dead[0]]:
                where = (f" (endpoint node={eps[dead[0]][0]} "
                         f"worker={eps[dead[0]][1]} answered nothing — "
                         "process dead or connection closed)")
            verdict = {"verdict": "dead_rank", "rank": dead[0],
                       "message": f"{label}: dead rank {dead[0]}{where}; "
                                  "survivors are parked at "
                                  + "; ".join(
                                      f"rank {r}: {w}" for r, w in
                                      op_row["stuck_ranks"].items())}
        if verdict is None:
            # lost chunk: a stuck receiver waits on a key somebody
            # logged SENDING whose delivery the receiver's own reader
            # never logged — a key merely in flight (delivered after
            # the receiver's snapshot instant) is not lost
            for r, rec in sorted(stuck.items()):
                wkey = _key_tuple(rec.get("waiting"))
                since = rec.get("waiting_since") or 0.0
                if wkey is None or now - since < 1.0:
                    continue
                if r in delivered_to.get(wkey, ()):
                    continue
                senders = [s for s in sender_of.get(wkey, ()) if s != r]
                if senders:
                    verdict = {
                        "verdict": "lost_chunk", "rank": r,
                        "message": (f"{label}: lost chunk on edge "
                                    f"rank {senders[0]} -> rank {r} — "
                                    f"sender logged the send of "
                                    f"{wkey!r} but rank {r} never saw "
                                    "the delivery")}
                    break
        if verdict is None:
            not_started = sorted(r for r in (member_ranks & replied)
                                 if r not in by_rank)
            if not_started:
                lag = not_started[0]
                verdict = {"verdict": "lagging_rank", "rank": lag,
                           "message": (f"{label}: lagging rank {lag} — "
                                       "it has not entered this "
                                       "collective yet; peers are at "
                                       + "; ".join(
                                           f"rank {r}: {w}" for r, w in
                                           op_row["stuck_ranks"].items()))}
            else:
                lag, lag_rec = min(
                    stuck.items(),
                    key=lambda kv: (kv[1].get("recv", 0)
                                    + kv[1].get("sent", 0)))
                verdict = {"verdict": "lagging_rank", "rank": lag,
                           "message": (f"{label}: lagging rank {lag} "
                                       f"({watermark(lag_rec)})")}
        verdict.update({"group": group, "epoch": epoch,
                        "seq": op_row["seq"], "op": sample.get("op"),
                        "phase": next(
                            (rec.get("last_phase") or "start"
                             for rec in stuck.values()), "start")})
        verdicts.append(verdict)
    members = [{"group": g["group"], "epoch": g["epoch"],
                "rank": g["rank"], "worker_id": s.get("worker_id")}
               for s in snaps for g in s.get("groups", ())]
    return {"ops": shaped_ops, "verdicts": verdicts,
            "members": members, "processes": len(snaps)}
