"""Host-level collective communication: peer-to-peer pipelined rings.

API mirrors the reference's ``util/collective/collective.py:258-615``
(allreduce/allgather/reducescatter/broadcast/send/recv/barrier, group
init by world_size+rank+group_name). Where the reference backs these
with NCCL/Gloo process groups, here the data plane is the node-plane
zero-copy transport (``_private/coll_transport.py``): ranks exchange
tensor chunks peer to peer as out-of-band pickle-5 iovecs, and
completion is driven by connection reader threads waking condition
variables — no polling anywhere on the data path.

Algorithms (reference model: "The Big Send-off" / bandwidth-optimal
collective schedules, EQuARX block-quantized allreduce):

- **ring allreduce** = reduce-scatter + allgather over the rank ring,
  tensors split into ``collective_chunk_bytes`` chunks so chunk k+1
  transmits while chunk k reduces; per-rank wire traffic is
  ~2x tensor size, independent of world size.
- **ring reduce-scatter / allgather** reuse the two ring phases.
- **binomial-tree broadcast** (chunk-pipelined down the tree) and a
  small-payload **tree allreduce** below
  ``collective_tree_threshold_bytes`` (latency-bound regime: 2·log2(w)
  hops beat a 2·(w-1)-step ring).
- **hierarchical two-level schedules** on multi-node groups with
  co-located ranks: intra-node reduce to one elected leader per node
  (those hops ride the same-host fast path) -> inter-node ring among
  the leaders only -> intra-node broadcast, so cross-wire traffic is
  ~1/ranks-per-node of a flat ring's.
- **block-quantized wire format** (``collective_wire_dtype`` = exact |
  bf16 | int8-blockscale): inter-node hops of hierarchical REDUCTIONS
  dequantize -> reduce -> requantize per hop, trading bounded
  max-abs error for 2-4x wire reduction; intra-node hops and ops that
  relay caller bytes verbatim (broadcast/allgather/send/recv) always
  stay exact, and the reduce order stays deterministic, so every rank
  still returns bit-identical bytes.
- **send/recv** are direct rank-to-rank mailbox messages.

Every public op picks its schedule through ONE table —
``_select_schedule(op, nbytes, world, nodes, dtype)`` — overridable
with ``collective_algo``; choices are observable via
``rtpu_collective_algo_total{algo,op}``.

The named ``_Coordinator`` actor is control plane only: group
membership, rank -> endpoint exchange, epoch agreement — plus a
degenerate fallback data path (``collective_p2p_enabled=False`` or a
rank with no runtime endpoint) that reduces by streaming pairwise
accumulation on waiter futures (O(size) peak memory, no polling).

**Self-healing**: a call that fails with a
flight-recorder ``dead_rank`` verdict can recover instead of killing
the group — survivors fence the failing epoch
(``coll_transport.fence``), re-join through the coordinator's reform
round under a fresh epoch (``collective_reform_mode`` = replace |
shrink), and the fault-tolerant wrappers (``ft_allreduce`` /
``FaultTolerantGroup`` / ``ft_collective``) re-issue the failed op.
Restarted checkpointable actors re-enter with their old rank via
``ensure_collective_group``. See DESIGN.md "Collective self-healing".

**Torch tensors.** Every op takes numpy arrays or torch tensors (CPU or
CUDA, strided ones included; torch is found through ``sys.modules`` and
never imported here). A tensor enters as a C-contiguous host copy (a CUDA
tensor through one device-to-host copy), the schedules run on numpy, and
a caller that passed a tensor gets tensors back with its dtype on its
tensor's device (``allgather``: each part). ``recv`` has no input: it
returns a CPU tensor of the sent dtype when the sender sent a tensor.
bf16 travels as its 2-byte bit pattern (the ``_BF16`` dtype, never
upcast) and reduces through ``_binop``: each binary op in float32,
rounded to bf16 nearest-even, a NaN sum or product as the quiet NaN of
its sign, min and max returning an operand's bits — ``ml_dtypes``'
``bfloat16`` ufuncs bit for bit.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import exceptions, get, get_actor
from ..api import remote
from .._private import coll_transport
from .._private import failpoints
from .._private import flight_recorder
from .._private import locksan
from .._private import telemetry
from .._private.config import CONFIG

_GROUP_ACTOR_PREFIX = "rtpu:collective:"

M_COLL_LATENCY = telemetry.define(
    "histogram", "rtpu_collective_latency_seconds",
    "End-to-end latency of one host-level collective call, tagged by "
    "op and group (the communication axis)")
M_COLL_BYTES = telemetry.define(
    "counter", "rtpu_collective_bytes_total",
    "Payload bytes contributed to collectives by this rank")
M_COLL_OPS = telemetry.define(
    "counter", "rtpu_collective_ops_total",
    "Collective calls completed by this rank")
M_COLL_ALGO = telemetry.define(
    "counter", "rtpu_collective_algo_total",
    "Collective calls by the schedule the size x topology x dtype "
    "selector chose (ring/tree/hierarchical/star/local) — makes the "
    "crossover points observable")
M_COLL_QUANT_SAVED = telemetry.define(
    "counter", "rtpu_collective_quantized_bytes_total",
    "Wire bytes SAVED by the block-quantized inter-node format "
    "(original minus encoded payload bytes, summed over quantized hops)")
M_COLL_TIMEOUTS = telemetry.define(
    "counter", "rtpu_collective_timeouts_total",
    "Collective calls that failed with a TimeoutError on this rank "
    "(each one triggers the flight-recorder hang diagnosis)")
M_COLL_REFORMS = telemetry.define(
    "counter", "rtpu_collective_reforms_total",
    "Collective group reforms this rank adopted (a fresh epoch after a "
    "dead-rank verdict), tagged by the reform mode that resolved the "
    "round — replace (a restarted rank re-entered) or shrink (the "
    "world contracted to the survivors)")


class CollectiveTimeoutError(TimeoutError):
    """A collective call's deadline passed. Carries the flight
    recorder's cluster-wide diagnosis so recovery code can act on the
    VERDICT instead of string-matching the message: ``verdicts`` is the
    list of verdict dicts for this group (``dead_rank`` is the one the
    fault-tolerant wrappers reform on)."""

    def __init__(self, message: str, group: str = "",
                 verdicts: Optional[List[dict]] = None):
        super().__init__(message)
        self.group = group
        self.verdicts = list(verdicts or ())

    def dead_ranks(self) -> List[int]:
        return [v["rank"] for v in self.verdicts
                if v.get("verdict") == "dead_rank"]


def _observe(op: str, group: str, nbytes: int, t0: float) -> None:
    tags = (("group", group), ("op", op))
    telemetry.counter_inc(M_COLL_OPS, 1.0, tags)
    if nbytes:
        telemetry.counter_inc(M_COLL_BYTES, float(nbytes), tags)
    telemetry.hist_observe(M_COLL_LATENCY, time.monotonic() - t0, tags)


def _observe_algo(op: str, algo: str) -> None:
    telemetry.counter_inc(M_COLL_ALGO, 1.0, (("algo", algo), ("op", op)))

# ops
SUM = "sum"
PROD = "prod"
MIN = "min"
MAX = "max"

# binary ufuncs: streaming pairwise accumulation keeps peak memory at
# O(size) (the seed's np.stack over world_size arrays was O(world*size))
# and, unlike np.sum's axis reduction, never promotes the dtype
_BINARY = {SUM: np.add, PROD: np.multiply, MIN: np.minimum, MAX: np.maximum}

# bf16 as its bit pattern: a one-field structured dtype, so that it keeps
# its identity through slicing, pickling and the wire, and so that
# numpy's own ufuncs refuse it (only ``_binop`` reduces it)
_BF16 = np.dtype([("bf16", "<u2")])


def _bf16_round(x32: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, nearest-even, as ``ml_dtypes`` rounds:
    a NaN becomes the quiet NaN of its sign (``_bf16_encode``'s carry
    would turn a NaN payload into inf or wrap it to zero)."""
    bits = _bf16_encode(x32)
    nan = np.isnan(x32)
    if nan.any():
        sign = (x32[nan].view(np.uint32) >> 16).astype(np.uint16) & 0x8000
        bits[nan] = sign | 0x7FC0
    return bits


def _bf16_binop(ufunc, arithmetic: bool):
    def binop(a, b, out=None):
        x = ufunc(_bf16_decode(np.asarray(a).view(np.uint16)),
                  _bf16_decode(np.asarray(b).view(np.uint16)))
        # min/max return one operand, whose bits decode and re-encode
        # exactly (NaN payloads included)
        bits = (_bf16_round(x) if arithmetic
                else (x.view(np.uint32) >> 16).astype(np.uint16))
        if out is None:
            return bits.view(_BF16)
        out.view(np.uint16)[...] = bits
        return out
    return binop


def _binop(op: str, dtype):
    """The pairwise reduction of ``op`` for arrays of ``dtype``: numpy's
    ufunc, or for ``_BF16`` the same op computed in float32 and rounded
    to bf16."""
    if dtype == _BF16:
        return _BF16_BINARY[op]
    return _BINARY[op]


# ------------------------------------------- block-quantized wire format
#
# EQuARX-style precision/bandwidth trade on the hops that actually cross
# a wire: inter-node legs of hierarchical REDUCTIONS encode each chunk
# to bf16 or per-block-scaled int8 before it enters the transport's OOB
# frames, and the receiving rank thread dequantizes after the mailbox
# wait (reader threads stay lean — rule 4 of the threading model). Ops
# that relay caller bytes verbatim (broadcast/allgather/send/recv) and
# every intra-node hop are never quantized.

_WIRE_DTYPES = ("exact", "bf16", "int8-blockscale")


class QuantChunk:
    """Wire form of one quantized chunk — self-describing, so a receiver
    needs no schedule context to decode. ``q`` (the bf16 bit pattern or
    the int8 mantissas) rides out-of-band like plain ndarray chunks;
    ``scales`` is None for bf16. ``dtype`` is the ORIGINAL dtype the
    decoder restores (reduction then proceeds in that dtype, keeping
    the deterministic reduce order of the exact schedules)."""

    __slots__ = ("mode", "dtype", "q", "scales")

    def __init__(self, mode: str, dtype: str, q, scales=None):
        self.mode = mode
        self.dtype = dtype
        self.q = q
        self.scales = scales

    @property
    def nbytes(self) -> int:
        # also consulted by the transport's _est_size so chunk bursts
        # don't over-coalesce into one giant BATCH frame
        n = int(self.q.nbytes)
        if self.scales is not None:
            n += int(self.scales.nbytes)
        return n


def _bf16_encode(x32: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit pattern (uint16), round-to-nearest-even
    (numpy has no native bfloat16; the bit trick is exact)."""
    u = x32.view(np.uint32)
    return (((u + 0x7FFF + ((u >> 16) & 1)) >> 16)).astype(np.uint16)


def _bf16_decode(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


_BF16_BINARY = {SUM: _bf16_binop(np.add, True),
                PROD: _bf16_binop(np.multiply, True),
                MIN: _bf16_binop(np.minimum, False),
                MAX: _bf16_binop(np.maximum, False)}


def _q8_block_counts(n: int, block: int) -> Tuple[np.ndarray, np.ndarray]:
    idx = np.arange(0, n, block, dtype=np.int64)
    counts = np.full(idx.size, block, dtype=np.int64)
    counts[-1] = n - idx[-1]
    return idx, counts


class _WireCodec:
    """Encoder/decoder for the inter-node hops of one collective call.

    ``encode`` is the identity for exact mode, non-float dtypes
    (integer reductions must stay exact) and empty chunks; ``decode``
    of a plain ndarray is the identity, so exact and quantized traffic
    can share one schedule. ``saved`` accumulates original-minus-
    encoded bytes for the wire-savings counter."""

    def __init__(self, mode: str, block: int):
        if mode not in _WIRE_DTYPES:
            raise ValueError(
                f"collective_wire_dtype must be one of {_WIRE_DTYPES}, "
                f"got {mode!r}")
        self.mode = mode
        self.block = max(1, int(block))
        self.saved = 0

    @property
    def active(self) -> bool:
        return self.mode != "exact"

    def encode(self, arr):
        arr = np.ascontiguousarray(arr)
        if not self.active or arr.dtype.kind != "f" or arr.size == 0:
            return arr
        x32 = np.ascontiguousarray(
            arr.astype(np.float32, copy=False).reshape(-1))
        if not np.isfinite(x32).all():
            # non-finite values don't survive either format (an inf
            # poisons its whole int8 block's scale to NaN, NaN rounds
            # to 0, negative-NaN bit patterns wrap the bf16 add): ship
            # this chunk exact so a diverging gradient propagates
            # faithfully instead of being silently masked
            return arr
        if self.mode == "bf16":
            out = QuantChunk("bf16", arr.dtype.str, _bf16_encode(x32))
        else:
            idx, counts = _q8_block_counts(x32.size, self.block)
            absmax = np.maximum.reduceat(np.abs(x32), idx)
            scales = (absmax / 127.0).astype(np.float32)
            # an all-zero block quantizes through scale 1 (q is all 0);
            # the stored scale keeps the true value so decode stays 0
            safe = np.where(scales > 0, scales, np.float32(1.0))
            q = np.clip(np.rint(x32 / np.repeat(safe, counts)),
                        -127, 127).astype(np.int8)
            out = QuantChunk("int8-blockscale", arr.dtype.str, q, scales)
        self.saved += max(0, int(arr.nbytes) - out.nbytes)
        return out

    def decode(self, payload) -> np.ndarray:
        if not isinstance(payload, QuantChunk):
            return np.asarray(payload)
        if payload.mode == "bf16":
            x32 = _bf16_decode(payload.q)
        else:
            _idx, counts = _q8_block_counts(payload.q.size, self.block)
            safe = np.where(payload.scales > 0, payload.scales,
                            np.float32(1.0))
            x32 = payload.q.astype(np.float32) * np.repeat(safe, counts)
        return x32.astype(np.dtype(payload.dtype), copy=False)

    def roundtrip(self, arr: np.ndarray) -> np.ndarray:
        """encode -> decode without sending: a segment's OWNER must end
        up holding exactly the bytes every receiver will decode, or the
        ranks diverge bit-wise."""
        if not self.active:
            return arr
        return self.decode(self.encode(arr))


def _make_codec() -> _WireCodec:
    return _WireCodec(CONFIG.collective_wire_dtype,
                      CONFIG.collective_quant_block_elems)


def _observe_quant(codec: Optional[_WireCodec], op: str,
                   group: str) -> None:
    if codec is not None and codec.saved:
        telemetry.counter_inc(M_COLL_QUANT_SAVED, float(codec.saved),
                              (("group", group), ("op", op)))


# ------------------------------------------------- algorithm selection

_ALGO_CHOICES = ("auto", "ring", "tree", "hierarchical", "star")

# which schedules each op can run; a forced/selected algo outside the
# mask degrades to the op's bandwidth schedule (barrier has no payload,
# so topology never matters to it)
_ALGO_CAPS = {
    "allreduce": ("ring", "tree", "hierarchical", "star"),
    "reducescatter": ("ring", "hierarchical", "star"),
    "allgather": ("ring", "hierarchical", "star"),
    "broadcast": ("tree", "hierarchical", "star"),
    "barrier": ("tree", "star"),
}


def _select_schedule(op: str, nbytes: int, world: int, nodes: int,
                     dtype) -> str:
    """The size x topology x dtype selection table. Pure function of
    its arguments plus CONFIG (``collective_algo`` forces a schedule,
    ``collective_tree_threshold_bytes`` and
    ``collective_hierarchical_threshold_bytes`` set the crossovers).

    - latency-bound sizes (below the tree threshold) -> binomial tree;
    - multi-node topologies with co-located ranks (world > nodes > 1)
      and bandwidth-bound sizes -> hierarchical two-level (the
      threshold halves for float payloads when a quantized wire dtype
      is configured: cheaper inter-node bytes amortize the intra-node
      staging hops sooner);
    - everything else -> flat ring (broadcast's bandwidth schedule is
      the chunk-pipelined tree).
    """
    caps = _ALGO_CAPS[op]
    fallback = "ring" if "ring" in caps else "tree"
    forced = CONFIG.collective_algo
    if forced != "auto":
        if forced not in _ALGO_CHOICES:
            raise ValueError(
                f"collective_algo must be one of {_ALGO_CHOICES}, "
                f"got {forced!r}")
        return forced if forced in caps else fallback
    if op == "barrier":
        return "tree"
    multi_node = nodes > 1 and world > nodes
    if op in ("allgather", "broadcast"):
        # topology-only: per-rank payload sizes may differ (allgather)
        # or be unknown off-source (broadcast), and every rank MUST
        # derive the same schedule from the same shared data — a
        # size-keyed rule would let ranks diverge and deadlock
        return "hierarchical" if multi_node else fallback
    if nbytes < CONFIG.collective_tree_threshold_bytes and "tree" in caps:
        return "tree"
    if "hierarchical" in caps and multi_node:
        threshold = CONFIG.collective_hierarchical_threshold_bytes
        if (CONFIG.collective_wire_dtype != "exact"
                and getattr(dtype, "kind", "") == "f"):
            threshold //= 2
        if nbytes >= threshold:
            return "hierarchical"
    return fallback


class _CoordinatorImpl:
    """Control plane of one collective group (async actor).

    Owns membership (rank -> endpoint exchange under a fresh group
    epoch) and the degenerate fallback data path. Every blocking call
    awaits an ``asyncio.Event`` resolved by the completing member —
    callers block on the actor reply, never on a poll loop. Call
    records a timed-out rank abandoned (and mailbox posts never taken)
    are swept once they outlive ``ttl_s``.
    """

    def __init__(self, world_size: int, ttl_s: Optional[float] = None):
        self.world_size = world_size
        self.epoch = os.urandom(8).hex()
        self.ttl_s = float(ttl_s if ttl_s is not None
                           else CONFIG.collective_call_ttl_s)
        self._endpoints: Dict[int, Any] = {}
        self._join_ev = asyncio.Event()
        self._calls: Dict[tuple, dict] = {}
        self._mail: Dict[tuple, tuple] = {}          # key -> (value, born)
        self._mail_evs: Dict[tuple, asyncio.Event] = {}
        # reform state: at most one open round (superseding self.epoch)
        # plus a bounded cache of resolved rounds keyed by the epoch
        # they superseded, so a slow survivor that calls reform() after
        # the round resolved still adopts the same result. Once any
        # round RENUMBERS ranks (a shrink that dropped members), old
        # rank ids stop naming members — re-entry by stale rank id is
        # refused from then on.
        self._reform: Optional[dict] = None
        self._reform_results: Dict[str, dict] = {}
        self._renumbered = False
        # set when a SURVIVOR of an established epoch talks to this
        # (freshly restarted, empty) coordinator: the group exists even
        # though no join ever ran here — join-delegation must stop, but
        # _join_ev must NOT be set (that would wake parked joiners into
        # a partial, endpoint-less membership)
        self._established = False

    def ping(self) -> bool:
        return True

    def debug_counts(self) -> Dict[str, int]:
        """Test surface: live fallback-call records and mailbox posts."""
        self._sweep()
        return {"calls": len(self._calls), "mail": len(self._mail)}

    def _sweep(self) -> None:
        """Drop records older than the TTL: a rank that timed out of a
        rendezvous leaves a partial record behind, and an un-taken post
        has no reader — neither may live forever."""
        now = time.monotonic()
        for key, rec in list(self._calls.items()):
            if now - rec["born"] > self.ttl_s:
                rec["expired"] = True
                rec["ev"].set()
                del self._calls[key]
        for key, (_value, born) in list(self._mail.items()):
            if now - born > self.ttl_s:
                del self._mail[key]

    # ------------------------------------------------------- membership
    async def join(self, rank: int, endpoint, timeout_s: float):
        """Register this rank's endpoint; resolves for everyone once
        all world_size ranks arrived. Returns (epoch, endpoints)."""
        self._endpoints[rank] = (tuple(endpoint) if endpoint is not None
                                 else None)
        if len(self._endpoints) >= self.world_size:
            self._join_ev.set()
        else:
            try:
                await asyncio.wait_for(self._join_ev.wait(), timeout_s)
            except asyncio.TimeoutError:
                missing = [r for r in range(self.world_size)
                           if r not in self._endpoints]
                return ("timeout",
                        f"ranks {missing} never joined the group")
        eps = [self._endpoints.get(r) for r in range(self.world_size)]
        return ("ok", (self.epoch, eps))

    # ------------------------------------------------------------ reform
    #
    # Self-healing membership: after a dead-rank verdict, every survivor
    # fences the failing epoch locally and calls ``reform``; a restarted
    # replacement rank calls it too (``from_epoch`` None — it has no
    # process state). The round resolves under a FRESH epoch either when
    # all world_size ranks re-arrived (``replace`` — the restarted rank
    # re-enters with its old rank) or, in ``shrink`` mode, once no new
    # rank has arrived for ``grace_s`` — the world contracts to the
    # survivors, renumbered contiguously in old-rank order. Stale
    # fallback-path records and mail are cleared at resolution (their
    # keys don't all carry the epoch — this IS their fence).

    async def reform(self, rank: int, endpoint, from_epoch: Optional[str],
                     mode: str, timeout_s: float, grace_s: float,
                     world: Optional[int] = None):
        """Join the reform round superseding ``from_epoch`` (None = the
        current epoch, for ranks whose process state died with them).
        ``world`` is the CALLER's view of the group size — a restarted
        (empty) coordinator adopts it from the first surviving caller,
        since its __init__ args may predate shrink reforms. Returns
        ("ok", {epoch, world, rank, endpoints, reformed})."""
        cached = (self._reform_results.get(from_epoch)
                  if from_epoch is not None else None)
        if cached is not None:
            return self._reform_reply(cached, rank)
        if (from_epoch is not None and not self._established
                and not self._join_ev.is_set()):
            # a survivor of an ESTABLISHED epoch is talking to a
            # freshly restarted coordinator: the group exists — don't
            # fall into the initial-join path (whose world may be the
            # pre-shrink __init__ value); adopt the survivor's view.
            # NOT via _join_ev: setting that would wake a parked
            # joiner (a restarted rank that raced ahead of us) into a
            # partial, endpoint-less membership — it must instead time
            # out of its join and retry into the round below.
            if world:
                self.world_size = int(world)
            self._established = True
        if from_epoch is None and (self._renumbered
                                   or rank >= self.world_size):
            # a restarted rank re-entering AFTER a shrink round
            # renumbered the members: its OLD rank id either fell off
            # the end or now aliases a renumbered survivor — admitting
            # it would put two processes behind one rank's mailbox keys
            return ("timeout",
                    f"rank {rank} is not a member of the current group "
                    f"(world {self.world_size}; ranks were renumbered "
                    "by a shrink reform); re-initialize or restart the "
                    "whole group to re-admit it")
        if not self._join_ev.is_set() and not self._established:
            # initial formation still open: a (re-)joiner is a joiner —
            # this also covers a RESTARTED coordinator (empty state):
            # every rank's idempotent re-join rebuilds membership and
            # resolves under this incarnation's fresh epoch
            status, res = await self.join(rank, endpoint, timeout_s)
            if status != "ok":
                return (status, res)
            epoch, eps = res
            return ("ok", {"epoch": epoch, "world": self.world_size,
                           "rank": rank, "endpoints": eps,
                           "reformed": False})
        rec = self._reform
        if rec is None:
            rec = self._reform = {
                "arrived": {}, "mode": mode, "from_epoch": self.epoch,
                "last_arrival": time.monotonic(), "result": None,
                "survivor_seen": False, "ev": asyncio.Event()}
        if rank not in rec["arrived"]:
            rec["last_arrival"] = time.monotonic()
        # latest arrival's mode wins: a round opened in replace mode
        # that timed out (the replacement never came) must honor a
        # retry made after the operator switched to shrink — freezing
        # the opener's mode would make the advertised escape hatch
        # ("set collective_reform_mode=shrink") a no-op
        rec["mode"] = mode
        if from_epoch is not None:
            # a SURVIVOR (it names the epoch it watched fail) is in the
            # round: only then may shrink-quiescence resolve it. A lone
            # restarted rank (from_epoch None) waiting for survivors
            # that haven't failed yet must never shrink the live group
            # down to a world of itself.
            rec["survivor_seen"] = True
        rec["arrived"][rank] = (tuple(endpoint) if endpoint is not None
                                else None)
        if len(rec["arrived"]) >= self.world_size:
            self._resolve_reform(rec)
        rec["waiters"] = rec.get("waiters", 0) + 1
        try:
            deadline = time.monotonic() + timeout_s
            while rec["result"] is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted(set(range(self.world_size))
                                     - set(rec["arrived"]))
                    return ("timeout",
                            f"group reform: ranks {missing} never "
                            f"re-joined within {timeout_s:.0f}s "
                            "(replace mode waits for a restarted "
                            "replacement rank; set "
                            "collective_reform_mode=shrink to proceed "
                            "without them)")
                wait = remaining
                if rec["mode"] == "shrink" and rec["survivor_seen"]:
                    # grace runs from the LAST arrival: a trickle of
                    # stragglers keeps the round open, quiescence
                    # closes it
                    grace_left = (rec["last_arrival"] + grace_s
                                  - time.monotonic())
                    if grace_left <= 0:
                        self._resolve_reform(rec)
                        break
                    wait = min(wait, grace_left)
                try:
                    await asyncio.wait_for(rec["ev"].wait(), wait)
                except asyncio.TimeoutError:
                    pass
            return self._reform_reply(rec["result"], rank)
        finally:
            rec["waiters"] -= 1
            if (rec["waiters"] <= 0 and rec["result"] is None
                    and self._reform is rec):
                # every waiter abandoned an unresolved round: discard
                # it — its arrivals are stale endpoints, and a later
                # lone re-joiner must not inherit its survivor_seen
                # flag and shrink the live group around ghost members
                self._reform = None

    def _resolve_reform(self, rec: dict) -> None:
        if rec["result"] is not None:
            return
        old_ranks = sorted(rec["arrived"])
        result = {"epoch": os.urandom(8).hex(), "world": len(old_ranks),
                  "ranks": {old: new for new, old in enumerate(old_ranks)},
                  "endpoints": [rec["arrived"][o] for o in old_ranks],
                  "reformed": True}
        rec["result"] = result
        self._reform_results[rec["from_epoch"]] = result
        while len(self._reform_results) > 8:
            self._reform_results.pop(next(iter(self._reform_results)))
        if any(old != new for old, new in result["ranks"].items()):
            self._renumbered = True
        self.epoch = result["epoch"]
        self.world_size = result["world"]
        self._endpoints = {new: rec["arrived"][old]
                           for old, new in result["ranks"].items()}
        # fence the fallback data path: rendezvous records and mailbox
        # posts of the superseded epoch must never satisfy a new-epoch
        # call (mail keys don't carry the epoch — clearing here is
        # their only fence)
        self._calls.clear()
        self._mail.clear()
        self._reform = None
        rec["ev"].set()

    @staticmethod
    def _reform_reply(result: dict, rank: int):
        new_rank = result["ranks"].get(rank)
        if new_rank is None:
            return ("timeout",
                    f"rank {rank} is not a member of the reformed group "
                    "(it missed the shrink-mode round); re-initialize "
                    "or restart the whole group to re-admit it")
        return ("ok", {"epoch": result["epoch"],
                       "world": result["world"], "rank": new_rank,
                       "endpoints": result["endpoints"],
                       "reformed": True})

    # ------------------------------------------- fallback data path
    def _call(self, key) -> dict:
        rec = self._calls.get(key)
        if rec is None:
            rec = {"count": 0, "acc": None, "parts": {}, "result": None,
                   "done": False, "taken": 0, "expired": False,
                   "born": time.monotonic(), "ev": asyncio.Event()}
            self._calls[key] = rec
        return rec

    async def rendezvous(self, key, rank: int, value, op: Optional[str],
                         timeout_s: float):
        """Blocking rendezvous: contribution ``world_size`` resolves the
        waiters. ``op`` None gathers parts (allgather/broadcast/barrier);
        otherwise the reduction accumulates pairwise as values arrive."""
        self._sweep()
        rec = self._call(key)
        if op is None:
            # copy: the deserialized view may alias a store segment that
            # is unpinned once this call returns
            rec["parts"][rank] = (np.array(value)
                                  if isinstance(value, np.ndarray)
                                  else value)
        else:
            v = np.asarray(value)
            rec["acc"] = (np.array(v) if rec["acc"] is None
                          else _binop(op, v.dtype)(rec["acc"], v))
        rec["count"] += 1
        if rec["count"] >= self.world_size:
            rec["result"] = (rec["acc"] if op is not None else
                             [rec["parts"].get(r)
                              for r in range(self.world_size)])
            rec["done"] = True
            rec["ev"].set()
        elif not rec["done"]:
            try:
                await asyncio.wait_for(rec["ev"].wait(), timeout_s)
            except asyncio.TimeoutError:
                # leave the partial record for the TTL sweep
                return ("timeout",
                        f"{rec['count']}/{self.world_size} ranks arrived")
        if rec["expired"]:
            return ("timeout", "call record expired (TTL sweep)")
        rec["taken"] += 1
        if rec["taken"] >= self.world_size:
            self._calls.pop(key, None)
        return ("ok", rec["result"])

    async def post(self, dst_rank: int, tag, value) -> None:
        self._sweep()
        key = (dst_rank, tuple(tag))
        if isinstance(value, _TensorPayload):
            value = _TensorPayload(np.array(value.arr))
        self._mail[key] = (np.array(value)
                           if isinstance(value, np.ndarray) else value,
                           time.monotonic())
        ev = self._mail_evs.get(key)
        if ev is not None:
            ev.set()

    async def take(self, dst_rank: int, tag, timeout_s: float):
        self._sweep()
        key = (dst_rank, tuple(tag))
        if key not in self._mail:
            ev = self._mail_evs.get(key)
            if ev is None:
                ev = self._mail_evs[key] = asyncio.Event()
            try:
                await asyncio.wait_for(ev.wait(), timeout_s)
            except asyncio.TimeoutError:
                return ("timeout", f"no message for tag {tag}")
            finally:
                self._mail_evs.pop(key, None)
        if key not in self._mail:            # raced the TTL sweep
            return ("timeout", "message expired (TTL sweep)")
        value, _born = self._mail.pop(key)
        return ("ok", value)


# Restart budget: a SIGKILLed/OOM-killed coordinator comes back (same
# actor id, fresh empty state) and the idempotent re-join paths rebuild
# membership under its new epoch — joiners retry on ActorDiedError
# instead of stranding until the collective timeout (see _coord_call).
_COORDINATOR_MAX_RESTARTS = 3
_Coordinator = remote(
    num_cpus=0, max_restarts=_COORDINATOR_MAX_RESTARTS)(_CoordinatorImpl)


class _GroupState:
    def __init__(self, name: str, world_size: int, rank: int, coordinator,
                 epoch: str, endpoints: List[Any]):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.coordinator = coordinator
        self.epoch = epoch
        self.endpoints = endpoints
        # p2p only when every rank published a routable endpoint (all
        # ranks derive this from the same exchanged data, so the whole
        # group agrees on the schedule)
        self.use_p2p = all(ep is not None for ep in endpoints)
        # ------ topology: endpoints carry node identity (endpoint[0] is
        # the owning node's id), so every rank derives the SAME node
        # grouping from the same exchanged data — the hierarchical
        # schedules route on it with no extra control-plane round trip
        self.nodes: List[Any] = []            # node ids, first-rank order
        self.node_ranks: Dict[Any, List[int]] = {}
        if self.use_p2p:
            for r, ep in enumerate(endpoints):
                nid = ep[0]
                if nid not in self.node_ranks:
                    self.nodes.append(nid)
                    self.node_ranks[nid] = []
                self.node_ranks[nid].append(r)
        self.n_nodes = len(self.nodes) if self.use_p2p else 1
        if self.use_p2p:
            my_node = endpoints[rank][0]
            self.local_ranks = self.node_ranks[my_node]   # sorted (scan)
            self.leader = self.local_ranks[0]
            self.leaders = [self.node_ranks[nid][0] for nid in self.nodes]
        else:
            self.local_ranks = [rank]
            self.leader = rank
            self.leaders = [rank]
        # node blocks are contiguous iff concatenating each node's ranks
        # in node order counts 0..w-1 — the precondition for the
        # hierarchical reduce-scatter's per-node segment bounds
        self.node_blocks_contiguous = (
            self.use_p2p
            and sum((self.node_ranks[nid] for nid in self.nodes), [])
            == list(range(world_size)))
        self.seq = 0
        # p2p sequence counters keyed by (peer_rank, tag)
        self.send_seq: Dict[tuple, int] = {}
        self.recv_seq: Dict[tuple, int] = {}

    def next_seq(self) -> int:
        seq = self.seq
        self.seq += 1
        return seq

    def key(self, seq: int) -> tuple:
        return (self.name, self.epoch, seq)


class _SubState:
    """A sub-group view the ring/tree schedule helpers run on unchanged:
    ``members`` (global ranks, same order on every rank — derived from
    the shared endpoint exchange) are remapped to 0..len-1. Used for the
    per-node gang and the leaders-only ring of hierarchical schedules;
    key disambiguation is the caller's job (distinct key prefixes per
    phase, and phase-1/3 messages only ever travel between co-located
    ranks, so equal local indices on different nodes cannot collide)."""

    def __init__(self, state: _GroupState, members: List[int]):
        self.name = state.name
        self.members = members
        self.world_size = len(members)
        self.rank = members.index(state.rank)
        self.endpoints = [state.endpoints[g] for g in members]


# Per-process registry (module-global like the reference's GroupManager,
# ``collective.py:40``; actor methods may run on different threads).
_process_groups: Dict[str, _GroupState] = {}
_groups_lock = locksan.lock("collective.groups")


def _groups() -> Dict[str, _GroupState]:
    return _process_groups


def _coord(state_or_actor, method: str, *args):
    """Call a coordinator method and unwrap its ("ok"|"timeout", x)
    status tuple; "timeout" raises here so every rank surfaces it. A
    dead coordinator surfaces as a clear 'coordinator died' error, not
    a bare actor failure."""
    try:
        res = get(getattr(state_or_actor, method).remote(*args))
    except exceptions.ActorDiedError as exc:
        raise RuntimeError(
            f"collective coordinator actor died mid-{method} (restart "
            f"budget exhausted or killed): {exc}") from exc
    if res[0] != "ok":
        raise TimeoutError(f"collective {method}: {res[1]}")
    return res[1]


def _coord_call(actor, group_name: str, method: str, *args,
                retries: int = _COORDINATOR_MAX_RESTARTS):
    """``_coord`` for the IDEMPOTENT membership ops (join/reform): an
    in-flight call that dies with the coordinator's worker is simply
    re-issued — the restarted coordinator (same actor id, empty state)
    collects the re-joins afresh and resolves under its new epoch. Only
    when the restart budget is exhausted (the actor stays DEAD) does
    the caller get the terminal 'coordinator died' error."""
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            res = get(getattr(actor, method).remote(*args))
        except exceptions.ActorDiedError as exc:
            last = exc
            time.sleep(0.1 * (attempt + 1))
            continue
        if res[0] != "ok":
            raise TimeoutError(f"collective {method}: {res[1]}")
        return res[1]
    raise RuntimeError(
        f"collective group {group_name!r}: coordinator actor died and "
        f"its restart budget ({_COORDINATOR_MAX_RESTARTS}) is exhausted "
        f"— {method} cannot complete: {last}")


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default") -> None:
    """Join a collective group (reference: ``collective.py:120``).

    Call from every member actor/task with a distinct ``rank``. Rank 0
    creates the named coordinator actor; others look it up. All members
    then exchange (rank -> endpoint) through the coordinator, which is
    what the peer-to-peer ring/tree schedules route on.
    """
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    actor_name = _GROUP_ACTOR_PREFIX + group_name
    coordinator = None
    if rank == 0:
        coordinator = _Coordinator.options(name=actor_name).remote(world_size)
        # touch it so registration completes before others look it up
        get(coordinator.ping.remote())
    else:
        deadline = time.monotonic() + 30.0
        while True:                 # control plane (init only): the
            try:                    # data path never polls
                coordinator = get_actor(actor_name)
                break
            except ValueError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"collective group {group_name!r}: coordinator "
                        "never appeared (is rank 0 up?)")
                time.sleep(0.02)
    ep = (coll_transport.local_endpoint()
          if CONFIG.collective_p2p_enabled else None)
    # join is idempotent: a coordinator death mid-join fails every
    # blocked joiner at once, and every one of them re-joins the
    # restarted (empty) coordinator — _coord_call owns the retry
    epoch, endpoints = _coord_call(coordinator, group_name, "join",
                                   rank, ep, CONFIG.collective_timeout_s)
    flight_recorder.register_group(group_name, epoch, rank, world_size,
                                   endpoints)
    with _groups_lock:
        _process_groups[group_name] = _GroupState(
            group_name, world_size, rank, coordinator, epoch, endpoints)


class CollectiveActorMixin:
    """Mix into an actor class to make it driveable by
    ``create_collective_group`` (and get convenience methods)."""

    def _rtpu_init_collective(self, world_size: int, rank: int,
                              group_name: str) -> None:
        init_collective_group(world_size, rank, group_name)

    def _rtpu_destroy_collective(self, group_name: str) -> None:
        destroy_collective_group(group_name)

    def _rtpu_ensure_collective(self, world_size: int, rank: int,
                                group_name: str) -> None:
        """Idempotent (re-)join — what a restarted checkpointable rank
        calls at the top of its step to re-enter with its old rank."""
        ensure_collective_group(world_size, rank, group_name)


def create_collective_group(actors: List[Any], world_size: int,
                            ranks: List[int],
                            group_name: str = "default") -> None:
    """Driver-side declarative setup (reference: ``collective.py:177``):
    instructs each actor to call ``init_collective_group``. Actor classes
    must inherit ``CollectiveActorMixin`` (or expose an equivalent
    ``_rtpu_init_collective`` method).

    Rank 0's init creates the coordinator and later ranks block on its
    appearance, so all members are driven concurrently here.
    """
    if len(actors) != world_size or len(ranks) != world_size:
        raise ValueError(
            f"need exactly world_size={world_size} actors and ranks, got "
            f"{len(actors)} actors / {len(ranks)} ranks")
    if sorted(ranks) != list(range(world_size)):
        raise ValueError(f"ranks must be a permutation of 0..{world_size-1}, "
                         f"got {ranks}")
    refs = []
    for actor, rank in zip(actors, ranks):
        refs.append(actor._rtpu_init_collective.remote(world_size, rank,
                                                       group_name))
    get(refs)


def destroy_collective_group(group_name: str = "default") -> None:
    """GROUP-WIDE teardown (call it from every member, like the
    reference's destroy): the shared coordinator dies with the FIRST
    member's destroy, so this is not a single-rank 'leave' — a member
    that destroys while others still use the group takes their control
    plane with it. Bounded even when a rank (including rank 0) is
    dead: the epoch is fenced — the dead member's stranded mailbox
    chunks are swept now, late stale arrivals refused — and every
    member attempts the coordinator kill (the first wins; killing a
    dead actor, or a PREVIOUS group's coordinator after a same-name
    recreate, no-ops — the kill targets this group's actor id, not the
    name). Rank 0 used to be the only killer, so a group whose rank 0
    died leaked its named coordinator forever and the name could never
    be reused."""
    with _groups_lock:
        state = _process_groups.pop(group_name, None)
    if state is None:
        return
    flight_recorder.unregister_group(state.name, state.epoch)
    # fence subsumes the old drop_group sweep: it deletes the epoch's
    # undelivered chunks AND refuses late arrivals
    coll_transport.fence(state.name, state.epoch)
    from .. import kill
    try:
        kill(state.coordinator)
    except Exception:
        pass


# ------------------------------------------------- self-healing reform
#
# The detect -> recover loop (ROADMAP item 6): a collective that fails
# with a flight-recorder dead_rank verdict no longer just reports — the
# survivors fence the failing epoch, re-exchange endpoints through the
# coordinator under a fresh epoch (waiting for a restarted replacement
# rank, or shrinking the world, per ``collective_reform_mode``), and the
# fault-tolerant wrappers re-issue the failed op on the reformed group.

def ensure_collective_group(world_size: int, rank: int,
                            group_name: str = "default") -> None:
    """Idempotent (re-)join. A process that already holds live group
    state no-ops (reforms it participated in kept it current); a FRESH
    process — typically a restarted checkpointable actor — re-enters
    the group's open reform round with its old ``rank``, unblocking the
    survivors parked in replace-mode reform. Falls back to
    ``init_collective_group`` when the coordinator doesn't exist yet
    (first formation)."""
    if _groups().get(group_name) is not None:
        return
    actor_name = _GROUP_ACTOR_PREFIX + group_name
    try:
        coordinator = get_actor(actor_name)
    except ValueError:
        init_collective_group(world_size, rank, group_name)
        return
    failpoints.fp("coll.reform.join", group=group_name, rank=rank)
    ep = (coll_transport.local_endpoint()
          if CONFIG.collective_p2p_enabled else None)
    res = _coord_call(coordinator, group_name, "reform", rank, ep, None,
                      _reform_mode(), CONFIG.collective_reform_timeout_s,
                      CONFIG.collective_reform_grace_s, world_size)
    _adopt_membership(group_name, coordinator, res, _reform_mode(),
                      "restarted rank re-entry")


def _reform_mode() -> str:
    mode = CONFIG.collective_reform_mode
    if mode not in ("replace", "shrink"):
        raise ValueError(
            f"collective_reform_mode must be 'replace' or 'shrink', "
            f"got {mode!r}")
    return mode


def reform_collective_group(group_name: str = "default",
                            reason: str = "",
                            timeout: Optional[float] = None) -> int:
    """Re-form this group under a fresh epoch after a rank death.

    Fences the current (failing) epoch FIRST — from that instant no
    chunk of it can enter this process's mailbox — then joins the
    coordinator's reform round. In ``replace`` mode the round resolves
    once all world_size ranks re-arrived (a restarted rank re-enters
    with the same rank via ``ensure_collective_group``); in ``shrink``
    mode it resolves once arrivals quiesce for
    ``collective_reform_grace_s`` and the world contracts to the
    survivors. Returns this rank's rank in the reformed group."""
    with _groups_lock:
        state = _process_groups.get(group_name)
    if state is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            "process; nothing to reform")
    mode = _reform_mode()
    coll_transport.fence(state.name, state.epoch)
    failpoints.fp("coll.reform.join", group=group_name, rank=state.rank)
    ep = (coll_transport.local_endpoint()
          if CONFIG.collective_p2p_enabled else None)
    t = timeout if timeout is not None else CONFIG.collective_reform_timeout_s
    res = _coord_call(state.coordinator, group_name, "reform",
                      state.rank, ep, state.epoch, mode, t,
                      CONFIG.collective_reform_grace_s, state.world_size)
    ns = _adopt_membership(group_name, state.coordinator, res, mode,
                           reason)
    return ns.rank


def _adopt_membership(group_name: str, coordinator, res: dict,
                      mode: str, reason: str) -> _GroupState:
    """Install a reform round's result as this process's group state:
    retire the old epoch everywhere (recorder registry, mailbox), build
    the new ``_GroupState``, and account the reform (metric + one
    COLLECTIVE_REFORM event, emitted by the new rank 0)."""
    endpoints = [tuple(e) if e is not None else None
                 for e in res["endpoints"]]
    epoch, world, rank = res["epoch"], res["world"], res["rank"]
    with _groups_lock:
        old = _process_groups.get(group_name)
    if old is not None and old.epoch != epoch:
        flight_recorder.unregister_group(group_name, old.epoch)
        # fence (not just sweep): a manual reform call that skipped
        # reform_collective_group's own fence still closes the epoch
        coll_transport.fence(group_name, old.epoch)
    flight_recorder.register_group(group_name, epoch, rank, world,
                                   endpoints)
    ns = _GroupState(group_name, world, rank, coordinator, epoch,
                     endpoints)
    with _groups_lock:
        _process_groups[group_name] = ns
    if res.get("reformed"):
        telemetry.counter_inc(M_COLL_REFORMS, 1.0,
                              (("group", group_name), ("mode", mode)))
        if rank == 0:
            _emit_reform_event(group_name, epoch, mode, world, reason)
    return ns


def _emit_reform_event(group_name: str, epoch: str, mode: str,
                       world: int, reason: str) -> None:
    """Ship one COLLECTIVE_REFORM event through this process's node
    (the node's EventLogger owns the literal emit — reforms happen in
    worker/driver rank processes that have no logger of their own)."""
    from .._private import context
    client = context.current_client
    if client is None:
        return
    try:
        client.send_profile_event("coll_reform", {
            "message": (f"collective group {group_name!r} reformed "
                        f"under epoch {epoch[:8]} (mode={mode}, "
                        f"world={world})"
                        + (f": {reason}" if reason else "")),
            "group": group_name, "epoch": epoch, "mode": mode,
            "world": world, "reason": reason})
    except Exception:   # noqa: BLE001 — accounting must not fail recovery
        pass


def _reformable(exc: BaseException) -> List[dict]:
    return [v for v in getattr(exc, "verdicts", ())
            if v.get("verdict") == "dead_rank"]


class FaultTolerantGroup:
    """Retrying view of one collective group: each op re-issues after an
    automatic group reform when (and only when) its TimeoutError carries
    a flight-recorder ``dead_rank`` verdict — a merely slow rank keeps
    its group. Bounded: ``retries`` reforms per call (default
    ``collective_reform_retries``) with exponential backoff between
    re-issues. All member ranks must drive their ops through the same
    wrapper so every survivor enters the same reform round."""

    def __init__(self, group_name: str = "default",
                 retries: Optional[int] = None,
                 timeout: Optional[float] = None):
        self.group_name = group_name
        self.retries = (retries if retries is not None
                        else CONFIG.collective_reform_retries)
        self.timeout = timeout

    def _run(self, fn, *args, rank_sensitive: bool = False, **kwargs):
        kwargs.setdefault("timeout", self.timeout)
        attempt = 0
        while True:
            try:
                return fn(*args, group_name=self.group_name, **kwargs)
            except TimeoutError as exc:
                dead = _reformable(exc)
                if not dead or attempt >= self.retries:
                    if dead:
                        # the reform budget is exhausted with a dead-rank
                        # verdict standing: this call is terminal for the
                        # training loop — leave a black-box bundle the
                        # operator can autopsy offline
                        from .._private import debug_bundle
                        debug_bundle.auto_capture(
                            "collective_reform_exhausted",
                            fields={"group": self.group_name,
                                    "verdict": dead[0].get("message",
                                                           "dead rank")})
                    raise
                attempt += 1
                before = _groups().get(self.group_name)
                old = (before.world_size, before.rank) if before else None
                reform_collective_group(
                    self.group_name,
                    reason=dead[0].get("message", "dead rank"))
                after = _groups().get(self.group_name)
                if (rank_sensitive and after is not None
                        and old != (after.world_size, after.rank)):
                    # the reform RENUMBERED ranks (shrink dropped a
                    # member): the caller's rank-addressed arguments
                    # (broadcast src, reducescatter slices) now name
                    # different physical members — silently re-issuing
                    # would complete with the WRONG member's data
                    raise RuntimeError(
                        f"collective group {self.group_name!r} shrank "
                        f"during reform (world {old[0] if old else '?'}"
                        f" -> {after.world_size}, ranks renumbered): "
                        f"cannot safely re-issue the rank-addressed "
                        f"{fn.__name__} — re-issue it with ranks from "
                        "the reformed group") from exc
                time.sleep(min(0.25 * (2 ** (attempt - 1)), 2.0))

    def allreduce(self, tensor, op: str = SUM):
        return self._run(allreduce, tensor, op=op)

    def allgather(self, tensor):
        return self._run(allgather, tensor)

    def reducescatter(self, tensor, op: str = SUM):
        # output slices are addressed by rank: safe to re-issue only
        # while the reform preserved this rank's identity (replace)
        return self._run(reducescatter, tensor, op=op,
                         rank_sensitive=True)

    def broadcast(self, tensor, src_rank: int = 0):
        return self._run(broadcast, tensor, src_rank=src_rank,
                         rank_sensitive=True)

    def barrier(self):
        return self._run(barrier)


def ft_allreduce(tensor, group_name: str = "default", op: str = SUM,
                 timeout: Optional[float] = None,
                 retries: Optional[int] = None):
    """``allreduce`` with automatic dead-rank recovery: on a
    ``dead_rank`` verdict the group reforms under a fresh epoch (see
    ``reform_collective_group``) and the op re-issues, up to
    ``retries`` times. The workhorse of a fault-tolerant training
    step."""
    return FaultTolerantGroup(group_name, retries=retries,
                              timeout=timeout).allreduce(tensor, op=op)


@contextlib.contextmanager
def ft_collective(group_name: str = "default",
                  retries: Optional[int] = None,
                  timeout: Optional[float] = None):
    """Context manager yielding a :class:`FaultTolerantGroup`::

        with ft_collective("train", timeout=5.0) as grp:
            out = grp.allreduce(grads)
    """
    yield FaultTolerantGroup(group_name, retries=retries, timeout=timeout)


def get_rank(group_name: str = "default") -> int:
    state = _groups().get(group_name)
    return -1 if state is None else state.rank


def get_collective_group_size(group_name: str = "default") -> int:
    state = _groups().get(group_name)
    return -1 if state is None else state.world_size


def _state(group_name: str) -> _GroupState:
    state = _groups().get(group_name)
    if state is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            "process; call init_collective_group first")
    return state


def _torch_tensor(x):
    """``x`` if it is a torch tensor, else None (torch is looked up in
    ``sys.modules``: a caller holding a tensor has imported it)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        return x
    return None


def _to_numpy(tensor) -> np.ndarray:
    """Ingest a caller tensor as a C-CONTIGUOUS ndarray. The schedules
    ship zero-copy views of this array: pickle-5 only exports
    C-contiguous buffers out-of-band, so a transposed/strided input
    would silently fall back to an in-band copy whose byte order no
    longer matches the flat C-order reshape the receivers perform.
    ``ascontiguousarray`` is a no-copy view for already-contiguous
    input (the common case). A torch tensor becomes a view of its
    contiguous CPU bytes (no copy for a contiguous CPU tensor; a CUDA
    tensor is made contiguous on its card and copied to the host once),
    bf16 as ``_BF16``."""
    t = _torch_tensor(tensor)
    if t is None:
        return np.ascontiguousarray(np.asarray(tensor))
    torch = sys.modules["torch"]
    t = t.detach().contiguous()
    if t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16)
    return t.numpy()


def _as_caller(out, tensor):
    """A result in the caller's form: ``out`` itself for a numpy caller;
    for a torch caller a tensor of ``out``'s dtype (bf16 for ``_BF16``)
    on the device of the caller's ``tensor``."""
    t = _torch_tensor(tensor)
    if t is None:
        return out
    return _tensor_from(np.asarray(out), t.device)


def _tensor_from(arr: np.ndarray, device=None):
    import torch   # the caller or the sender holds tensors: it is loaded

    if not arr.flags.writeable:
        arr = arr.copy()       # a received buffer may be read-only
    arr = np.ascontiguousarray(arr)
    if arr.dtype == _BF16:
        out = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        out = torch.from_numpy(arr)
    if device is not None and device.type != "cpu":
        out = out.to(device)
    return out


class _TensorPayload:
    """A ``send`` of a torch tensor: its host bytes, marked so that
    ``recv`` returns a tensor (on the CPU) in place of an array."""

    __slots__ = ("arr",)

    def __init__(self, arr: np.ndarray):
        self.arr = arr

    def __reduce__(self):
        return (_TensorPayload, (self.arr,))

    @property
    def nbytes(self) -> int:
        return int(self.arr.nbytes)


def _deadline(timeout: Optional[float]) -> float:
    return time.monotonic() + (timeout if timeout is not None
                               else CONFIG.collective_timeout_s)


def _timeout_s(timeout: Optional[float]) -> float:
    return timeout if timeout is not None else CONFIG.collective_timeout_s


# --------------------------------------------------------- ring schedules
#
# Ring convention (delta = -1): at reduce-scatter step s, rank r sends
# segment (r-1-s) mod w and receives segment (r-2-s) mod w from its left
# neighbor, reducing it into the local buffer — after w-1 steps rank r
# holds segment r fully reduced. The allgather phase then circulates the
# finished segments the same way. Chunks pipeline: a chunk is forwarded
# the moment it is reduced, so chunk k+1 is on the wire while chunk k
# reduces, and a chunk's buffer is never mutated again until the data
# derived from it has causally passed through the next rank (which makes
# the zero-copy views safe).

def _chunk_ranges(a: int, b: int, chunk_elems: int) -> List[Tuple[int, int]]:
    out = []
    while a < b:
        e = min(a + chunk_elems, b)
        out.append((a, e))
        a = e
    return out


def _chunk_elems(dtype) -> int:
    return max(1, CONFIG.collective_chunk_bytes // max(1, dtype.itemsize))


def _send(state: _GroupState, dst_rank: int, key: tuple, payload,
          op: str) -> None:
    coll_transport.send(state.endpoints[dst_rank], key, payload,
                        group=state.name, op=op)


def _ring_reduce_scatter(state, buf: np.ndarray,
                         bounds: List[int], op: str, key: tuple,
                         deadline: float, opname: str,
                         codec: Optional[_WireCodec] = None) -> None:
    """In-place ring reduce-scatter over ``buf`` segments ``bounds``;
    on return segment ``rank`` holds the full reduction. With a
    ``codec`` every hop is encoded before the send and decoded before
    the reduce (dequantize -> reduce -> requantize: the reduce itself
    always runs in the original dtype, in ring order — deterministic)."""
    w, r = state.world_size, state.rank
    right = (r + 1) % w
    ce = _chunk_elems(buf.dtype)
    binop = _binop(op, buf.dtype)
    enc = codec.encode if codec is not None else (lambda x: x)
    dec = codec.decode if codec is not None else np.asarray

    def chunks(seg: int) -> List[Tuple[int, int]]:
        return _chunk_ranges(bounds[seg], bounds[seg + 1], ce)

    first = (r - 1) % w
    for ci, (a, b) in enumerate(chunks(first)):
        _send(state, right, key + ("rs", first, ci), enc(buf[a:b]), opname)
    for s in range(w - 1):
        seg = (r - 2 - s) % w
        for ci, (a, b) in enumerate(chunks(seg)):
            data = coll_transport.wait(key + ("rs", seg, ci), deadline)
            failpoints.fp("coll.ring.rs_hop", rank=r, step=s, seg=seg,
                          chunk=ci, seq=key[2])
            view = buf[a:b]
            binop(view, dec(data), out=view)
            if s < w - 2:
                # forward the just-reduced chunk while the next chunk
                # of this segment is still in flight (pipelining)
                _send(state, right, key + ("rs", seg, ci), enc(view),
                      opname)


def _ring_allgather_segments(state, buf: np.ndarray,
                             bounds: List[int], key: tuple,
                             deadline: float, opname: str,
                             codec: Optional[_WireCodec] = None) -> None:
    """Ring allgather of ``buf`` segments: each rank starts with its own
    segment final (post reduce-scatter) and circulates; on return every
    segment of ``buf`` is final. With a ``codec`` each segment is
    encoded ONCE by its owner, forwarded verbatim, and the owner writes
    the encode->decode roundtrip back into its own segment — so every
    rank decodes (and returns) bit-identical bytes."""
    w, r = state.world_size, state.rank
    right = (r + 1) % w
    ce = _chunk_elems(buf.dtype)
    dec = codec.decode if codec is not None else np.asarray

    def chunks(seg: int) -> List[Tuple[int, int]]:
        return _chunk_ranges(bounds[seg], bounds[seg + 1], ce)

    for ci, (a, b) in enumerate(chunks(r)):
        if codec is not None and codec.active:
            enc = codec.encode(buf[a:b])
            _send(state, right, key + ("ag", r, ci), enc, opname)
            buf[a:b] = codec.decode(enc)
        else:
            _send(state, right, key + ("ag", r, ci), buf[a:b], opname)
    for s in range(w - 1):
        seg = (r - 1 - s) % w
        for ci, (a, b) in enumerate(chunks(seg)):
            data = coll_transport.wait(key + ("ag", seg, ci), deadline)
            if s < w - 2:
                # forward the received (zero-copy) payload untouched —
                # quantized segments are never re-encoded in flight
                _send(state, right, key + ("ag", seg, ci), data, opname)
            buf[a:b] = dec(data)


# --------------------------------------------------------- tree schedules

def _tree_parent_children(v: int, w: int) -> Tuple[Optional[int], List[int]]:
    """Binomial tree rooted at virtual rank 0: parent clears v's lowest
    set bit; children are v + m for descending m below it."""
    if v == 0:
        lsb = 1
        while lsb < w:
            lsb <<= 1
        parent = None
    else:
        lsb = v & -v
        parent = v - lsb
    children = []
    m = lsb >> 1
    while m:
        if v + m < w:
            children.append(v + m)
        m >>= 1
    return parent, children


def _tree_reduce(state: _GroupState, arr: np.ndarray, op: str, key: tuple,
                 deadline: float, opname: str) -> Optional[np.ndarray]:
    """Binomial-tree reduction to rank 0; returns the total at rank 0,
    None elsewhere (small payloads: whole arrays per hop)."""
    w, r = state.world_size, state.rank
    binop = _binop(op, arr.dtype)
    acc = np.array(arr)
    mask = 1
    while mask < w:
        if r & mask:
            _send(state, r - mask, key + ("tr", r), acc, opname)
            return None
        peer = r | mask
        if peer < w:
            data = coll_transport.wait(key + ("tr", peer), deadline)
            acc = binop(acc, np.asarray(data))
        mask <<= 1
    return acc


def _tree_bcast_small(state: _GroupState, data, src_rank: int, key: tuple,
                      deadline: float, opname: str) -> np.ndarray:
    """Whole-payload binomial broadcast (small/known-shape payloads)."""
    w, r = state.world_size, state.rank
    v = (r - src_rank) % w
    parent, children = _tree_parent_children(v, w)
    if parent is not None:
        data = coll_transport.wait(key + ("tb", v), deadline)
    for c in children:
        _send(state, (c + src_rank) % w, key + ("tb", c), data, opname)
    return np.asarray(data)


def _tree_bcast_chunked(state: _GroupState, value: Optional[np.ndarray],
                        src_rank: int, key: tuple, deadline: float,
                        opname: str) -> np.ndarray:
    """Chunk-pipelined binomial broadcast: non-source ranks learn the
    shape from a header, then each chunk is forwarded down the tree the
    moment it arrives (chunk k+1 rides the wire while k lands)."""
    w, r = state.world_size, state.rank
    v = (r - src_rank) % w
    parent, children = _tree_parent_children(v, w)

    def fanout(subkey: tuple, payload) -> None:
        for c in children:
            _send(state, (c + src_rank) % w, key + subkey + (c,), payload,
                  opname)

    if parent is None:
        flat = np.ascontiguousarray(value).reshape(-1)
        ranges = _chunk_ranges(0, flat.size, _chunk_elems(flat.dtype))
        # the dtype itself, not its ``.str``: a structured dtype's string
        # ("|V2" for _BF16) names a plain void type numpy cannot cast to
        header = (value.shape, flat.dtype, len(ranges))
        fanout(("bh",), header)
        for ci, (a, b) in enumerate(ranges):
            fanout(("bc", ci), flat[a:b])
        return np.asarray(value)
    shape, dtype_str, nchunks = coll_transport.wait(
        key + ("bh", v), deadline)
    fanout(("bh",), (shape, dtype_str, nchunks))
    buf = np.empty(int(np.prod(shape, dtype=np.int64)),
                   dtype=np.dtype(dtype_str))
    pos = 0
    for ci in range(nchunks):
        data = coll_transport.wait(key + ("bc", ci, v), deadline)
        fanout(("bc", ci), data)
        arr = np.asarray(data)
        buf[pos:pos + arr.size] = arr
        pos += arr.size
    return buf.reshape(tuple(shape))


# -------------------------------------------------- hierarchical schedules
#
# Two-level topology-aware schedules ("The Big Send-off" intra-node ->
# inter-node shape): ranks are grouped by the node id their endpoint
# carries, the lowest rank on each node is its leader, and only leaders
# speak across nodes. On an m-node group with k ranks per node the
# inter-node traffic of an allreduce drops from a flat ring's ~2x size
# per CROSSING EDGE (of which there are m) to ~2·(m-1)/m·size per
# LEADER — i.e. ~1/k of the total cross-wire bytes — and the intra-node
# staging hops ride the same-host fast path. The optional wire codec
# applies ONLY to the leader-ring hops of reductions.

def _hier_allreduce(state: _GroupState, buf: np.ndarray, op: str,
                    key: tuple, deadline: float, opname: str,
                    codec: Optional[_WireCodec]) -> np.ndarray:
    """allreduce = intra-node binomial reduce to the leader ->
    leaders-only ring allreduce (codec on the hops) -> intra-node
    binomial broadcast — fused per OUTER CHUNK so the three phases
    pipeline: while the leaders run the inter-node ring on chunk k,
    chunk k+1 is already climbing the local tree and chunk k-1 is
    fanning back out (sends are fire-and-forget, so a member's phase-1
    send of one chunk never waits on the ring). Serial critical path is
    ~one phase's bytes, not the sum of all three. Returns the flat
    result (aliasing ``buf`` on leaders)."""
    local = _SubState(state, state.local_ranks)
    lv, lw = local.rank, local.world_size
    parent, children = _tree_parent_children(lv, lw)
    is_leader = parent is None
    leaders = (_SubState(state, state.leaders)
               if is_leader and state.n_nodes > 1 else None)
    ranges = _chunk_ranges(0, buf.size, _chunk_elems(buf.dtype))
    binop = _binop(op, buf.dtype)
    out = buf if is_leader else np.empty_like(buf)
    for ci, (a, b) in enumerate(ranges):
        view = buf[a:b]
        # phase 1: this chunk climbs the local binomial tree (children
        # reduce into us, we pass the partial up)
        for c in children:
            data = coll_transport.wait(key + ("hl", ci, c), deadline)
            binop(view, np.asarray(data), out=view)
        if not is_leader:
            # failpoint BEFORE the send: a chaos kill at chunk k dies
            # with chunk k-1 already in flight but chunk k never sent,
            # so the survivors wedge inside THIS op (and the whole step
            # retries aligned after the reform) instead of completing
            # without the victim and skewing one step ahead of it
            failpoints.fp("coll.hier.phase", phase="up", rank=state.rank,
                          chunk=ci, seq=key[2])
            _send(state, local.members[parent], key + ("hl", ci, lv),
                  view, opname)
            continue
        # phase 2 (leader): inter-node ring allreduce of this chunk
        if leaders is not None:
            m = leaders.world_size
            cb = [a + (i * (b - a)) // m for i in range(m + 1)]
            _ring_reduce_scatter(leaders, buf, cb, op, key + ("hx", ci),
                                 deadline, opname, codec=codec)
            _ring_allgather_segments(leaders, buf, cb, key + ("hx", ci),
                                     deadline, opname, codec=codec)
        # phase 3 (leader): fan the finished chunk down the local tree
        failpoints.fp("coll.hier.phase", phase="ring", rank=state.rank,
                      chunk=ci, seq=key[2])
        for c in children:
            _send(state, local.members[c], key + ("hb", ci, c), view,
                  opname)
    if not is_leader:
        # phase 3: chunks arrive from the parent, forward to our
        # subtree, assemble the result
        for ci, (a, b) in enumerate(ranges):
            data = coll_transport.wait(key + ("hb", ci, lv), deadline)
            for c in children:
                _send(state, local.members[c], key + ("hb", ci, c),
                      data, opname)
            out[a:b] = np.asarray(data)
    return out


def _hier_reducescatter(state: _GroupState, buf: np.ndarray, op: str,
                        seg_elems: int, key: tuple, deadline: float,
                        opname: str,
                        codec: Optional[_WireCodec]) -> np.ndarray:
    """reducescatter = intra-node tree reduce to the leader -> leaders
    ring reduce-scatter over PER-NODE segment blocks (codec on the
    hops) -> leader hands each co-located rank its slice. Requires
    ``state.node_blocks_contiguous`` (the selector's caller degrades to
    the flat ring otherwise). Returns this rank's flat slice."""
    r = state.rank
    local = _SubState(state, state.local_ranks)
    total = _tree_reduce(local, buf, op, key + ("hl",), deadline, opname)
    if total is not None:
        if state.n_nodes > 1:
            leaders = _SubState(state, state.leaders)
            # node j's block spans its member ranks' slices (contiguous
            # by precondition, in leader-ring segment order)
            bounds = [state.node_ranks[nid][0] * seg_elems
                      for nid in state.nodes]
            bounds.append(state.world_size * seg_elems)
            _ring_reduce_scatter(leaders, total, bounds, op,
                                 key + ("hx",), deadline, opname,
                                 codec=codec)
        for peer in state.local_ranks[1:]:
            a = peer * seg_elems
            _send(state, peer, key + ("hs", peer),
                  total[a:a + seg_elems], opname)
        return total[r * seg_elems:(r + 1) * seg_elems]
    data = coll_transport.wait(key + ("hs", r), deadline)
    return np.asarray(data).reshape(-1)


def _hier_allgather(state: _GroupState, arr: np.ndarray, key: tuple,
                    deadline: float, opname: str) -> List[np.ndarray]:
    """allgather = co-located ranks hand their arrays to the leader ->
    leaders ring-allgather per-node BUNDLES (one mailbox message per
    node per hop instead of one per rank) -> leader fans the full part
    list back out. Caller bytes are relayed verbatim (never quantized)."""
    w, r = state.world_size, state.rank
    if r != state.leader:
        _send(state, state.leader, key + ("hga", r), arr, opname)
        parts = coll_transport.wait(key + ("hgb", r), deadline)
        return [np.asarray(p) for p in parts]
    out: List[Any] = [None] * w
    out[r] = arr
    for peer in state.local_ranks[1:]:
        out[peer] = np.asarray(
            coll_transport.wait(key + ("hga", peer), deadline))
    if state.n_nodes > 1:
        leaders = _SubState(state, state.leaders)
        lr = leaders.rank
        m = leaders.world_size
        right = (lr + 1) % m
        my_nid = state.nodes[lr]
        bundle = tuple(out[g] for g in state.node_ranks[my_nid])
        _send(state, state.leaders[right], key + ("hgx", lr), bundle,
              opname)
        for s in range(m - 1):
            src = (lr - 1 - s) % m
            bundle = coll_transport.wait(key + ("hgx", src), deadline)
            if s < m - 2:
                _send(state, state.leaders[right], key + ("hgx", src),
                      bundle, opname)
            for g, part in zip(state.node_ranks[state.nodes[src]], bundle):
                out[g] = np.asarray(part)
    for peer in state.local_ranks[1:]:
        _send(state, peer, key + ("hgb", peer), tuple(out), opname)
    return [np.asarray(p) for p in out]


def _hier_broadcast(state: _GroupState, value: Optional[np.ndarray],
                    src_rank: int, key: tuple, deadline: float,
                    opname: str) -> np.ndarray:
    """broadcast = source -> its node's leader (one same-host hop) ->
    chunk-pipelined binomial tree over the LEADERS (every hop of it is
    a genuine cross-node transfer, m-1 of them — the minimum) ->
    chunk-pipelined tree inside each node. Bytes relayed verbatim."""
    r = state.rank
    src_node = state.endpoints[src_rank][0]
    src_leader = state.node_ranks[src_node][0]
    if r == src_rank and r != src_leader:
        _send(state, src_leader, key + ("hb0",), value, opname)
    data: Optional[np.ndarray] = value if r == src_rank else None
    if r in state.leaders:
        if r == src_leader and r != src_rank:
            data = np.asarray(
                coll_transport.wait(key + ("hb0",), deadline))
        leaders = _SubState(state, state.leaders)
        data = _tree_bcast_chunked(leaders, data,
                                   state.leaders.index(src_leader),
                                   key + ("hx",), deadline, opname)
    local = _SubState(state, state.local_ranks)
    out = _tree_bcast_chunked(local, data if r == state.leader else None,
                              0, key + ("hb",), deadline, opname)
    return np.asarray(out)


# ------------------------------------------------------------- public API

def _pick(state: _GroupState, op: str, nbytes: int, dtype) -> str:
    """Resolve the schedule for one call and record the choice (the
    counter must reflect the schedule that actually RUNS, so any
    topology-based demotion happens before recording)."""
    if state.world_size == 1:
        algo = "local"
    elif not state.use_p2p:
        algo = "star"
    else:
        algo = _select_schedule(op, nbytes, state.world_size,
                                state.n_nodes, dtype)
        if (algo == "hierarchical" and op == "reducescatter"
                and not state.node_blocks_contiguous):
            # per-node segment bounds need each node's ranks to span a
            # contiguous rank range; interleaved placements run the
            # flat ring
            algo = "ring"
    _observe_algo(op, algo)
    return algo


def _remote_verdict(state: _GroupState, okey) -> Tuple[str, List[dict]]:
    """Best-effort cluster-wide hang diagnosis after a local timeout:
    fan the COLL_PROGRESS query out through the control plane (answered
    on every process's reader thread — a peer wedged inside the same
    collective still replies), diff watermarks, and return (verdict
    sentence(s), verdict dicts) for this group/op. Empty when no
    runtime client is attached or the diagnosis itself fails. The
    dicts ride on the raised ``CollectiveTimeoutError`` so the
    fault-tolerant wrappers can reform on a dead_rank verdict without
    string-matching."""
    from .._private import context
    client = context.current_client
    if client is None or not flight_recorder.enabled():
        return "", []
    try:
        report = client.collective_health(
            CONFIG.coll_progress_timeout_s) or {}
    except Exception:   # noqa: BLE001 — diagnosis must not mask the error
        return "", []
    want = okey if isinstance(okey, int) else list(okey)
    verdicts = [v for v in report.get("verdicts", ())
                if v.get("group") == state.name and v.get("seq") == want]
    if not verdicts:
        verdicts = [v for v in report.get("verdicts", ())
                    if v.get("group") == state.name]
    return ("; ".join(v.get("message", "") for v in verdicts[:2]),
            verdicts)


def _run_op(state: _GroupState, op: str, algo: str, okey, nbytes: int,
            fn):
    """Run one public op's data path under the flight recorder.

    On success the op record retires into the recorder's completed ring
    (``state.timeline()`` renders those as spans). On a TimeoutError the
    failure is handled, not just raised: the timeout counter bumps, the
    cluster-wide diagnosis runs WHILE this rank's watermark record is
    still live (both survivors of a dead rank time out near-
    simultaneously — dropping the record first would blind the peer's
    diagnosis), the verdict is appended to the exception message, and
    the failed call's undelivered chunks are dropped from the mailbox so
    ``rtpu_collective_inflight_chunks`` returns to 0 now instead of at
    the TTL sweep."""
    flight_recorder.op_begin(state.name, state.epoch, okey, op, algo,
                             nbytes, state.world_size, state.rank)
    failpoints.fp("coll.op.begin", op=op, group=state.name,
                  rank=state.rank, seq=okey, algo=algo)
    try:
        out = fn()
    except TimeoutError as exc:
        telemetry.counter_inc(M_COLL_TIMEOUTS, 1.0,
                              (("group", state.name), ("op", op)))
        flight_recorder.op_error(state.name, okey, str(exc))
        detail, verdicts = _remote_verdict(state, okey)
        flight_recorder.op_end(state.name, okey)
        if isinstance(okey, int):
            # p2p send/recv awaited exactly one key that never arrived
            # — only sequenced schedule calls can strand delivered chunks
            coll_transport.drop_call(state.name, state.epoch, okey)
        msg = str(exc)
        if detail:
            msg = f"{msg} [diagnosis: {detail}]"
        raise CollectiveTimeoutError(msg, group=state.name,
                                     verdicts=verdicts) from None
    except BaseException as exc:
        # any other failure (dead coordinator actor, mismatched-shape
        # reduce, ...) must still retire the watermark record, or the
        # op reads as STUCK in every later health report
        flight_recorder.op_end(state.name, okey,
                               error=f"{type(exc).__name__}: {exc}")
        raise
    flight_recorder.op_end(state.name, okey)
    return out


def allreduce(tensor, group_name: str = "default", op: str = SUM,
              timeout: Optional[float] = None):
    """All-reduce; returns the reduced array (reference mutates in place —
    functional style here, as in ray_tpu). Schedule per the
    selection table: binomial tree (latency-bound), flat ring, or
    hierarchical two-level (multi-node; optionally block-quantized
    inter-node). Every rank returns bit-identical bytes."""
    state = _state(group_name)
    arr = _to_numpy(tensor)
    t0 = time.monotonic()
    seq = state.next_seq()
    algo = _pick(state, "allreduce", arr.nbytes, arr.dtype)

    def run():
        if algo == "local":
            return np.array(arr)
        if algo == "star":
            return np.asarray(_coord(state.coordinator, "rendezvous",
                                     state.key(seq), state.rank, arr, op,
                                     _timeout_s(timeout)))
        if algo == "tree":
            key, deadline = state.key(seq), _deadline(timeout)
            total = _tree_reduce(state, arr, op, key, deadline,
                                 "allreduce")
            result = _tree_bcast_small(state, total, 0, key, deadline,
                                       "allreduce").reshape(arr.shape)
            # the fanned-out buffer aliases the returned array (root) —
            # the caller may mutate it the moment we return, so the
            # zero-copy sends must have left this process first
            coll_transport.flush()
            return result
        if algo == "hierarchical":
            key, deadline = state.key(seq), _deadline(timeout)
            codec = _make_codec()
            buf = arr.reshape(-1).copy()
            out = _hier_allreduce(state, buf, op, key, deadline,
                                  "allreduce", codec)
            # leaders fan out zero-copy views of the result they return
            coll_transport.flush()
            _observe_quant(codec, "allreduce", group_name)
            return out.reshape(arr.shape)
        key, deadline = state.key(seq), _deadline(timeout)
        buf = arr.reshape(-1).copy()
        n = buf.size
        w = state.world_size
        bounds = [(i * n) // w for i in range(w + 1)]
        _ring_reduce_scatter(state, buf, bounds, op, key, deadline,
                             "allreduce")
        _ring_allgather_segments(state, buf, bounds, key, deadline,
                                 "allreduce")
        # allgather-phase sends are views of ``buf``, which the caller
        # receives (and may mutate) as the result — flush before return
        coll_transport.flush()
        return buf.reshape(arr.shape)

    result = _run_op(state, "allreduce", algo, seq, arr.nbytes, run)
    _observe("allreduce", group_name, arr.nbytes, t0)
    return _as_caller(result, tensor)


def allgather(tensor, group_name: str = "default",
              timeout: Optional[float] = None) -> List[np.ndarray]:
    """Gather every rank's array (whole contributions circulate the
    ring; output is inherently O(world * size))."""
    state = _state(group_name)
    arr = _to_numpy(tensor)
    t0 = time.monotonic()
    seq = state.next_seq()
    w, r = state.world_size, state.rank
    algo = _pick(state, "allgather", arr.nbytes, arr.dtype)

    def run():
        if algo == "local":
            return [np.array(arr)]
        if algo == "star":
            return [np.asarray(p) for p in _coord(
                state.coordinator, "rendezvous", state.key(seq), r, arr,
                None, _timeout_s(timeout))]
        if algo == "hierarchical":
            key, deadline = state.key(seq), _deadline(timeout)
            parts = _hier_allgather(state, arr, key, deadline,
                                    "allgather")
            # the caller's own ``arr`` (and, on leaders, the returned
            # parts) went out zero-copy — flush the link before they
            # can be mutated
            coll_transport.flush()
            return parts
        key, deadline = state.key(seq), _deadline(timeout)
        out: List[Any] = [None] * w
        out[r] = arr
        right = (r + 1) % w
        _send(state, right, key + ("ga", r), arr, "allgather")
        for s in range(w - 1):
            src = (r - 1 - s) % w
            data = coll_transport.wait(key + ("ga", src), deadline)
            if s < w - 2:
                _send(state, right, key + ("ga", src), data, "allgather")
            out[src] = np.asarray(data)
        # the caller's own ``arr`` went onto the ring zero-copy and the
        # caller may mutate it once we return — flush the link first
        coll_transport.flush()
        return [np.asarray(p) for p in out]

    parts = _run_op(state, "allgather", algo, seq, arr.nbytes, run)
    _observe("allgather", group_name, arr.nbytes, t0)
    return [_as_caller(p, tensor) for p in parts]


def reducescatter(tensor, group_name: str = "default", op: str = SUM,
                  timeout: Optional[float] = None):
    """Reduce then return this rank's 1/world_size slice along axis 0
    (ring reduce-scatter: each rank receives only its own slice's
    traffic, ~1x tensor size per rank)."""
    state = _state(group_name)
    arr = _to_numpy(tensor)
    t0 = time.monotonic()
    seq = state.next_seq()
    w, r = state.world_size, state.rank
    if arr.ndim == 0 or arr.shape[0] % w:
        raise ValueError(
            f"reducescatter: leading dim {arr.shape[:1]} not divisible "
            f"by world size {w}")
    rows = arr.shape[0] // w
    algo = _pick(state, "reducescatter", arr.nbytes, arr.dtype)

    def run():
        if algo == "local":
            return np.array(arr)
        if algo == "star":
            reduced = np.asarray(_coord(state.coordinator, "rendezvous",
                                        state.key(seq), r, arr, op,
                                        _timeout_s(timeout)))
            return reduced[r * rows:(r + 1) * rows]
        if algo == "hierarchical":
            key, deadline = state.key(seq), _deadline(timeout)
            codec = _make_codec()
            buf = arr.reshape(-1).copy()
            seg_elems = rows * (buf.size // arr.shape[0])
            out = _hier_reducescatter(state, buf, op, seg_elems, key,
                                      deadline, "reducescatter", codec)
            # leaders ship zero-copy slices of the buffer they keep a
            # slice of — flush before the caller can mutate the result
            coll_transport.flush()
            _observe_quant(codec, "reducescatter", group_name)
            return out.reshape((rows,) + arr.shape[1:]).copy()
        key, deadline = state.key(seq), _deadline(timeout)
        buf = arr.reshape(-1).copy()
        seg_elems = rows * (buf.size // arr.shape[0])
        bounds = [i * seg_elems for i in range(w + 1)]
        _ring_reduce_scatter(state, buf, bounds, op, key, deadline,
                             "reducescatter")
        return buf[bounds[r]:bounds[r + 1]].reshape(
            (rows,) + arr.shape[1:]).copy()

    result = _run_op(state, "reducescatter", algo, seq, arr.nbytes, run)
    _observe("reducescatter", group_name, arr.nbytes, t0)
    return _as_caller(result, tensor)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default",
              timeout: Optional[float] = None):
    """Binomial-tree broadcast from ``src_rank``, chunk-pipelined down
    the tree; non-source ranks' tensors are ignored (shape/dtype arrive
    in the header)."""
    state = _state(group_name)
    arr = _to_numpy(tensor)
    t0 = time.monotonic()
    seq = state.next_seq()
    is_src = state.rank == src_rank
    algo = _pick(state, "broadcast", arr.nbytes if is_src else 0,
                 arr.dtype)

    def run():
        if algo == "local":
            return np.array(arr)
        if algo == "star":
            parts = _coord(state.coordinator, "rendezvous",
                           state.key(seq), state.rank,
                           arr if is_src else None, None,
                           _timeout_s(timeout))
            return np.asarray(parts[src_rank])
        if algo == "hierarchical":
            result = _hier_broadcast(state, arr if is_src else None,
                                     src_rank, state.key(seq),
                                     _deadline(timeout), "broadcast")
            coll_transport.flush()
            return result
        result = _tree_bcast_chunked(state, arr if is_src else None,
                                     src_rank, state.key(seq),
                                     _deadline(timeout), "broadcast")
        # the source fans out zero-copy views of the caller's tensor
        # (contiguous input: ascontiguousarray is a no-copy) — it must
        # be on the wire before the caller can touch it again
        coll_transport.flush()
        return result

    result = _run_op(state, "broadcast", algo, seq,
                     arr.nbytes if is_src else 0, run)
    _observe("broadcast", group_name, arr.nbytes if is_src else 0, t0)
    return _as_caller(result, tensor)


def barrier(group_name: str = "default",
            timeout: Optional[float] = None) -> None:
    """All ranks block until every rank arrived (tree reduce + tree
    broadcast of an empty token — 2·log2(w) hops)."""
    state = _state(group_name)
    t0 = time.monotonic()
    seq = state.next_seq()
    algo = _pick(state, "barrier", 0, np.dtype(np.uint8))

    def run():
        if algo == "local":
            return None
        if algo == "star":
            _coord(state.coordinator, "rendezvous", state.key(seq),
                   state.rank, None, None, _timeout_s(timeout))
            return None
        key, deadline = state.key(seq), _deadline(timeout)
        token = np.zeros(1, dtype=np.uint8)
        total = _tree_reduce(state, token, SUM, key, deadline, "barrier")
        _tree_bcast_small(state, total, 0, key, deadline, "barrier")
        return None

    _run_op(state, "barrier", algo, seq, 0, run)
    _observe("barrier", group_name, 0, t0)


def send(tensor, dst_rank: int, group_name: str = "default",
         tag: int = 0) -> None:
    """Direct rank-to-rank send: one mailbox message straight to the
    destination rank's process (no coordinator hop)."""
    state = _state(group_name)
    seq = state.send_seq.get((dst_rank, tag), 0)
    state.send_seq[(dst_rank, tag)] = seq + 1
    arr = _to_numpy(tensor)
    payload = (_TensorPayload(arr) if _torch_tensor(tensor) is not None
               else arr)
    t0 = time.monotonic()
    okey = ("p2p", state.rank, dst_rank, tag, seq)

    def run():
        if state.use_p2p:
            _send(state, dst_rank,
                  (state.name, state.epoch, "p2p", state.rank, dst_rank,
                   tag, seq), payload, "send")
            # ``arr`` aliases the caller's tensor (zero-copy); send()
            # must not return while it can still be pickled later by a
            # drainer
            coll_transport.flush()
        else:
            get(state.coordinator.post.remote(
                dst_rank, (state.rank, tag, seq), payload))
        return None

    _run_op(state, "send", "p2p" if state.use_p2p else "star", okey,
            arr.nbytes, run)
    _observe("send", group_name, arr.nbytes, t0)


def recv(src_rank: int, group_name: str = "default", tag: int = 0,
         timeout: Optional[float] = None):
    """Blocking receive of the matching ``send`` (FIFO per (src, tag));
    wakes on delivery, raises TimeoutError at the deadline."""
    state = _state(group_name)
    seq = state.recv_seq.get((src_rank, tag), 0)
    state.recv_seq[(src_rank, tag)] = seq + 1
    t0 = time.monotonic()
    okey = ("p2p", src_rank, state.rank, tag, seq)

    def run():
        if state.use_p2p:
            data = coll_transport.wait(
                (state.name, state.epoch, "p2p", src_rank, state.rank,
                 tag, seq), _deadline(timeout), what="p2p recv")
        else:
            data = _coord(state.coordinator, "take", state.rank,
                          (src_rank, tag, seq), _timeout_s(timeout))
        if isinstance(data, _TensorPayload):
            return _tensor_from(np.array(data.arr))
        return np.array(data) if state.use_p2p else np.asarray(data)

    arr = _run_op(state, "recv", "p2p" if state.use_p2p else "star",
                  okey, 0, run)
    _observe("recv", group_name, arr.nbytes, t0)
    return arr
