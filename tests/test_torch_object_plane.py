# A copy of tests/test_object_plane.py on ray_tpu_torch's runtime: the same
# tests under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown. Docstrings leave
# out the JAX package's issue history.
"""Same-host zero-copy object plane + pressure-driven spill.

Reference model: plasma promotion from the CoreWorker in-memory store
(``core_worker/store_provider/``) and spilling under pressure
(``object_manager/spill_manager``-equivalent). The structural claims
proved here:

- a driver put of a large value copies ZERO bytes at put time (lazy
  primary) and ZERO socket payload bytes when a same-host worker
  consumes it (the worker maps the arena block);
- under memory pressure objects spill to disk coldest-first, pinned
  objects are exempt, and spilled objects restore bit-correct on get —
  locally, across nodes, and across OS-isolated "hosts";
- a SIGKILL'd owner leaves no orphaned /dev/shm artifacts: the next
  store boot reaps them via the crash manifest.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import telemetry
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import (ObjectMeta, ObjectReader,
                                                 ObjectStore, reap_orphan_shm)
from ray_tpu_torch._private.serialization import serialize, serialized_size
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


def _transport_bytes() -> float:
    """Total socket payload bytes sent by this process (all transports,
    inline frames + out-of-band payload lane)."""
    snap = telemetry.snapshot_local()["counters"]
    return sum(v for (name, _tags), v in snap.items()
               if name in (telemetry.M_TRANSPORT_SEND_BYTES,
                           telemetry.M_TRANSPORT_OOB_BYTES))


def _lazy_put(store: ObjectStore, obj) -> ObjectID:
    smeta, views = serialize(obj)
    total = serialized_size(smeta, views)
    oid = ObjectID.from_random()
    meta = store.put_lazy(oid, smeta, views, total)
    assert meta is not None and meta.flags & ObjectMeta.LAZY
    return oid


# --------------------------------------------------- zero-copy (structural)

def test_same_host_zero_copy_structural(rtpu_init):
    """put() of a large array must not ride the socket: transport byte
    counters stay flat (modulo control frames) across put + worker
    consume + driver get, and the driver's get returns a view backed by
    the node's shm arena — not a heap copy."""
    node = ray_tpu_torch._global_node
    payload = 16 << 20
    arr = np.arange(payload // 8, dtype=np.float64)

    before = _transport_bytes()
    ref = ray_tpu_torch.put(arr)
    assert node.store.stats()["num_lazy_puts"] >= 1

    @ray_tpu_torch.remote
    def head_tail(x):
        return float(x[0] + x[-1])

    # same-host worker demand: promotes the lazy primary into the arena,
    # worker maps the block — no payload bytes on any socket
    got = ray_tpu_torch.get(head_tail.remote(ref), timeout=60)
    assert got == float(arr[0] + arr[-1])

    out = ray_tpu_torch.get(ref, timeout=60)
    assert np.array_equal(out, arr)
    delta = _transport_bytes() - before
    assert delta < payload / 8, (
        f"{delta} socket payload bytes moved for a {payload}-byte "
        "same-host object — the zero-copy plane is leaking copies")

    # structural: the object lives in the arena and the returned array
    # aliases the mapped block (no deserialization copy)
    meta = node.store.get_meta(ref.id)
    assert meta is not None and meta.arena_ref is not None
    from ray_tpu_torch._private import native
    reader = native.ArenaReader.get(meta.arena_ref[0])
    probe = np.frombuffer(
        reader.tracked_buffer(meta.arena_ref[1], meta.size),
        dtype=np.uint8)
    base = probe.__array_interface__["data"][0]
    ptr = out.__array_interface__["data"][0]
    assert base <= ptr < base + meta.size, (
        "get() returned a heap copy instead of an arena-backed view")


def test_lazy_put_freed_unread_never_materializes(rtpu_init):
    """put → free without any reader must never touch shm: the common
    scratch-object lifecycle costs zero copies end to end."""
    node = ray_tpu_torch._global_node
    stats0 = node.store.stats()
    refs = [ray_tpu_torch.put(np.ones(1 << 20, dtype=np.uint8))
            for _ in range(4)]
    for r in refs:
        ray_tpu_torch.free([r])
    stats1 = node.store.stats()
    assert stats1["num_lazy_puts"] >= stats0["num_lazy_puts"] + 4
    assert stats1["num_materialized"] == stats0["num_materialized"]


# ------------------------------------------------------- spill policy (unit)

def test_spill_coldest_first_and_pinned_exempt(tmp_path):
    """Eviction order is LRU (coldest first) and pinned entries are
    never spilled, even under pressure."""
    store = ObjectStore(capacity_bytes=4 << 20, spill_dir=str(tmp_path))
    try:
        mb = np.ones(1 << 20, dtype=np.uint8)
        a = _lazy_put(store, mb * 1)
        b = _lazy_put(store, mb * 2)
        c = _lazy_put(store, mb * 3)
        store.pin(b)
        # touch a: it becomes the hottest entry, so the spill scan must
        # reach past it only after the colder c is gone
        assert store.get_meta(a) is not None
        with store._lock:
            store._capacity = 2 << 20
            store._ensure_capacity(0)
        ent = store._entries
        assert ent[c].spilled_path is not None, "coldest entry not spilled"
        assert ent[c].meta.flags & ObjectMeta.SPILLED
        assert ent[b].spilled_path is None, "pinned entry was spilled"
        assert store.stats()["spilled_bytes_total"] > 0
        # pressure high enough that only the pin saved b
        with store._lock:
            store._capacity = 1 << 18
            store._ensure_capacity(0)
        assert ent[a].spilled_path is not None
        assert ent[b].spilled_path is None, "pinned entry was spilled"
        store.unpin(b)
        with store._lock:
            store._ensure_capacity(0)
        assert ent[b].spilled_path is not None, "unpinned entry kept"
    finally:
        store.shutdown()


def test_lazy_spill_restores_bit_correct(tmp_path):
    """A lazy primary spilled straight to disk (never transited shm)
    must restore bit-correct on first read, with counters and the spill
    event queue reflecting the round trip."""
    store = ObjectStore(capacity_bytes=4 << 20, spill_dir=str(tmp_path))
    reader = ObjectReader()
    try:
        src = np.random.default_rng(7).integers(
            0, 255, size=1 << 20, dtype=np.uint8)
        oid = _lazy_put(store, src)
        with store._lock:
            store._capacity = 1 << 16
            store._ensure_capacity(0)
        e = store._entries[oid]
        assert e.spilled_path is not None and e.lazy is None
        assert store.stats()["num_materialized"] == 0, (
            "lazy spill took a detour through shm")
        meta = store.get_meta(oid)          # restore-on-get
        assert meta is not None and not (meta.flags & ObjectMeta.SPILLED)
        out = reader.load(meta)
        assert np.array_equal(out, src)
        stats = store.stats()
        assert stats["spilled_bytes_total"] >= src.nbytes
        assert stats["restored_bytes_total"] >= src.nbytes
        kinds = [k for (k, _o, _s) in store.drain_spill_events()]
        assert kinds == ["spill", "restore"]
    finally:
        reader.close()
        store.shutdown()


# --------------------------------------------- pressure integration + events

def test_larger_than_arena_workload_spills_with_metrics(rtpu_init):
    """A working set larger than the whole arena stays bit-correct via
    spill-to-disk, and the pressure is observable: the spilled-bytes
    counter grows and attributed OBJECT_SPILLED events are recorded."""
    node = ray_tpu_torch._global_node
    node.store._capacity = 4 << 20
    refs = [ray_tpu_torch.put(np.full(1 << 20, i, dtype=np.uint8))
            for i in range(12)]             # 12MB through a 4MB budget
    assert node.store.stats()["num_spilled"] > 0
    node._drain_spill_events()              # what _on_tick does
    snap = telemetry.snapshot_local()["counters"]
    spilled = sum(v for (name, _t), v in snap.items()
                  if name == "rtpu_object_spilled_bytes_total")
    assert spilled > 0
    from ray_tpu_torch.state import api as sapi
    labels = [e.get("label") for e in sapi.list_cluster_events()]
    assert "OBJECT_SPILLED" in labels
    for i, r in enumerate(refs):            # every value restores intact
        arr = ray_tpu_torch.get(r, timeout=60)
        assert arr[0] == i and arr[-1] == i and len(arr) == 1 << 20
    node._drain_spill_events()
    assert "OBJECT_RESTORED" in [e.get("label")
                                 for e in sapi.list_cluster_events()]


# ------------------------------------------------------------ crash reaping

_CRASH_SRC = r"""
import json, os, sys
import numpy as np
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import ObjectStore
from ray_tpu_torch._private.serialization import serialize, serialized_size

store = ObjectStore(capacity_bytes=8 << 20, spill_dir=sys.argv[1])
smeta, views = serialize(np.ones(1 << 20, dtype=np.uint8))
oid = ObjectID.from_random()
store.put_lazy(oid, smeta, views, serialized_size(smeta, views))
store.get_meta(oid)                       # materialize into the arena
big = ObjectID.from_random()
mv = store.create(big, 1 << 20)           # private segment too
mv[:] = b"x" * (1 << 20)
store.seal(big)
print(json.dumps({"manifest": store._manifest_path,
                  "arena": store._arena.path if store._arena else None,
                  "segment": store._entries[big].meta.shm_name}),
      flush=True)
os.kill(os.getpid(), 9)                   # simulate a node crash
"""


def test_sigkill_owner_leaves_no_orphan_shm(tmp_path):
    """A SIGKILL'd store must not leak /dev/shm: the crash manifest
    survives the kill and the next store boot reaps the dead owner's
    arena + segments + manifest."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _CRASH_SRC, str(tmp_path)],
        stdout=subprocess.PIPE, env=env)
    line = proc.stdout.readline()
    proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    import json
    left = json.loads(line)
    orphans = [p for p in (left["manifest"], left["arena"],
                           "/dev/shm/" + left["segment"]) if p]
    # SIGKILL means no atexit ran: the artifacts really are on disk
    assert all(os.path.exists(p) for p in orphans), orphans
    assert reap_orphan_shm() >= 1
    assert not any(os.path.exists(p) for p in orphans), (
        "reap left orphaned shm behind")


def test_reap_skips_live_owner(tmp_path):
    """reap_orphan_shm() must never touch a store whose owner process is
    still alive (same pid AND same start-time incarnation)."""
    store = ObjectStore(capacity_bytes=4 << 20, spill_dir=str(tmp_path))
    try:
        oid = _lazy_put(store, np.ones(1 << 20, dtype=np.uint8))
        store.get_meta(oid)               # materialize → arena on disk
        reap_orphan_shm()
        assert store._manifest_path and os.path.exists(store._manifest_path)
        if store._arena is not None:
            assert os.path.exists(store._arena.path)
        meta = store.get_meta(oid)
        assert meta is not None and meta.has_value()
    finally:
        store.shutdown()


# ------------------------------------------- spilled objects across OS nodes

@pytest.fixture
def tiny_store_tcp_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(
        initialize_head=True, process_isolated=True,
        head_node_args={"num_cpus": 2,
                        "env": {"RTPU_OBJECT_STORE_SHM_MAX_BYTES":
                                str(3 << 20)}})
    ray_tpu_torch.init(address=cluster)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_remote_get_of_spilled_object_across_os_nodes(tiny_store_tcp_cluster):
    """End to end across OS processes AND simulated hosts: the head's
    3MB store spills under a larger working set; a node on a different
    "host" (no shared /dev/shm) then pulls a spilled object — restore at
    the owner, payload over the wire, bit-correct at the consumer."""
    cluster = tiny_store_tcp_cluster
    cluster.add_node(num_cpus=2, resources={"far": 2.0},
                     env={"RTPU_NODE_HOST": "simulated-other-host"})
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if len([x for x in ray_tpu_torch.nodes() if x["alive"]]) >= 2:
            break
        time.sleep(0.2)

    refs = [ray_tpu_torch.put(np.full(1 << 20, i, dtype=np.uint8))
            for i in range(6)]              # 6MB through a 3MB head store

    from ray_tpu_torch.state import api as sapi

    def _spill_events():
        return [e for e in sapi.list_cluster_events()
                if e.get("label") == "OBJECT_SPILLED"]

    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not _spill_events():
        time.sleep(0.3)                     # head tick drains the queue
    assert _spill_events(), "head store never spilled / never reported it"

    @ray_tpu_torch.remote(resources={"far": 1.0})
    def probe(x):
        return int(x[0]), int(x[-1]), len(x)

    # the coldest entries spilled first: read them from the far host
    for i in (0, 1, len(refs) - 1):
        first, last, n = ray_tpu_torch.get(probe.remote(refs[i]), timeout=60)
        assert (first, last, n) == (i, i, 1 << 20)
