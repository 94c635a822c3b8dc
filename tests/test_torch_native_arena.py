# A copy of tests/test_native_arena.py on ray_tpu_torch's runtime: the same
# tests under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown. Docstrings leave
# out the JAX package's issue history.
"""Native C++ arena allocator tests (reference model: plasma allocator
tests, ``src/ray/object_manager/plasma/test/``)."""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import native
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native arena did not build")


@pytest.fixture
def arena(tmp_path):
    a = native.Arena(os.path.join("/dev/shm",
                                  f"rtpu_arena_test_{os.getpid()}"),
                     1 << 20)
    yield a
    a.close(unlink=True)


def test_alloc_free_coalesce(arena):
    offs = [arena.alloc(1000) for _ in range(50)]
    assert all(o is not None for o in offs)
    assert arena.num_blocks == 50
    for o in offs:
        arena.free(o)
    assert arena.num_blocks == 0
    assert arena.used == 0
    # after full free, a max-size alloc must succeed (coalesced back)
    big = arena.alloc((1 << 20) - 64)
    assert big is not None
    arena.free(big)


def test_alloc_alignment_and_isolation(arena):
    a = arena.alloc(100)
    b = arena.alloc(100)
    assert a % 64 == 0 and b % 64 == 0
    buf_a = arena.buffer(a, 100)
    buf_b = arena.buffer(b, 100)
    buf_a[:] = b"a" * 100
    buf_b[:] = b"b" * 100
    assert bytes(buf_a) == b"a" * 100      # no overlap


def test_out_of_memory_returns_none(arena):
    assert arena.alloc(2 << 20) is None
    off = arena.alloc(900 * 1024)
    assert off is not None
    assert arena.alloc(900 * 1024) is None  # second won't fit
    arena.free(off)


def test_reader_attach_sees_writes(arena, tmp_path):
    off = arena.alloc(256)
    arena.buffer(off, 256)[:] = bytes(range(256))
    reader = native.ArenaReader(arena.path)
    assert bytes(reader.buffer(off, 256)) == bytes(range(256))
    reader.close()


def test_store_uses_arena_end_to_end(rtpu_init):
    """Large puts flow through the arena; values survive the round trip
    through worker processes."""
    big = np.random.rand(512, 512)          # 2MB > inline threshold
    ref = ray_tpu_torch.put(big)
    np.testing.assert_array_equal(ray_tpu_torch.get(ref), big)

    @ray_tpu_torch.remote
    def echo(x):
        return x * 2.0                       # large return through worker

    out = ray_tpu_torch.get(echo.remote(ref))
    np.testing.assert_allclose(out, big * 2.0)

    # the node store reports live arena blocks
    stats = ray_tpu_torch._global_node.store.stats()
    assert stats["arena_enabled"] == 1
    assert stats.get("arena_num_blocks", 0) >= 1


def test_arena_spill_restore_roundtrip(tmp_path):
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import ObjectStore

    store = ObjectStore(capacity_bytes=4 << 20,
                        spill_dir=str(tmp_path))
    if store._arena is None:
        pytest.skip("arena unavailable")
    payload = os.urandom(1 << 20)
    oids = []
    try:
        for i in range(6):                  # 6MB > 80% of 4MB budget
            oid = ObjectID.from_random()
            ref = store.alloc_in_arena(oid, len(payload))
            assert ref is not None
            store._arena.buffer(ref[1], len(payload))[:] = payload
            from ray_tpu_torch._private.object_store import ObjectMeta
            store.adopt(ObjectMeta(object_id=oid, size=len(payload),
                                   arena_ref=ref))
            oids.append(oid)
        assert store.num_spilled > 0
        # every object still readable (restore path)
        for oid in oids:
            meta = store.get_meta(oid)
            assert meta is not None
            if meta.arena_ref is not None:
                data = bytes(store._arena.buffer(meta.arena_ref[1],
                                                 meta.size))
                assert data == payload
    finally:
        store.shutdown()


def test_free_while_read_quarantines_block(tmp_path):
    """free() of an arena object whose meta was handed to a reader must
    not reuse the block immediately — readers may hold zero-copy views
    (ADVICE r1 #2)."""
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import ObjectMeta, ObjectStore

    store = ObjectStore(capacity_bytes=4 << 20, spill_dir=str(tmp_path))
    if store._arena is None:
        pytest.skip("arena unavailable")
    old = CONFIG._values["arena_free_quarantine_s"]
    CONFIG._values["arena_free_quarantine_s"] = 0.3
    try:
        oid = ObjectID.from_random()
        ref = store.alloc_in_arena(oid, 4096)
        assert ref is not None
        store.adopt(ObjectMeta(object_id=oid, size=4096, arena_ref=ref))
        assert store.get_meta(oid) is not None      # marks ever_read
        store.free([oid])
        # block must be quarantined, not reusable at the same offset
        assert store.stats()["arena_quarantined_blocks"] == 1
        oid2 = ObjectID.from_random()
        ref2 = store.alloc_in_arena(oid2, 4096)
        assert ref2 is not None and ref2[1] != ref[1]
        # after the quarantine window the block returns to the arena
        import time
        time.sleep(0.35)
        oid3 = ObjectID.from_random()
        ref3 = store.alloc_in_arena(oid3, 4096)
        assert ref3 is not None
        assert store.stats()["arena_quarantined_blocks"] == 0
    finally:
        CONFIG._values["arena_free_quarantine_s"] = old
        store.shutdown()


def test_never_read_arena_free_is_immediate(tmp_path):
    """Objects nobody ever read are freed without quarantine."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import ObjectMeta, ObjectStore

    store = ObjectStore(capacity_bytes=4 << 20, spill_dir=str(tmp_path))
    if store._arena is None:
        pytest.skip("arena unavailable")
    try:
        oid = ObjectID.from_random()
        ref = store.alloc_in_arena(oid, 4096)
        store.adopt(ObjectMeta(object_id=oid, size=4096, arena_ref=ref))
        used = store._arena.used
        store.free([oid])
        assert store.stats()["arena_quarantined_blocks"] == 0
        assert store._arena.used < used
    finally:
        store.shutdown()


def test_cross_node_get_marks_owner_read(rtpu_cluster):
    """A remote node's get() must route through the owning store so the
    entry is marked ever_read and can never be spilled-and-freed under a
    live zero-copy reader (ADVICE r1 #1, high)."""
    cluster = rtpu_cluster
    worker_node = cluster.add_node(num_cpus=2, resources={"side": 1.0})

    @ray_tpu_torch.remote(resources={"side": 1.0})
    def produce():
        return np.arange(300_000, dtype=np.float64)  # > inline threshold

    ref = produce.remote()
    arr = ray_tpu_torch.get(ref, timeout=60)
    assert arr[5] == 5.0
    oid = ref.id
    entry = worker_node.store._entries.get(oid)
    if entry is None or entry.meta.arena_ref is None:
        pytest.skip("object not arena-backed on the worker node")
    assert entry.ever_read, (
        "cross-node get() bypassed the owner's read tracking")


# ------------------------------------------------------- mapper refcounts

def _has_refcounts(arena):
    return arena.refcount(0) is not None or \
        getattr(arena._lib, "arena_incref", None) is not None


def test_refcount_incref_decref(arena):
    if not _has_refcounts(arena):
        pytest.skip("library built without refcount symbols")
    off = arena.alloc(4096)
    assert arena.refcount(off) == 0
    assert arena.incref(off) == 1
    assert arena.incref(off) == 2
    assert arena.decref(off) == 1
    assert arena.decref(off) == 0
    # underflow is refused and the count stays clamped at zero
    assert arena.decref(off) is None
    assert arena.refcount(off) == 0
    arena.free(off)
    # freed block: incref must refuse (stale-meta safety)
    assert arena.incref(off) is None


def test_tracked_buffer_holds_and_releases_ref(arena):
    if not _has_refcounts(arena):
        pytest.skip("library built without refcount symbols")
    off = arena.alloc(4096)
    arena.buffer(off, 4096)[:] = b"z" * 4096
    reader = native.ArenaReader(arena.path)
    mv = reader.tracked_buffer(off, 4096)
    assert bytes(mv[:4]) == b"zzzz"
    assert arena.refcount(off) == 1          # owner sees the reader's ref
    view = np.frombuffer(mv, dtype=np.uint8)[100:200]
    del mv
    import gc
    gc.collect()
    assert arena.refcount(off) == 1, (
        "derived view alive but the mapper ref was dropped")
    del view
    gc.collect()
    assert arena.refcount(off) == 0
    arena.free(off)
    with pytest.raises(FileNotFoundError):
        reader.tracked_buffer(off, 4096)     # stale meta → clean refusal
    reader.close()


def test_spill_defers_to_live_mapper_refcount(tmp_path):
    """An ever-read arena entry with a live zero-copy reader (mapper
    refcount > 0) must survive the spill scan; once the ref drops it is
    spillable again."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import ObjectMeta, ObjectStore

    store = ObjectStore(capacity_bytes=4 << 20, spill_dir=str(tmp_path))
    if store._arena is None:
        pytest.skip("arena unavailable")
    if getattr(store._arena._lib, "arena_incref", None) is None:
        store.shutdown()
        pytest.skip("library built without refcount symbols")
    try:
        oid = ObjectID.from_random()
        ref = store.alloc_in_arena(oid, 1 << 20)
        assert ref is not None
        store.adopt(ObjectMeta(object_id=oid, size=1 << 20,
                               arena_ref=ref))
        meta = store.get_meta(oid)           # marks ever_read
        reader = native.ArenaReader(store._arena.path)
        mv = reader.tracked_buffer(meta.arena_ref[1], meta.size)
        with store._lock:
            store._capacity = 1 << 16
            store._ensure_capacity(0)
        e = store._entries[oid]
        assert e.spilled_path is None, (
            "spilled an arena block out from under a live reader")
        del mv
        import gc
        gc.collect()
        with store._lock:
            store._ensure_capacity(0)
        assert e.spilled_path is not None
        reader.close()
    finally:
        store.shutdown()


def test_quarantine_requeues_while_refcount_held(tmp_path):
    """The free quarantine must not release a block whose mapper
    refcount is still nonzero at window expiry — it re-queues for
    another window instead."""
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import ObjectMeta, ObjectStore

    store = ObjectStore(capacity_bytes=4 << 20, spill_dir=str(tmp_path))
    if store._arena is None:
        pytest.skip("arena unavailable")
    if getattr(store._arena._lib, "arena_incref", None) is None:
        store.shutdown()
        pytest.skip("library built without refcount symbols")
    old = CONFIG._values["arena_free_quarantine_s"]
    CONFIG._values["arena_free_quarantine_s"] = 0.2
    try:
        oid = ObjectID.from_random()
        ref = store.alloc_in_arena(oid, 4096)
        store._arena.buffer(ref[1], 4096)[:] = b"q" * 4096
        store.adopt(ObjectMeta(object_id=oid, size=4096, arena_ref=ref))
        meta = store.get_meta(oid)           # ever_read → quarantined free
        reader = native.ArenaReader(store._arena.path)
        mv = reader.tracked_buffer(meta.arena_ref[1], 4096)
        store.free([oid])
        assert store.stats()["arena_quarantined_blocks"] == 1
        import gc
        import time
        time.sleep(0.3)                      # past the window, ref held
        with store._lock:
            store._sweep_quarantine()
        assert store.stats()["arena_quarantined_blocks"] == 1, (
            "quarantine released a block with a live mapper ref")
        assert bytes(mv[:4]) == b"qqqq"      # bytes still intact
        del mv
        gc.collect()
        time.sleep(1.1)          # requeue windows have a 1s floor
        with store._lock:
            store._sweep_quarantine()
        assert store.stats()["arena_quarantined_blocks"] == 0
        reader.close()
    finally:
        CONFIG._values["arena_free_quarantine_s"] = old
        store.shutdown()
