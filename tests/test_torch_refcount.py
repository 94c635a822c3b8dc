# A copy of tests/test_refcount.py on ray_tpu_torch's runtime: the same tests
# under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown.
# Not copied again: test_object_freed_when_last_ref_dies (already held in
# another tests/test_torch_*.py under the same name).
"""Distributed reference counting + lineage reconstruction.

Reference analogues: ``src/ray/core_worker/reference_count.h:61`` (local
refs, submitted-task refs, borrowers) and
``object_recovery_manager.h:90`` (rebuild lost objects by resubmitting
the creating task); tests modeled on
``python/ray/tests/test_reference_counting.py`` and
``test_reconstruction.py``.
"""

import gc
import time

import numpy as np
import pytest

import ray_tpu_torch
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


def _wait_until(pred, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {msg}")


def _store_has(node, oid) -> bool:
    return node.store.contains(oid)



def test_refs_nested_in_returns_survive_producer_drop(rtpu_init):
    """A ref that lives only INSIDE a not-yet-deserialized return must
    keep its object alive past the producer worker's local drops + the
    zero-grace window (regression: push-based shuffle chunk refs were
    freed before the driver ever unpickled the map results, deadlocking
    random_shuffle)."""
    @ray_tpu_torch.remote
    def make():
        return [ray_tpu_torch.put(np.arange(10))]

    result_ref = make.remote()
    # let the producer finish, drop its locals, and the grace expire
    # long before the driver looks at the result
    time.sleep(1.0)
    inner = ray_tpu_torch.get(result_ref)[0]
    val = ray_tpu_torch.get(inner, timeout=10)
    assert list(val) == list(range(10))
    # once BOTH the return and the inner ref die, the nested object is
    # garbage and must actually be freed (pins released)
    oid = inner.id
    node = ray_tpu_torch._global_node
    del inner, val, result_ref
    gc.collect()
    _wait_until(lambda: not _store_has(node, oid),
                msg="nested object freed after pins release")


def test_refs_nested_in_put_survive_local_drop(rtpu_init):
    """Same class of bug via put(): a ref stored INSIDE a put object
    must outlive the caller's own Python ref to it."""
    inner = ray_tpu_torch.put(np.arange(6))
    outer = ray_tpu_torch.put([inner])
    inner_oid = inner.id
    del inner
    gc.collect()
    time.sleep(1.0)     # local drop + grace expire with only the
    #                     containment edge keeping the object alive
    fetched = ray_tpu_torch.get(outer)[0]
    assert list(ray_tpu_torch.get(fetched, timeout=10)) == list(range(6))
    node = ray_tpu_torch._global_node
    del fetched, outer
    gc.collect()
    _wait_until(lambda: not _store_has(node, inner_oid),
                msg="nested put object freed after container dies")


def test_task_args_pin_object(rtpu_init):
    """Dropping the last Python ref right after submission must not free
    the object out from under the in-flight task."""

    @ray_tpu_torch.remote
    def slow_sum(x):
        time.sleep(1.0)
        return float(x.sum())

    data = np.ones(150_000)
    ref = ray_tpu_torch.put(data)
    out = slow_sum.remote(ref)
    del ref
    gc.collect()
    assert ray_tpu_torch.get(out, timeout=60) == 150_000.0


def test_borrower_keeps_object_alive(rtpu_init):
    """An actor storing a ref borrows it: the object must outlive the
    owner's local ref (reference: borrower forwarding)."""
    node = ray_tpu_torch._global_node

    @ray_tpu_torch.remote
    class Holder:
        def __init__(self):
            self.ref = None

        def hold(self, refs):
            self.ref = refs[0]
            return True

        def read(self):
            return float(ray_tpu_torch.get(self.ref).sum())

        def release(self):
            self.ref = None
            return True

    h = Holder.remote()
    ref = ray_tpu_torch.put(np.ones(120_000))
    oid = ref.id
    # pass the ref INSIDE a container so it travels by serialization
    # (borrow registered at unpickle), not as a resolved dependency
    assert ray_tpu_torch.get(h.hold.remote([ref]), timeout=60) in (True,)
    del ref
    gc.collect()
    time.sleep(1.0)                       # let any (wrong) free land
    assert _store_has(node, oid), "borrowed object was freed"
    assert ray_tpu_torch.get(h.read.remote(), timeout=60) == 120_000.0
    # actor releases its borrow -> now it can die
    ray_tpu_torch.get(h.release.remote(), timeout=60)
    _wait_until(lambda: not _store_has(node, oid),
                msg="object freed after borrower released")


def test_lost_object_reconstructed_from_lineage(rtpu_init):
    """Simulate a lost copy (evicted/crashed owner): get() must resubmit
    the creating task transparently."""
    node = ray_tpu_torch._global_node

    @ray_tpu_torch.remote
    def produce(seed):
        return np.full(130_000, float(seed))

    ref = produce.remote(7)
    first = ray_tpu_torch.get(ref, timeout=60)
    assert first[0] == 7.0
    # vaporize the value: remove from store AND directory (as if the
    # owning node died / the copy was evicted)
    node.store.free([ref.id])
    node.gcs.drop_location(ref.id)
    assert not node.store.contains(ref.id)
    again = ray_tpu_torch.get(ref, timeout=60)
    assert again[0] == 7.0 and again.shape == (130_000,)


def test_recursive_lineage_reconstruction(rtpu_init):
    """A lost object whose creating task's own args are also lost must
    rebuild the whole chain."""
    node = ray_tpu_torch._global_node

    @ray_tpu_torch.remote
    def base():
        return np.arange(110_000, dtype=np.float64)

    @ray_tpu_torch.remote
    def double(x):
        return x * 2.0

    b = base.remote()
    d = double.remote(b)
    assert ray_tpu_torch.get(d, timeout=60)[1] == 2.0
    # lose BOTH objects
    for r in (b, d):
        node.store.free([r.id])
        node.gcs.drop_location(r.id)
    out = ray_tpu_torch.get(d, timeout=60)
    assert out[1] == 2.0 and out[100_000] == 200_000.0


def test_reconstruction_after_node_death(rtpu_cluster):
    """The original reconstruction story: the node holding the only copy
    dies; a waiter's get() rebuilds the object elsewhere."""
    cluster = rtpu_cluster
    worker_node = cluster.add_node(num_cpus=2, resources={"side": 2.0})

    @ray_tpu_torch.remote(max_retries=2, resources={"side": 0.001})
    def produce():
        return np.full(140_000, 3.25)

    ref = produce.remote()
    assert ray_tpu_torch.get(ref, timeout=60)[0] == 3.25
    cluster.remove_node(worker_node)      # only copy dies with the node
    # resources "side" are gone, but reconstruction should still run the
    # task? No — it needs side resources. Add a replacement node first.
    cluster.add_node(num_cpus=2, resources={"side": 2.0})
    out = ray_tpu_torch.get(ref, timeout=60)
    assert out[0] == 3.25 and out.shape == (140_000,)


def test_fire_and_forget_return_is_not_leaked(rtpu_init):
    """Refs dropped before the task seals its return: the seal must free
    the value instead of leaking it forever."""
    node = ray_tpu_torch._global_node

    @ray_tpu_torch.remote
    def produce():
        time.sleep(0.8)
        return np.zeros(120_000)

    ref = produce.remote()
    oid = ref.id
    del ref                       # dropped while the task is in flight
    gc.collect()
    time.sleep(1.5)               # task finishes and seals
    _wait_until(lambda: not _store_has(node, oid),
                msg="fire-and-forget return freed after seal")
    assert node.gcs.lookup_location(oid) is None


def test_pending_dependency_does_not_duplicate_execution(rtpu_init):
    """A consumer waiting on a not-yet-finished producer must never
    trigger a lineage 'reconstruction' of the in-flight task."""

    @ray_tpu_torch.remote
    class Count:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def value(self):
            return self.n

    counter = Count.options(name="dup_guard").remote()

    @ray_tpu_torch.remote
    def produce():
        c = ray_tpu_torch.get_actor("dup_guard")
        ray_tpu_torch.get(c.incr.remote())
        time.sleep(1.0)
        return 42

    @ray_tpu_torch.remote
    def consume(x):
        return x + 1

    # consumer queues immediately with an unresolved dep on the slow
    # producer; get()/wait() also probe the missing object
    ref = produce.remote()
    out = consume.remote(ref)
    ray_tpu_torch.wait([ref], num_returns=0, timeout=0.1)
    assert ray_tpu_torch.get(out, timeout=60) == 43
    time.sleep(0.5)
    assert ray_tpu_torch.get(counter.value.remote(), timeout=60) == 1, (
        "producer executed more than once")


def test_owner_routed_lookup_skips_head_directory():
    """Owner-based location resolution (reference:
    ownership_based_object_directory.h): getting a task's return from
    the node that ran it costs ZERO head directory lookups — the
    submitting node remembers where the task ran and reads that store
    directly (VERDICT r04 ask #3, read path)."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 1})
    ray_tpu_torch.init(address=cluster)
    node_b = cluster.add_node(num_cpus=2, resources={"away": 4.0})
    try:
        lookups = []
        orig = cluster.gcs.lookup_location
        cluster.gcs.lookup_location = lambda oid: (
            lookups.append(oid) or orig(oid))

        @ray_tpu_torch.remote(resources={"away": 1.0})
        def produce(n):
            return np.arange(n)

        refs = [produce.remote(50_000 + i) for i in range(4)]
        outs = ray_tpu_torch.get(refs, timeout=60)
        assert [len(o) for o in outs] == [50_000 + i for i in range(4)]
        looked = set(lookups) & {r.id for r in refs}
        assert not looked, (
            f"head directory consulted for {len(looked)} owner-routed "
            "objects")
    finally:
        cluster.gcs.lookup_location = orig
        ray_tpu_torch.shutdown()
        cluster.shutdown()
