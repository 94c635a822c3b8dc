# A copy of tests/test_core_basic.py on ray_tpu_torch's runtime: the same tests
# under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown.
# Not copied again: test_put_get, test_put_get_large_numpy,
# test_task_with_ref_args, test_multiple_returns, test_task_error_propagates,
# test_error_through_dependency, test_cancel_pending_task,
# test_object_spilling, test_spec_wire_roundtrip (already held in another
# tests/test_torch_*.py under the same name).
"""Core task/object API tests (reference analogue:
``python/ray/tests/test_basic.py``)."""

import time

import numpy as np
import pytest

import ray_tpu_torch
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


@ray_tpu_torch.remote
def add(a, b):
    return a + b


@ray_tpu_torch.remote
def echo(x):
    return x



def test_simple_task(rtpu_init):
    ref = add.remote(1, 2)
    assert ray_tpu_torch.get(ref) == 3



def test_many_tasks(rtpu_init):
    refs = [add.remote(i, i) for i in range(50)]
    assert ray_tpu_torch.get(refs) == [2 * i for i in range(50)]


def test_task_kwargs(rtpu_init):
    @ray_tpu_torch.remote
    def f(a, b=1, c=2):
        return a + b + c

    assert ray_tpu_torch.get(f.remote(1, c=10)) == 12


def test_large_args_and_returns(rtpu_init):
    arr = np.ones((512, 512), dtype=np.float64)

    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    out = ray_tpu_torch.get(double.remote(arr))
    assert out.shape == arr.shape
    assert out[0, 0] == 2.0



def test_nested_tasks(rtpu_init):
    @ray_tpu_torch.remote
    def outer(n):
        refs = [add.remote(i, 1) for i in range(n)]
        return sum(ray_tpu_torch.get(refs))

    assert ray_tpu_torch.get(outer.remote(4)) == 1 + 2 + 3 + 4


def test_nested_object_ref_in_value(rtpu_init):
    inner_ref = ray_tpu_torch.put(7)

    @ray_tpu_torch.remote
    def deref(box):
        return ray_tpu_torch.get(box["ref"]) + 1

    assert ray_tpu_torch.get(deref.remote({"ref": inner_ref})) == 8


def test_wait(rtpu_init):
    @ray_tpu_torch.remote
    def fast():
        return "fast"

    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, pending = ray_tpu_torch.wait([f, s], num_returns=1, timeout=10)
    assert ready == [f]
    assert pending == [s]


def test_wait_timeout(rtpu_init):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(30)

    ref = slow.remote()
    t0 = time.time()
    ready, pending = ray_tpu_torch.wait([ref], num_returns=1, timeout=0.5)
    assert time.time() - t0 < 5
    assert ready == []
    assert pending == [ref]


def test_get_timeout(rtpu_init):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(30)

    with pytest.raises(ray_tpu_torch.exceptions.GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=0.5)


def test_cluster_resources(rtpu_init):
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 4.0
    assert len(ray_tpu_torch.nodes()) == 1


def test_runtime_context_in_task(rtpu_init):
    @ray_tpu_torch.remote
    def whoami():
        ctx = ray_tpu_torch.get_runtime_context()
        return ctx.in_worker, ctx.get_task_id() is not None

    assert ray_tpu_torch.get(whoami.remote()) == (True, True)


def test_num_cpus_zero_tasks(rtpu_init):
    @ray_tpu_torch.remote(num_cpus=0)
    def cheap():
        return 1

    assert ray_tpu_torch.get([cheap.remote() for _ in range(10)]) == [1] * 10



def test_spilled_object_cross_node(rtpu_cluster):
    """A spilled object must restore when read from another node
    (regression: spilling blanked the directory-shared meta)."""
    import numpy as np
    from ray_tpu_torch._private.scheduler import NodeAffinitySchedulingStrategy

    node_b = rtpu_cluster.add_node(num_cpus=2, resources={"B": 1.0})
    head = rtpu_cluster.head

    @ray_tpu_torch.remote
    def produce():
        return np.arange(512 * 1024, dtype=np.uint8)

    pin_head = NodeAffinitySchedulingStrategy(node_id=head.node_id)
    ref = produce.options(scheduling_strategy=pin_head).remote()
    ray_tpu_torch.wait([ref], timeout=20)
    # force the head store to spill it (lock: _ensure_capacity's contract)
    with head.store._lock:
        head.store._capacity = 1 << 16
        head.store._ensure_capacity(1 << 16)
    assert head.store.stats()["num_spilled"] > 0

    @ray_tpu_torch.remote(resources={"B": 1.0})
    def consume(a):
        return int(a.sum())

    got = ray_tpu_torch.get(consume.remote(ref), timeout=30)
    assert got == int(np.arange(512 * 1024, dtype=np.uint8).sum())


@ray_tpu_torch.remote
def _nested_child(x):
    return x * 2


@ray_tpu_torch.remote
def _nested_parent(x):
    # blocks in get() while holding a CPU; the node must release it so
    # the child can run (reference: NotifyDirectCallTaskBlocked)
    return ray_tpu_torch.get(_nested_child.remote(x)) + 1


def test_nested_tasks_saturating_cpus_no_deadlock():
    ray_tpu_torch.init(num_cpus=2)
    try:
        # both CPUs held by parents; children only run because blocked
        # parents return their CPUs
        out = ray_tpu_torch.get([_nested_parent.remote(i) for i in range(2)],
                                timeout=60)
        assert out == [1, 3]
        # deeper: a chain parent -> child -> grandchild on ONE cpu
        @ray_tpu_torch.remote
        def chain(depth):
            if depth == 0:
                return 0
            return ray_tpu_torch.get(chain.remote(depth - 1)) + 1

        assert ray_tpu_torch.get(chain.options(num_cpus=2).remote(3),
                                 timeout=60) == 3
    finally:
        ray_tpu_torch.shutdown()


def test_accelerator_slot_assignment():
    """Whole-card GPU demands get exclusive per-instance slot ids
    (reference: resource-instance ids / GPU id assignment)."""
    import time as _time

    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        def which_chip():
            import ray_tpu_torch as rt
            _time.sleep(0.5)          # force concurrent occupancy
            return rt.get_runtime_context().get_accelerator_ids()["GPU"]

        a, b = ray_tpu_torch.get([which_chip.remote(), which_chip.remote()],
                                 timeout=60)
        assert sorted(a + b) == [0, 1]    # disjoint exclusive slots

        # slots recycle once released
        c = ray_tpu_torch.get(which_chip.remote(), timeout=60)
        assert c in ([0], [1])

        # a two-chip task owns both
        @ray_tpu_torch.remote(num_gpus=2)
        def both():
            import ray_tpu_torch as rt
            return rt.get_runtime_context().get_accelerator_ids()["GPU"]

        assert sorted(ray_tpu_torch.get(both.remote(), timeout=60)) == [0, 1]

        # actors hold their slots for their lifetime
        @ray_tpu_torch.remote(num_gpus=1)
        class Chip:
            def ids(self):
                import ray_tpu_torch as rt
                return rt.get_runtime_context().get_accelerator_ids()["GPU"]

        holder = Chip.remote()
        held = ray_tpu_torch.get(holder.ids.remote(), timeout=60)
        assert held in ([0], [1])
        # with one chip held, a 2-chip task has no feasible slots but a
        # 1-chip task gets the other id
        other = ray_tpu_torch.get(which_chip.remote(), timeout=60)
        assert other != held and other in ([0], [1])

        # driver context: no slots
        assert ray_tpu_torch.get_runtime_context().get_accelerator_ids() == \
            {"GPU": []}
    finally:
        ray_tpu_torch.shutdown()


