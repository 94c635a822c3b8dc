# A copy of tests/test_util.py on ray_tpu_torch's runtime: the same tests under
# the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU slots) and
# the fixtures of torch_runtime_fixtures.py, which also hold the port's locksan
# and fieldsan to no violation at teardown.
# Not copied again: test_placement_group_pack_and_task (already held in another
# tests/test_torch_*.py under the same name).
"""Placement groups, ActorPool, Queue (reference test model:
``python/ray/tests/test_placement_group*.py``, ``test_actor_pool.py``,
``test_queue.py``)."""

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import (ActorPool, PlacementGroup, Queue,
                                PlacementGroupSchedulingStrategy,
                                placement_group, remove_placement_group)
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)



def test_placement_group_strict_spread_infeasible(rtpu_init):
    # single node: STRICT_SPREAD of 2 bundles can't be satisfied
    pg = placement_group([{"CPU": 1}, {"CPU": 1}],
                         strategy="STRICT_SPREAD")
    with pytest.raises(TimeoutError):
        pg.ready(timeout=0.5)


def test_placement_group_strict_spread_cluster(rtpu_cluster):
    cluster = rtpu_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    pg = placement_group([{"CPU": 1}, {"CPU": 1}],
                         strategy="STRICT_SPREAD")
    pg.ready(timeout=10)

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        return ray_tpu_torch.get_runtime_context().node_id

    nodes = set()
    for idx in range(2):
        s = PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=idx)
        nodes.add(ray_tpu_torch.get(where.options(
            scheduling_strategy=s).remote()))
    assert len(nodes) == 2
    remove_placement_group(pg)


def test_pg_releases_resources(rtpu_init):
    before = ray_tpu_torch.available_resources().get("CPU", 0)
    pg = placement_group([{"CPU": 2}]).ready(timeout=10)
    during = ray_tpu_torch.available_resources().get("CPU", 0)
    assert during <= before - 2 + 1e-6
    remove_placement_group(pg)
    import time
    for _ in range(50):
        after = ray_tpu_torch.available_resources().get("CPU", 0)
        if abs(after - before) < 1e-6:
            break
        time.sleep(0.05)
    assert abs(after - before) < 1e-6


def test_actor_pool(rtpu_init):
    @ray_tpu_torch.remote
    class Doubler:
        def double(self, x):
            return 2 * x

    pool = ActorPool([Doubler.remote() for _ in range(2)])
    assert list(pool.map(lambda a, v: a.double.remote(v),
                         range(5))) == [0, 2, 4, 6, 8]
    assert sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                     range(5))) == [0, 2, 4, 6, 8]


def test_queue(rtpu_init):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    with pytest.raises(Exception):
        q.put_nowait(3)
    assert q.get() == 1
    assert q.get() == 2
    assert q.empty()

    # queue handle works from inside tasks
    @ray_tpu_torch.remote
    def producer(q):
        for i in range(3):
            q.put(i)

    q2 = Queue()
    ray_tpu_torch.get(producer.remote(q2))
    assert [q2.get(timeout=5) for _ in range(3)] == [0, 1, 2]
