"""Autoscaler on ray_tpu_torch (copies of tests/test_autoscaler.py, and a
GPU node type): demand-driven scale-up, idle drain.

Reference analogues: ``autoscaler/_private/autoscaler.py:171`` +
``fake_multi_node/node_provider.py:237``; tests modeled on
``python/ray/tests/test_autoscaler_fake_multinode.py``.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (AutoscalerConfig, FakeNodeProvider,
                                NodeType, StandardAutoscaler)
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture
def autoscaling_cluster():
    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=cluster,
                 _system_config={"infeasible_task_grace_s": 120.0})
    provider = FakeNodeProvider(cluster)
    config = AutoscalerConfig(
        node_types={
            "tpu_worker": NodeType(resources={"CPU": 4.0, "TPU": 4.0},
                                   min_workers=0, max_workers=5),
        },
        idle_timeout_s=3.0,
        update_interval_s=0.4,
    )
    scaler = StandardAutoscaler(cluster.gcs, provider, config)
    scaler.start()
    yield cluster, provider, scaler
    scaler.stop()
    ray_tpu_torch.shutdown()
    from ray_tpu_torch._private.config import CONFIG
    CONFIG.reload()
    cluster.shutdown()
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


def _alive_nodes(cluster):
    return [n for n in cluster.gcs.alive_nodes()]


def test_scale_up_then_idle_drain(autoscaling_cluster):
    cluster, provider, scaler = autoscaling_cluster

    @ray_tpu_torch.remote(num_cpus=0, resources={"TPU": 1.0})
    def tpu_task(i):
        time.sleep(0.3)
        return i

    # 20 queued TPU-demand tasks; the head has no TPU -> must scale up
    refs = [tpu_task.remote(i) for i in range(20)]
    out = ray_tpu_torch.get(refs, timeout=120)
    assert sorted(out) == list(range(20))
    assert scaler.num_launched >= 1
    assert len(provider.non_terminated_nodes()) >= 1

    # demand gone: autoscaled nodes drain after the idle cooldown
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if not provider.non_terminated_nodes():
            break
        time.sleep(0.3)
    assert not provider.non_terminated_nodes(), "idle nodes never drained"
    assert scaler.num_terminated >= 1
    assert len(_alive_nodes(cluster)) == 1        # the head survives


def test_scale_up_respects_max_workers(autoscaling_cluster):
    cluster, provider, scaler = autoscaling_cluster

    @ray_tpu_torch.remote(num_cpus=0, resources={"TPU": 4.0})
    def big(i):
        time.sleep(0.5)
        return i

    # 40 whole-node shapes, but max_workers=5 caps the fleet
    refs = [big.remote(i) for i in range(40)]
    deadline = time.monotonic() + 30
    peak = 0
    while time.monotonic() < deadline:
        peak = max(peak, len(provider.non_terminated_nodes()))
        time.sleep(0.2)
    assert 1 <= peak <= 5
    assert sorted(ray_tpu_torch.get(refs, timeout=120)) == list(range(40))


def test_min_workers_kept_warm(autoscaling_cluster):
    cluster, provider, scaler = autoscaling_cluster
    scaler.config.node_types["tpu_worker"].min_workers = 1
    provider.create_node("tpu_worker", {"CPU": 4.0, "TPU": 4.0}, {})
    time.sleep(scaler.config.idle_timeout_s + 2.0)
    # idle well past the timeout, but min_workers floors the pool
    assert len(provider.non_terminated_nodes()) == 1


def _wait(pred, timeout=45.0, interval=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def test_strict_spread_pg_scales_up_n_nodes(autoscaling_cluster):
    """A pending STRICT_SPREAD gang that fits no current node must
    launch one node PER BUNDLE (reference:
    ``resource_demand_scheduler.py:102`` pending-PG demand)."""
    cluster, provider, scaler = autoscaling_cluster
    from ray_tpu_torch.util.placement_group import (placement_group,
                                              remove_placement_group)

    # head has no TPU: 3 distinct TPU nodes are needed
    pg = placement_group([{"TPU": 2.0}] * 3, strategy="STRICT_SPREAD")
    pg.ready(timeout=90)
    # ready() can precede the provider's bookkeeping: a node serves the
    # cluster as soon as it registers, while create_node is still
    # finishing worker prestart — poll briefly
    deadline = time.monotonic() + 30
    nodes = provider.non_terminated_nodes()
    while len(nodes) < 3 and time.monotonic() < deadline:
        time.sleep(0.2)
        nodes = provider.non_terminated_nodes()
    assert len(nodes) == 3, f"expected 3 gang nodes, got {len(nodes)}"
    # bundles landed on distinct nodes
    assignment = pg._assignment
    assert len({nid for nid in assignment}) == 3
    remove_placement_group(pg)


def test_strict_pack_pg_scales_up_one_node(autoscaling_cluster):
    cluster, provider, scaler = autoscaling_cluster
    from ray_tpu_torch.util.placement_group import (placement_group,
                                              remove_placement_group)

    # sum of bundles fits ONE tpu_worker (4 TPU): one launch, not two
    pg = placement_group([{"TPU": 2.0}, {"TPU": 2.0}],
                         strategy="STRICT_PACK")
    pg.ready(timeout=90)
    # ready() can precede the provider's bookkeeping: a node serves the
    # cluster (and the gang reserves on it) the moment it REGISTERS,
    # while create_node is still finishing worker prestart and has not
    # appended its provider record yet — poll briefly (the recurring
    # tier-1 flake: the assert raced that window)
    assert _wait(lambda: len(provider.non_terminated_nodes()) == 1)
    assert len(provider.non_terminated_nodes()) == 1
    assert len({nid for nid in pg._assignment}) == 1
    remove_placement_group(pg)


def test_pack_pg_best_effort_scales(autoscaling_cluster):
    cluster, provider, scaler = autoscaling_cluster
    from ray_tpu_torch.util.placement_group import (placement_group,
                                              remove_placement_group)

    # 6 TPU total > one 4-TPU worker: PACK may span nodes; needs 2
    pg = placement_group([{"TPU": 3.0}, {"TPU": 3.0}], strategy="PACK")
    pg.ready(timeout=90)
    # same provider-bookkeeping race as above: the gang reserved on the
    # second node while its create_node was still mid-prestart, so the
    # provider list can momentarily show 1 — poll, then assert exact
    assert _wait(lambda: len(provider.non_terminated_nodes()) == 2)
    assert len(provider.non_terminated_nodes()) == 2
    remove_placement_group(pg)


def test_satisfied_pg_stops_driving_scaleup(autoscaling_cluster):
    """Once the gang reserves, its pending record is cleared: no extra
    nodes keep launching."""
    cluster, provider, scaler = autoscaling_cluster
    from ray_tpu_torch.util.placement_group import (placement_group,
                                              remove_placement_group)

    pg = placement_group([{"TPU": 1.0}], strategy="PACK")
    pg.ready(timeout=90)
    # a tick that read the pending record just before the gang reserved
    # can still be mid-create_node when ready() returns (its
    # num_launched increment lands ~1s later) — that single in-flight
    # racer is not "continued scaling"; poll for quiescence first, then
    # hold the scaler to zero further launches
    last = -1
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and scaler.num_launched != last:
        last = scaler.num_launched
        time.sleep(3 * scaler.config.update_interval_s + 0.5)
    launched = scaler.num_launched
    time.sleep(3 * scaler.config.update_interval_s + 0.5)
    assert scaler.num_launched == launched, "kept scaling for a placed PG"
    assert not cluster.gcs.pending_pgs_snapshot()
    remove_placement_group(pg)


def test_stale_pending_pg_ignored(autoscaling_cluster):
    """A pending record whose driver stopped retrying must not drive
    scale-up (the record goes stale)."""
    cluster, provider, scaler = autoscaling_cluster
    from ray_tpu_torch._private import protocol as P
    from ray_tpu_torch._private.ids import PlacementGroupID

    spec = P.PlacementGroupSpec(pg_id=PlacementGroupID.from_random(),
                                bundles=[{"TPU": 2.0}], strategy="PACK")
    cluster.gcs.register_pending_pg(spec)
    # age it past the staleness bar without refreshing
    rec = cluster.gcs.pending_pgs[spec.pg_id]
    rec["last_attempt"] -= scaler.PENDING_PG_STALE_S + 1
    before = scaler.num_launched
    time.sleep(3 * scaler.config.update_interval_s + 0.5)
    assert scaler.num_launched == before, "stale gang drove scale-up"


def test_pending_pg_blocks_idle_drain(autoscaling_cluster):
    """Capacity is kept while a fresh gang is pending, even if current
    nodes are idle (the gang may be waiting on the LAST node)."""
    cluster, provider, scaler = autoscaling_cluster
    from ray_tpu_torch.util.placement_group import (placement_group,
                                              remove_placement_group)

    # place a 1-bundle PG to get one node up, then keep a second,
    # unsatisfiable gang pending: the idle node must NOT drain
    pg = placement_group([{"TPU": 4.0}], strategy="PACK")
    pg.ready(timeout=90)
    # ready() can precede the provider's bookkeeping (the gang reserves
    # the moment the node REGISTERS, while create_node is still
    # mid-prestart) — poll out the recurring flake before asserting
    assert _wait(lambda: len(provider.non_terminated_nodes()) == 1)
    remove_placement_group(pg)     # node now fully idle

    scaler.config.node_types["tpu_worker"].max_workers = 1  # pin fleet
    import threading
    big = placement_group([{"TPU": 4.0}] * 3, strategy="STRICT_SPREAD")
    stop = threading.Event()

    def keep_retrying():
        while not stop.is_set():
            big._try_create()
            time.sleep(0.3)

    t = threading.Thread(target=keep_retrying, daemon=True)
    t.start()
    try:
        time.sleep(scaler.config.idle_timeout_s + 2.0)
        assert len(provider.non_terminated_nodes()) == 1, \
            "idle node drained while a gang was pending"
    finally:
        stop.set()
        t.join()


def test_gpu_node_type_scales_up_and_drains():
    """A node type with a "GPU" entry: its resources become the new node's
    GPU slots, so a queued num_gpus=1 task launches one node (max_workers
    1), runs on its slot (CUDA_VISIBLE_DEVICES "0", no card needed: slots
    are a resource), and the idle node drains; the head has no GPU."""
    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=cluster,
                       _system_config={"infeasible_task_grace_s": 120.0})
    provider = FakeNodeProvider(cluster)
    config = AutoscalerConfig(
        node_types={"gpu_worker": NodeType(resources={"CPU": 2.0,
                                                      "GPU": 1.0},
                                           min_workers=0, max_workers=1)},
        idle_timeout_s=2.0, update_interval_s=0.4)
    scaler = StandardAutoscaler(cluster.gcs, provider, config)
    scaler.start()
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()

        @ray_tpu_torch.remote(num_gpus=1)
        def on_card(i):
            import os

            import ray_tpu_torch as rt
            time.sleep(0.2)
            return (i, os.environ.get("CUDA_VISIBLE_DEVICES"),
                    rt.get_runtime_context().get_accelerator_ids()["GPU"])

        out = ray_tpu_torch.get([on_card.remote(i) for i in range(4)],
                                timeout=120)
        assert out == [(i, "0", [0]) for i in range(4)]
        assert scaler.num_launched == 1
        (node,) = provider.non_terminated_nodes()
        assert provider.node_type_of(node) == "gpu_worker"
        assert node["node"].resources_total["GPU"] == 1.0

        assert _wait(lambda: not provider.non_terminated_nodes(),
                     timeout=60), "the idle GPU node never drained"
        assert scaler.num_terminated == 1
        assert len(_alive_nodes(cluster)) == 1
    finally:
        scaler.stop()
        ray_tpu_torch.shutdown()
        from ray_tpu_torch._private.config import CONFIG
        CONFIG.reload()
        cluster.shutdown()
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []
