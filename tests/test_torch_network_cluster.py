"""Network plane on ray_tpu_torch (copies of tests/test_network_cluster.py,
with tests/test_torch_network_cluster_chaos.py): OS-isolated node
processes joined over TCP.

Reference analogue: multi-node tests against ``ray start --head`` /
``--address`` clusters (``python/ray/tests/test_multinode_failures.py``
and the gRPC topology of ``gcs_service.proto`` / ``node_manager.proto``).
Every node here is a real subprocess with its own GCS connection; the
driver attaches by ``host:port``.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


def _check_sanitizers():
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


@pytest.fixture
def tcp_cluster():
    cluster = Cluster(initialize_head=True, process_isolated=True,
                      head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=cluster)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()
    _check_sanitizers()


def _wait_for_nodes(n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        alive = [x for x in ray_tpu_torch.nodes() if x["alive"]]
        if len(alive) >= n:
            return alive
        time.sleep(0.2)
    raise TimeoutError(f"never saw {n} alive nodes")


def test_driver_attach_and_tasks(tcp_cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    assert ray_tpu_torch.get(add.remote(2, 3), timeout=60) == 5
    assert ray_tpu_torch.get([add.remote(i, i) for i in range(10)],
                       timeout=60) == [2 * i for i in range(10)]


def test_large_objects_over_shm(tcp_cluster):
    arr = np.random.rand(200_000)
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref, timeout=60)
    assert np.array_equal(out, arr)

    @ray_tpu_torch.remote
    def total(x):
        return float(x.sum())

    assert abs(ray_tpu_torch.get(total.remote(ref), timeout=60)
               - float(arr.sum())) < 1e-6


def test_second_node_joins_and_runs_tasks(tcp_cluster):
    tcp_cluster.add_node(num_cpus=2, resources={"side": 2.0})
    _wait_for_nodes(2)

    @ray_tpu_torch.remote(resources={"side": 1.0})
    def where():
        import os
        return os.getpid()

    # tasks requiring the custom resource must run on the second process
    pids = ray_tpu_torch.get([where.remote() for _ in range(4)], timeout=60)
    assert all(p > 0 for p in pids)

    # cross-node object flow: produce on node 2, consume anywhere
    @ray_tpu_torch.remote(resources={"side": 1.0})
    def produce():
        return np.arange(150_000, dtype=np.float64)

    @ray_tpu_torch.remote
    def consume(x):
        return float(x[-1])

    assert ray_tpu_torch.get(consume.remote(produce.remote()),
                       timeout=60) == 149999.0


def test_actors_across_processes(tcp_cluster):
    tcp_cluster.add_node(num_cpus=2, resources={"side": 2.0})
    _wait_for_nodes(2)

    @ray_tpu_torch.remote(resources={"side": 1.0})
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.options(name="net_counter").remote()
    assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
    assert ray_tpu_torch.get(c.incr.remote(5), timeout=60) == 6
    again = ray_tpu_torch.get_actor("net_counter")
    assert ray_tpu_torch.get(again.incr.remote(), timeout=60) == 7


def test_node_kill_chaos_retriable_tasks(tcp_cluster):
    """SIGKILL a node mid-flight: heartbeat/connection failure detection
    must mark it dead and retriable tasks must finish elsewhere."""
    victim = tcp_cluster.add_node(num_cpus=2, resources={"side": 2.0})
    _wait_for_nodes(2)

    @ray_tpu_torch.remote(max_retries=3)
    def slow(i):
        time.sleep(1.0)
        return i

    # bias toward the victim via its custom resource for half the work
    @ray_tpu_torch.remote(max_retries=3, resources={"side": 0.5})
    def slow_side(i):
        time.sleep(1.0)
        return i

    refs = [slow.remote(i) for i in range(4)]
    refs += [slow_side.remote(i) for i in range(4, 8)]
    time.sleep(0.5)
    tcp_cluster.remove_node(victim)          # hard SIGKILL

    # side-resource tasks can never rerun (resource gone) — only wait on
    # the portable half; they must all complete despite the kill
    out = ray_tpu_torch.get(refs[:4], timeout=90)
    assert out == [0, 1, 2, 3]
    alive = [x for x in ray_tpu_torch.nodes() if x["alive"]]
    assert len(alive) == 1


def test_named_actor_on_dead_node_reports_dead(tcp_cluster):
    victim = tcp_cluster.add_node(num_cpus=2, resources={"side": 2.0})
    _wait_for_nodes(2)

    @ray_tpu_torch.remote(resources={"side": 1.0})
    class A:
        def ping(self):
            return "pong"

    a = A.options(name="doomed").remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    tcp_cluster.remove_node(victim)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get(a.ping.remote(), timeout=10)
        except Exception:
            break
        time.sleep(0.5)
    else:
        pytest.fail("calls to an actor on a SIGKILLed node never failed")


def test_cross_host_object_pull(tcp_cluster):
    """A node claiming a different OS host can't attach the owner's shm;
    objects must be pulled as payload bytes and adopted locally
    (reference: ``object_manager.h:117`` chunked Push/Pull)."""
    tcp_cluster.add_node(num_cpus=2, resources={"far": 2.0},
                         env={"RTPU_NODE_HOST": "simulated-other-host"})
    _wait_for_nodes(2)

    # produce on the "remote host" node, consume on the head's workers —
    # the dependency must cross via OBJ_PULL, not shm
    @ray_tpu_torch.remote(resources={"far": 1.0})
    def produce():
        return np.arange(150_000, dtype=np.float64)

    @ray_tpu_torch.remote
    def consume(x):
        return float(x.sum())

    expect = float(np.arange(150_000, dtype=np.float64).sum())
    assert abs(ray_tpu_torch.get(consume.remote(produce.remote()), timeout=60)
               - expect) < 1e-6

    # and the reverse direction: head-owned arg into a far-host task
    big = np.random.rand(120_000)
    ref = ray_tpu_torch.put(big)

    @ray_tpu_torch.remote(resources={"far": 1.0})
    def consume_far(x):
        return float(x[0])

    assert ray_tpu_torch.get(consume_far.remote(ref),
                       timeout=60) == pytest.approx(float(big[0]))


def test_chaos_under_load_actors_and_objects(tcp_cluster):
    """Sustained load across 3 nodes while one is SIGKILLed: retriable
    tasks finish elsewhere, a restartable actor comes back, and a lost
    object is rebuilt from lineage (reference: chaos node-killer,
    ``_private/test_utils.py:1391``, under real load)."""
    n1 = tcp_cluster.add_node(num_cpus=2, resources={"churn": 4.0})
    tcp_cluster.add_node(num_cpus=2)
    _wait_for_nodes(3)

    @ray_tpu_torch.remote(max_retries=5)
    def work(i):
        time.sleep(0.3)
        return i * i

    @ray_tpu_torch.remote(max_retries=5, resources={"churn": 1.0})
    def churn_work(i):
        time.sleep(0.3)
        return i

    @ray_tpu_torch.remote(max_restarts=3, num_cpus=0)
    class Survivor:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

    # lineage-tracked object created ON the victim node
    seed = churn_work.remote(123)
    assert ray_tpu_torch.get(seed, timeout=60) == 123

    survivor = Survivor.remote()
    assert ray_tpu_torch.get(survivor.bump.remote(), timeout=60) == 1

    # continuous load, half biased onto the victim via its resource
    refs = [work.remote(i) for i in range(12)]
    refs += [churn_work.remote(i) for i in range(4)]
    time.sleep(0.6)
    tcp_cluster.remove_node(n1)              # hard SIGKILL mid-flight

    # portable tasks all complete despite the kill
    assert ray_tpu_torch.get(refs[:12], timeout=120) == [i * i for i in range(12)]

    # the actor keeps serving (restarted if it lived on the victim)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            out = ray_tpu_torch.get(survivor.bump.remote(), timeout=10)
            break
        except Exception:
            time.sleep(0.5)
    else:
        pytest.fail("actor never came back after node kill")
    assert out >= 1

    # the seed object is servable: either its copy survived or lineage
    # reconstruction reruns churn_work — but its resource died with the
    # node, so accept reconstruction failure, not a hang
    try:
        val = ray_tpu_torch.get(seed, timeout=30)
    except Exception:
        pass        # reconstruction may fail (resource died) — just no hang
    else:
        assert val == 123
    alive = [x for x in ray_tpu_torch.nodes() if x["alive"]]
    assert len(alive) == 2


def test_cross_host_chunked_pull_large_object():
    """A pull larger than the transfer chunk streams in bounded frames
    (reference: chunked Push/Pull, ``object_manager.h:117``). Chunk size
    is shrunk to 256KB so a ~4MB array crosses in ~16 chunks."""
    chunk_env = {"RTPU_OBJECT_TRANSFER_CHUNK_BYTES": str(256 * 1024)}
    cluster = Cluster(initialize_head=True, process_isolated=True,
                      head_node_args={"num_cpus": 2, "env": chunk_env})
    try:
        ray_tpu_torch.init(address=cluster)
        cluster.add_node(num_cpus=2, resources={"far": 2.0},
                         env={**chunk_env,
                              "RTPU_NODE_HOST": "simulated-other-host"})
        _wait_for_nodes(2)

        @ray_tpu_torch.remote(resources={"far": 1.0})
        def produce():
            return np.arange(500_000, dtype=np.float64)   # ~4MB

        @ray_tpu_torch.remote
        def consume(x):
            return float(x.sum()), x.shape[0]

        total, n = ray_tpu_torch.get(consume.remote(produce.remote()),
                               timeout=120)
        assert n == 500_000
        assert total == pytest.approx(
            float(np.arange(500_000, dtype=np.float64).sum()))

        # reverse direction too: head-owned 4MB arg into a far task
        big = np.random.rand(500_000)
        ref = ray_tpu_torch.put(big)

        @ray_tpu_torch.remote(resources={"far": 1.0})
        def consume_far(x):
            return float(x.sum())

        assert ray_tpu_torch.get(consume_far.remote(ref), timeout=120) == \
            pytest.approx(float(big.sum()))
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_actor_restarts_on_surviving_node_after_node_death(tcp_cluster):
    """A restartable actor whose NODE is SIGKILLed is re-created on a
    surviving node (reference: GcsActorManager::OnNodeDead actor
    rescheduling) — deterministic placement via soft node affinity."""
    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    victim = tcp_cluster.add_node(num_cpus=2)
    _wait_for_nodes(2)
    victim_id = NodeID.from_hex(victim.node_id_hex)

    @ray_tpu_torch.remote(max_restarts=2, num_cpus=1)
    class Phoenix:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

        def where(self):
            import ray_tpu_torch as rt
            return rt.get_runtime_context().node_id.hex()

    p = Phoenix.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id=victim_id, soft=True)).remote()
    assert ray_tpu_torch.get(p.bump.remote(), timeout=60) == 1
    assert ray_tpu_torch.get(p.where.remote(), timeout=60) == victim.node_id_hex

    tcp_cluster.remove_node(victim)          # SIGKILL the actor's node

    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        try:
            out = ray_tpu_torch.get(p.bump.remote(), timeout=10)
            break
        except Exception:
            time.sleep(0.5)
    else:
        pytest.fail("actor never restarted after its node was killed")
    assert out >= 1                          # fresh state, restarted
    new_home = ray_tpu_torch.get(p.where.remote(), timeout=30)
    assert new_home != victim.node_id_hex


def test_spillback_rescues_starved_task():
    """A task queued behind a long occupant must re-route once capacity
    opens on another node (reference: lease spillback,
    ``cluster_task_manager.cc``) instead of starving while the rest of
    the cluster idles."""
    cluster = Cluster(initialize_head=True, process_isolated=True,
                      head_node_args={"num_cpus": 1})
    cluster.add_node(num_cpus=1)
    ray_tpu_torch.init(address=cluster)
    try:
        @ray_tpu_torch.remote
        def busy(t):
            time.sleep(t)
            return time.time()

        t0 = time.time()
        busy.remote(12.0)                 # fills one node for a long time
        short = busy.remote(2.0)          # fills the other briefly
        time.sleep(0.5)                   # both running: cluster is full
        third = busy.remote(0.0)          # queued behind one of them
        done = ray_tpu_torch.get(third, timeout=30) - t0
        # without spillback there is a ~50% chance third waits 12s on the
        # long node; with it, it must run soon after the short task frees
        assert done < 7.0, f"queued task starved {done:.1f}s"
        ray_tpu_torch.get(short)
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_burst_does_not_pile_on_one_node():
    """Route-time debits: a burst routed within one heartbeat must fan
    out across nodes instead of herding onto the node the stale view
    says is free (RaySyncer-staleness bridge).

    Poll-then-assert: a warm-up burst until every CPU slot holds a warm
    worker, then the gossiped availability back to full (a heartbeat
    snapshotted mid-warm-wave makes peers look busy for up to a beat),
    THEN the measured burst, asserting the routing property directly:
    every task STARTS within 2s of submit — balanced routing (or a
    promptly-spilled straggler) starts in well under a wave, while
    herding's serialized waves put the last start at 4s+. The router
    counts queued-but-undispatched demand against a node's
    availability, so a deferred-dispatch SUBMIT_BATCH does not read
    its own node as free 6 times in a row."""
    cluster = Cluster(initialize_head=True, process_isolated=True,
                      head_node_args={"num_cpus": 2})
    try:
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=2)
        ray_tpu_torch.init(address=cluster)

        @ray_tpu_torch.remote
        def spin(t):
            start = time.time()
            time.sleep(t)
            return start

        _wait_for_nodes(3)
        # poll-then-assert: warm ALL 6 CPU slots' workers first, so the
        # measured burst pays routing + dispatch only, never cold spawn
        deadline = time.monotonic() + 90
        while True:
            t0 = time.time()
            ray_tpu_torch.get([spin.remote(0.5) for _ in range(6)],
                        timeout=60)
            if time.time() - t0 < 2.0:  # one concurrent 0.5s wave: warm
                break
            if time.monotonic() > deadline:
                raise TimeoutError("worker pool never warmed up")
        # ...and poll until every node's GOSSIPED view — the exact view
        # the router consumes — has settled back to idle: full
        # availability AND no queued shapes. A heartbeat snapshotted
        # mid-warm-wave (queued-but-undispatched tasks, busy workers)
        # makes a peer look full for up to a beat and would re-herd
        # the measured burst through no fault of the router.
        while True:
            rows = [n for n in ray_tpu_torch.nodes() if n["alive"]]
            settled = all(
                n["resources_available"].get("CPU", 0.0) >= 2.0
                and not n["pending_shapes"] for n in rows)
            if len(rows) == 3 and settled:
                break
            if time.monotonic() > deadline:
                raise TimeoutError("gossiped availability never settled")
            time.sleep(0.1)
        # 6 tasks == exactly the cluster's CPU capacity, submitted as
        # one burst: with warm workers every task must START promptly —
        # directly routed (one per CPU slot) or spilled within
        # scheduler_spillback_delay_s. Serialized waves (herding without
        # rescue) put the last start at 4s+.
        t_submit = time.time()
        refs = [spin.remote(2.0) for _ in range(6)]
        starts = ray_tpu_torch.get(refs, timeout=60)
        latest = max(starts) - t_submit
        assert latest < 2.0, f"burst serialized: last start {latest:.1f}s"
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_versioned_heartbeat_drops_stale():
    """RaySyncer-equivalent property: a delayed heartbeat frame with an
    older version refreshes liveness but cannot roll the availability
    view back (reference: ray_syncer.h:86)."""
    from ray_tpu_torch._private.gcs import GlobalControlPlane, NodeInfo
    from ray_tpu_torch._private.ids import NodeID

    gcs = GlobalControlPlane()
    nid = NodeID.from_random()
    gcs.register_node(NodeInfo(node_id=nid, address="sock",
                               resources_total={"CPU": 4.0}))
    gcs.heartbeat(nid, {"CPU": 4.0}, version=10)
    gcs.heartbeat(nid, {"CPU": 1.0}, version=12)
    # delayed duplicate from the past: must not overwrite
    gcs.heartbeat(nid, {"CPU": 4.0}, version=11)
    info = gcs.get_node(nid)
    assert info.resources_available == {"CPU": 1.0}
    assert info.resource_version == 12
    # delta ping (no payload) advances the version, keeps the view
    gcs.heartbeat(nid, None, version=13)
    info = gcs.get_node(nid)
    assert info.resources_available == {"CPU": 1.0}
    assert info.resource_version == 13
    # newer payload applies
    gcs.heartbeat(nid, {"CPU": 3.0}, version=14)
    assert gcs.get_node(nid).resources_available == {"CPU": 3.0}


def test_scheduling_with_delayed_heartbeats(tcp_cluster):
    """Chaos: one node syncs its resource view 5x slower than the
    default; a burst needing both nodes still completes, and the slow
    node is never declared dead."""
    tcp_cluster.add_node(num_cpus=2,
                         env={"RTPU_HEARTBEAT_PERIOD_MS": "5000"})
    _wait_for_nodes(2)

    @ray_tpu_torch.remote
    def work(i):
        time.sleep(0.05)
        return i

    # 3 waves: routing decisions against the stale view must not wedge
    for wave in range(3):
        got = ray_tpu_torch.get([work.remote(i) for i in range(12)],
                          timeout=90)
        assert sorted(got) == list(range(12))
    alive = [x for x in ray_tpu_torch.nodes() if x["alive"]]
    assert len(alive) == 2          # slow heartbeats != dead


def test_recursive_lineage_reconstruction_chain(tcp_cluster):
    """A depth-2 produce -> transform -> consume chain whose
    intermediate AND leaf objects die with their node is rebuilt by
    ``_maybe_reconstruct`` recursing through the lost creating-task
    args — and the claim gate admits exactly ONE reconstruction per
    object (counter-audited) despite multiple observers of the loss."""
    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    victim = tcp_cluster.add_node(num_cpus=2)
    _wait_for_nodes(2)
    affinity = NodeAffinitySchedulingStrategy(
        node_id=NodeID.from_hex(victim.node_id_hex), soft=True)

    @ray_tpu_torch.remote(max_retries=3, scheduling_strategy=affinity)
    def produce():
        return np.arange(60_000, dtype=np.float64)        # ~480 KB

    @ray_tpu_torch.remote(max_retries=3, scheduling_strategy=affinity)
    def transform(x):
        return x * 2.0

    a = produce.remote()
    b = transform.remote(a)
    # materialize BOTH links on the victim (sealed -> reconstructable)
    out = ray_tpu_torch.get(b, timeout=60)
    assert float(out[-1]) == (60_000 - 1) * 2.0

    tcp_cluster.remove_node(victim)          # hard SIGKILL: a AND b lost

    @ray_tpu_torch.remote
    def consume(x):
        return float(x.sum())

    want = float((np.arange(60_000, dtype=np.float64) * 2.0).sum())
    got = ray_tpu_torch.get(consume.remote(b), timeout=120)
    assert got == pytest.approx(want)
    # the whole chain was rebuilt exactly once per lost object: the
    # claim gate admitted one reconstruction of b AND one of a (the
    # recursion through the transform spec's lost arg)
    client = ray_tpu_torch._ctx.require_client()
    stats = client.state_query("reconstruct_stats") or {}
    a_hex = a.id.hex()
    b_hex = b.id.hex()
    assert stats.get(b_hex) == 1, stats
    assert stats.get(a_hex) == 1, stats
