"""Core tests of ray_tpu/tests aimed at ray_tpu_torch's runtime (copies of
test_core_basic.py, test_core_actors.py, test_refcount.py and
test_util.py's placement group test), and torch tensors through its object
store, on one module-scoped runtime."""

import gc
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
import torch_runtime_tasks as T
from ray_tpu_torch import exceptions

add = rt.remote(T.add)
echo = rt.remote(T.echo)
Counter = rt.remote(T.Counter)


@pytest.fixture(scope="module", autouse=True)
def runtime():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


def _wait_until(pred, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {msg}")


# --- test_core_basic.py -----------------------------------------------------

def test_put_get():
    assert rt.get(rt.put(42)) == 42


def test_put_get_large_numpy():
    arr = np.arange(1_000_000, dtype=np.float32)
    np.testing.assert_array_equal(rt.get(rt.put(arr)), arr)


def test_task_with_ref_args():
    a = rt.put(10)
    b = add.remote(a, 5)
    assert rt.get(add.remote(b, rt.put(1))) == 16


def test_multiple_returns():
    r1, r2, r3 = rt.remote(T.three).options(num_returns=3).remote()
    assert rt.get([r1, r2, r3]) == [1, 2, 3]


def test_task_error_propagates():
    with pytest.raises(exceptions.TaskError, match="kapow"):
        rt.get(rt.remote(T.boom).remote("kapow"))


def test_error_through_dependency():
    with pytest.raises(exceptions.RayTpuError):
        rt.get(echo.remote(rt.remote(T.boom).remote("root cause")),
               timeout=20)


def test_wait_and_timeouts():
    sleep = rt.remote(T.sleep_then)
    fast, slow = sleep.remote(0, "fast"), sleep.remote(5, "slow")
    ready, pending = rt.wait([fast, slow], num_returns=1, timeout=10)
    assert ready == [fast] and pending == [slow]
    t0 = time.time()
    ready, pending = rt.wait([slow], num_returns=1, timeout=0.5)
    assert time.time() - t0 < 5 and ready == [] and pending == [slow]
    with pytest.raises(exceptions.GetTimeoutError):
        rt.get(slow, timeout=0.5)
    assert rt.get(slow, timeout=30) == "slow"


def test_cluster_resources_without_a_card():
    """init() without num_gpus counts the CUDA devices: none here."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    assert rt.cluster_resources() == {"CPU": 4.0}
    assert len(rt.nodes()) == 1
    assert rt.get_runtime_context().get_accelerator_ids() == {"GPU": []}


def test_cancel_pending_task():
    # fill all 4 CPUs for long enough to cancel the queued task
    hogs = [rt.remote(T.sleep_then).remote(3, None) for _ in range(4)]
    victim = echo.remote("ran")
    time.sleep(0.5)
    rt.cancel(victim)
    with pytest.raises(exceptions.TaskCancelledError):
        rt.get(victim, timeout=15)
    assert rt.get(hogs, timeout=30) == [None] * 4


def test_object_spilling():
    store = rt._global_node.store
    capacity = store._capacity
    store._capacity = 4 * (1 << 20)  # 4MB budget
    try:
        refs = [rt.put(np.full(512 * 1024, i, dtype=np.uint8))
                for i in range(16)]  # 8MB total
        assert store.stats()["num_spilled"] > 0
        assert "/rtpt_session_" in store._spill_dir
        for i, r in enumerate(refs):
            arr = rt.get(r)
            assert arr[0] == i and len(arr) == 512 * 1024
    finally:
        store._capacity = capacity


def test_store_names_are_the_ports():
    node = rt._global_node
    assert "rtpt_session_" in rt._session_dir
    if node.store._arena is not None:
        assert "/rtpt_arena_" in node.store._arena.path
    ref = rt.put(np.ones(1 << 18))
    meta = node.store.get_meta(ref.id)
    assert meta.arena_ref is not None or meta.shm_name.startswith("rtpt")


# --- test_core_actors.py ----------------------------------------------------

def test_actor_state_and_ordering():
    c = Counter.remote()
    assert rt.get([c.incr.remote() for _ in range(20)]) == list(range(1, 21))
    assert rt.get(c.incr.remote(5)) == 25
    assert rt.get(Counter.remote(100).read.remote()) == 100


def test_named_actor():
    Counter.options(name="global_counter").remote(7)
    assert rt.get(rt.get_actor("global_counter").read.remote()) == 7
    with pytest.raises(ValueError):
        rt.get_actor("nope")


def test_kill_actor():
    c = Counter.remote()
    assert rt.get(c.incr.remote()) == 1
    rt.kill(c)
    with pytest.raises(exceptions.ActorError):
        rt.get(c.incr.remote(), timeout=20)


def test_actor_restart():
    p = Counter.options(max_restarts=1).remote()
    pid1 = rt.get(p.pid.remote())
    rt.kill(p, no_restart=False)
    # after restart, state resets and pid changes
    deadline = time.time() + 30
    pid2 = None
    while time.time() < deadline:
        try:
            pid2 = rt.get(p.pid.remote(), timeout=10)
            break
        except exceptions.RayTpuError:
            time.sleep(0.2)
    assert pid2 is not None and pid2 != pid1
    assert rt.get(p.incr.remote()) == 1


# --- test_refcount.py and test_util.py ---------------------------------------

def test_object_freed_when_last_ref_dies():
    node = rt._global_node
    ref = rt.put(np.zeros(100_000))      # large: lives in the store
    oid = ref.id
    assert node.store.contains(oid)
    del ref
    gc.collect()
    _wait_until(lambda: not node.store.contains(oid),
                msg="object freed after last ref died")
    _wait_until(lambda: node.gcs.lookup_location(oid) is None,
                msg="directory entry dropped after free")


def test_placement_group_pack_and_task():
    from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                    placement_group, remove_placement_group)

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    pg.ready(timeout=10)
    assert pg.is_ready() and pg.bundle_count == 2
    strategy = PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)
    assert rt.get(add.options(scheduling_strategy=strategy).remote(2, 3)) == 5
    remove_placement_group(pg)


# --- torch tensors through the store ------------------------------------------

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(4, 6, generator=g).bfloat16(),
        "i64": torch.arange(10, dtype=torch.int64),
        "strided": torch.randn(6, 8, generator=g)[:, ::2].t(),
        "scalar": torch.tensor(1.5),
        "grad": torch.randn(2, 3, generator=g).requires_grad_(),
        "nested": {"big": torch.randn(1 << 18, generator=g)},
    }


def _assert_same(got, want, scale=1):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_same(got[k], w, scale)
            continue
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.requires_grad == w.requires_grad, k
        assert torch.equal(g.detach(), w.detach() * scale), k


def test_tensors_put_get():
    want = _tensors()
    _assert_same(rt.get(rt.put(want)), want)


def test_tensors_as_task_args_and_returns():
    want = _tensors()
    double = rt.remote(T.tensor_tree_double)
    _assert_same(rt.get(double.remote(want)), want, scale=2)
    _assert_same(rt.get(double.remote(rt.put(want))), want, scale=2)
    got = rt.get(rt.remote(T.make_tensor).remote(8))
    assert torch.equal(got, torch.arange(8.0).reshape(2, -1).t())


def test_write_to_gotten_tensor_leaves_the_store_alone():
    ref = rt.put({"t": torch.arange(1 << 20, dtype=torch.float32)})
    first = rt.get(ref)["t"]
    first += 1
    assert torch.equal(rt.get(ref)["t"],
                       torch.arange(1 << 20, dtype=torch.float32))


# --- the port's own repairs -------------------------------------------------

def test_workers_run_torch_on_their_cpu_grant():
    """A task, or an actor from its creation on, runs torch on as many
    intra-op threads as it holds CPUs (at least one), as Ray sets
    OMP_NUM_THREADS from num_cpus; a pooled worker that has loaded torch
    is set anew for each task."""
    threads = rt.remote(T.torch_threads)
    for cpus, want in ((None, 1), (2, 2), (None, 1), (0.5, 1), (3, 3)):
        task = threads if cpus is None else threads.options(num_cpus=cpus)
        assert rt.get(task.remote()) == want, cpus
    actor_cls = rt.remote(T.TorchThreads)
    default, three = actor_cls.remote(), actor_cls.options(
        num_cpus=3).remote()
    assert rt.get(default.get.remote()) == 1
    assert rt.get(three.get.remote()) == 3
    rt.kill(default)
    rt.kill(three)


def test_large_result_leaves_no_resource_tracker_warning(tmp_path):
    """A driver that gets a 600 MB task result, and a task that gets a 600
    MB object the driver put (each over the arena's 512 MB limit, so a
    segment of its own), exit without the resource tracker's "leaked
    shared_memory objects" warning: an attachment registers nothing, and
    the node store's own segments stay registered as before. Before the
    repair the worker's attachment stayed registered after the node store
    unlinked the segment, and its tracker warned at exit."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import ray_tpu_torch as rt, torch_runtime_tasks as T\n"
        "n = 600 * 2**20\n"
        "rt.init(num_cpus=1)\n"
        "x = rt.get(rt.remote(T.zeros_u8).remote(n))\n"
        "assert x.nbytes == n and not x.any()\n"
        "ref = rt.put(T.zeros_u8(n))\n"
        "assert rt.get(rt.remote(T.nbytes_of).remote("
        "'ray_tpu_torch', [ref])) == n\n"
        "del x, ref\n"
        "rt.shutdown()\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "resource_tracker" not in proc.stderr, proc.stderr
    assert "leaked" not in proc.stderr, proc.stderr


def test_nested_arg_borrows_are_sent_before_the_body_runs():
    """A ref nested in a task's argument is a borrow of the worker from the
    moment it is unpickled; the worker sends it before the body runs, so
    the node knows what the running task holds (ray_tpu waits for the
    client's background flush)."""
    big = rt.put(np.zeros(300_000, dtype=np.uint8))

    @rt.remote
    def pending_edges(boxed):
        from ray_tpu_torch._private import context
        return len(context.current_client._edge_buf)

    assert rt.get(pending_edges.remote([big]), timeout=60) == 0


def test_fieldsan_new_object_starts_without_a_dead_ones_accesses():
    """fieldsan keys its access records by id(), and a new object can take
    a dead one's id: its construction must drop the records of that id (a
    standalone MetricsHistory written on the main thread was once reported
    racing a shut-down node's tick whose history had held the same id).
    Constructing again in place stands in for the new object at the id."""
    import threading

    from ray_tpu_torch._private import fieldsan, history

    before = len(fieldsan.violations())
    level = history._Level(1.0, 4)
    writer = threading.Thread(
        target=lambda: setattr(level, "last_ts", 1.0))
    writer.start()
    writer.join()
    level.__init__(1.0, 4)
    level.last_ts = 2.0
    assert len(fieldsan.violations()) == before
